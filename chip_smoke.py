#!/usr/bin/env python3
"""On-card smoke of the PyTorch/H100 port (``openviic_tpu_torch``).

    python3 chip_smoke.py          # on a machine with one NVIDIA H100
    python3 chip_smoke.py --cpu    # rehearsal at tiny widths on the CPU

On the card it runs these phases, each printing its seconds:

1. device: the card's name and power limit (``nvidia-smi``); exits non-zero
   when CUDA is unavailable;
2. build: nvcc over ``openviic_tpu_torch/csrc/*.cu`` (one process per
   source, all started together), the ptxas register/spill report, and at
   the flagship shape the occupancy of both layer-step kernels (CTAs per
   SM, cluster size, rows per tile, grid, registers, spills, shared
   memory) and of the head kernel's partial pass at k = 5, 16 and 128;
   the occupancy of both beam-select kernels and of the geo MMA kernel
   (with its slabs per phase and persistent grid); the counts of wgmma,
   mma.sync, TMA and local-memory instructions in the head, layer-step,
   beam-select and geo kernels' machine code (``cuobjdump -sass``; the geo
   MMA kernels must hold mma.sync);
3. head kernel: the ``head_topk`` CUDA kernel against its plain PyTorch
   version at the flagship decode shape (N = 320 x 5 beams = 1600 rows,
   D = 512, V = 10 000, k = 5), at the first step's 320 rows, at a ragged
   shape (N = 37, V = 7 094 and 277) and in a constructed tie case, then
   its device time (a CUDA graph) beside its bound, the plain version's and
   matmul + logsumexp + topk's, and its cost launched from Python; k = 32
   and k = 128 (the shared-memory lists) at 1600 and 320 rows against the
   plain version, with their device times; the head-kernel gate
   sweep: one beam-resident selection step through the kernel and through
   fast select from one image to 3200 rows at beams 1, 3, 5, 8 and 16,
   with the crossover (``_head_kernel_wins`` holds what it gave);
4. serve: the flagship captioner (StandardTransformerUsingRegion, d_model
   512, 8 heads, 3+3 layers, d_ff 2048, 50 x 1024-d region features, vocab
   10 000, max_len 25, random weights from a seed) built through the port's
   ``build_model`` and served through ``CaptioningPipeline.caption_features``
   at beam 5, batch 320, bf16, head kernel forced (``head_kernel=1``):
   three requests (320, 320 and 7 images).  The kernel's launch count must
   equal the decode steps, every id must lie in the vocab, and the captions
   must agree with the fast-select path on >= 95% of the images; it prints
   what the auto gate (``head_kernel=True``) resolves to there;
5. kernels vs plain: ``beam_select_attention`` (both mask axes) at a
   mid-decode step, at t = 0 and t = L - 1, with q sliced from a fused qkv
   projection, at a ragged shape (35 rows) with a fully masked row, at
   L = 40 and at the general kernel's shape (4 heads of 100), timed at
   t = 0, L // 2 and L - 1; ``resident_layer_step`` and ``fused_layer_step``
   (rows other than t bit-unchanged) at a mid-decode step and a ragged
   shape (35 rows), at N = 1600 with t = 0 and t = L - 1, and at 37 images,
   whose 185 rows leave the last cluster tile short, with the flagship's
   layer-0 weights;
   ``fused_attention`` at the encoder, the non-resident step's self- and
   cross-attention, the ORT's full-bias and a ragged f32 shape with a fully
   masked row, and at its tiles' edges (nq = 1 with nk = 1, 200 and 300,
   nq = 65, bf16 q/k/v 2 bytes off 16-byte alignment), the edge cases also
   through the tile their nq does not choose (within 2e-5; the masked row
   finite and uniform); ``geo_fused_attention`` at the ORT encoder shape,
   a ragged one, n = 72 (the MMA kernel past 64 rows), bf16 boxes and
   n = 160 (the SIMT kernel) (2 bf16 ulps on 99% of the elements, 0.05
   everywhere);
   then each one's time beside its bound, its plain version's and a PyTorch
   yardstick's (the gather + SDPA composite, the eager
   ``DecoderLayer.step``, SDPA, or box embedding + fc_gs + SDPA); every
   kernel's time is a device time (a CUDA graph of the calls), and so are
   the plain versions' and the yardsticks', fused_attention's at the
   encoder and both step shapes with the DECODE/MMA crossover over nq;
   beside them each launch's cost from
   Python (CUDA events and the host's clock, without a graph);
6. decode paths at the serve shape over the same requests: (a)
   ``TRAINING.DECODE_ATTN_KERNEL`` in the pipeline, (b) ``resident_kernel``,
   (c) ``beam_resident=False`` with ``OPENVIIC_FUSED_STEP=1`` and without;
   each asserts its kernels' launches per step, valid ids and a mean
   best-beam log-prob within 0.5% of its reference path's, and prints its
   captions/s and caption agreement; path (a)'s own beam-select inputs at
   t = L // 2 (layer 0), captured while it serves a request, against the
   plain version, timed beside the kernel's mean time per launch over a
   request of path (a) under torch.profiler;
7. forced decode: the served captions fed back through each kernel path
   and the eager step, per-step log-probs compared;
8. attention paths: (d) ``OPENVIIC_PALLAS=1`` on the served path (the
   encoder), (e) the same with ``beam_resident=False`` (the decoder's
   attention too), (f) the Object Relation Transformer
   (``configs/object_relation_transformer.yaml`` at full width, beam 3) with
   the trig embedding off, with and without ``OPENVIIC_PALLAS=1``, (g) with
   it on, with and without ``OPENVIIC_GEO_FUSED=1``; launches per request
   and step, valid ids and score parity with each flag-off twin, then the
   forced decode of (d), (e) and (g) against their twins ((g) with the
   pipeline's f32 boxes and with the bf16 boxes the beam search casts);
9. serving cell: the flagship (random weights from a seed) written with
   the port's ``save_checkpoint`` and a ``vocab.bin`` into a temporary
   directory and loaded by ``CaptioningPipeline(config, checkpoint_dir=...)``
   (bf16, beam 3, batch 32, head kernel forced, beam-select attention
   kernel on); a ``CaptionServer`` on 127.0.0.1 (max_batch 32, max_wait_ms
   25) takes 256 ``/caption_features`` requests (``.npz`` of 50 regions)
   from 32 client threads, 8 each, then the same requests go straight into
   its batcher: every reply must equal the pipeline's ``caption_features``
   of its image, head_topk must launch once a decode step and
   beam_select_attention once a layer and step in each run, and both
   kernels are held against their plain versions on their inputs captured
   from one served batch at t = 0, 12 and the last step; a pickled and a
   malformed body and ``/caption`` without Pillow get a 400 (the last
   naming Pillow), ``/healthz`` counts every request; prints requests/s
   over HTTP and into the batcher, p50 and p99 latency and the mean batch
   fill; then ``caption_images`` on 8 seeded 480 x 640 x 3 uint8 arrays:
   the patch backbone (dim 1024, grid 7) and ``roi_pool`` on the card
   against the same functions on its host's CPU (thumbnails equal,
   features within 1e-4, roi_pool within 1e-5), the captions, and whether
   Pillow is present;
10. trained artifact: the committed trained flagship
   (``saved_models/realistic_d512_bench/``, vocab 7 094, max_len 30, its
   150 test images of up to 40 regions) through ``CaptioningPipeline``
   at beam 5: at f32 on the card and on its host's CPU (>= 99% identical
   captions, CIDEr within 0.002), then at bf16 through eager fast select,
   the head kernel and paths (a)-(e), each with its launches, CIDEr,
   agreement with eager bf16 (>= 99% for the head kernel against fast
   select, >= 95% for (a), >= 80% for (b)-(e), against their eager twins:
   the JAX package's own such paths miss 95% too) and captions/s; each of
   kernels 1-5 against its plain version on its own inputs captured from
   that decode at t = 0, 12 and 29, timed beside its bound; then its 150
   images written as ``<id>.npy`` beside a port checkpoint of its weights
   and its ``vocab.bin``, captioned by ``caption_directory`` at batch 32,
   beam 5: at f32 >= 99% of the captions equal to the f32 card decode
   above and CIDEr within 0.002; at bf16 through the head kernel its CIDEr
   and captions/s, the background loading of the files included;
11. XE training from the artifact's weights at batch 60 of its test
   captions: one f32 step on the card against its host's CPU, the
   multi-step call against single steps, grad_accum 2 against the full
   batch, 20 bf16 steps whose loss must fall (ms per step, peak memory),
   and the refusal of a step under ``OPENVIIC_PALLAS=1``;
12. SCST from the artifact's weights at batch 60 x beam 5 (its test
   references also serve as the df corpus): the f32 step on the card
   against its host's CPU on fixed beams, the device reward against the
   host's (Python and native CIDEr), the native scorers against the Python
   ones on the card's host, 20 iterations of ``scst_iteration`` as the
   tuned config runs them (bf16 sampling through the head kernel, device
   reward, f32 step; ms split into sample, reward and step, the step's
   peak memory, head_topk launches per decode step), and dropout-active
   sampling (seeded, and the resident step kernel bypassed);
13. the trainer: ``BaseTrainer`` on the artifact's 150 images written as
   a dataset (90 / 30 / 30 train, dev, test by id) with its vocab and
   weights, the tuned config's TRAINING keys and PATIENCE 0: a run of 3
   epochs (XE, the switch, SCST) and its test predictions, with each
   epoch's seconds, the checkpoint's size and seconds, the launches of
   head_topk (one a decode step) and beam_select_attention (one a layer
   and step), the bf16 guard; a mid-SCST checkpoint into a fresh
   trainer; a run resumed after its first epoch equal to the first run
   bit for bit under deterministic algorithms (in a child process whose
   CUDA starts with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``), and a second
   pair at LOG_EVERY 1, resumed mid-SCST, whose metrics rows match too;
   head_topk and beam_select_attention on their inputs from the first
   val decode, the first test prediction and the second SCST iteration,
   against their plain versions;
14. region families: AoA, augmented memory, Meshed-Memory and CAMO
   (``configs/attention_on_attention.yaml``, ``augmented_memory_transformer``,
   ``meshed_memory_transformer``, ``camo_transformer``: d_model 512, 8
   heads (CAMO's encoder: 1), 3+3 layers, d_ff 2048, 40 memory slots,
   random weights from a seed, beam 3, bf16), each serving one request of
   320 images of 50 regions through ``CaptioningPipeline``: the tuned path
   (head kernel forced, beam-select kernel on) against eager fast select;
   ``resident_kernel`` and ``OPENVIIC_FUSED_STEP=1`` (one launch a layer
   and step on augmented memory and CAMO, none on AoA, whose gate the
   kernels bypass; on M² ``resident_kernel`` raises, as the JAX package
   fails there); ``OPENVIIC_PALLAS=1`` (fused_attention once an encoder
   layer, CAMO's two cross-layer calls besides); launches, valid ids,
   score parity, captions/s and forced decodes for each; head_topk,
   beam_select_attention, fused_attention (96 keys with the slots; one
   head) and CAMO's resident_layer_step on their captured inputs against
   their plain versions, timed beside their bounds; f32 decodes of 16
   images on the card against its host's CPU (>= 99% identical); 10 bf16
   XE steps at batch 60 whose loss must fall, ms per step, peak memory;
15. two-stream families: DLCT (``configs/dlct_fixed.yaml``: 50 regions of
   1024-d features with boxes and a 7 x 7 grid of 2048-d features, both
   bucket-padded to 56 rows, so the decoder's memory is 112 rows; 3
   encoder levels, 3+3 layers, beam 3, bf16) through the tuned path,
   eager fast select, ``resident_kernel``, the non-resident path with and
   without ``OPENVIIC_FUSED_STEP=1`` and ``OPENVIIC_PALLAS=1`` (12
   fused_attention launches a request), with launches, score parity,
   captions/s and forced decodes; the kernels on its captured inputs
   (fused_attention on the unpadded region-to-all call, 50 queries
   against 99 keys), the MMA tile at its cross shapes, both layer steps
   at M = 99, 112 and 200; f32 card against CPU on 16 images; 10 bf16 XE
   steps; ``UnifiedTransformer`` at d_model 512 on its 4-wide streams;
16. RSTNet (``configs/rstnet_fixed.yaml``: the flagship's encoder, 3
   decoder layers and the adaptive one, the frozen PhoBERT-architecture
   language model of hidden 768, 4 layers of 8 heads, over 64 001 ids,
   about 115 M parameters; random weights from a seed; beam 3, bf16), one
   request of 320 images of 50 regions through ``CaptioningPipeline``,
   which builds the (10 000, 512) signal table once from the f32 weights:
   the table's build time and every row against the language model run on
   its id (f32, 1e-5); the table path against the per-step language model
   (ids identical at f32 on 16 images, score parity at bf16, captions/s
   each); ``resident_kernel`` with ``head_kernel=1``, ``attn_kernel`` and
   ``OPENVIIC_FUSED_STEP=1``: no launch of any kernel and the eager path's
   ids; ``OPENVIIC_PALLAS=1`` with the table and without (fused_attention
   once an encoder layer, twice a standard layer and step, once a table
   build, once more a step for the per-step language model), score parity
   and the forced decode against the flag-off twin; fused_attention on the
   table's 1 x 1 call (the <pad> row fully masked) and a standard layer's
   step cross call against its plain version, timed beside its bound and
   SDPA's; f32 card against CPU on 16 images; 10 bf16 XE steps (the
   backbone bit-unchanged, out of Adam's state); SCST iterations with the
   table rebuilt each one (ms for table, sample, reward, step) and one
   sampled with dropout through the per-step language model; a
   ``BaseTrainer`` run through XE, the switch and SCST on phase 13's
   artifact images with its split checkpoint (``frozen_params.ckpt``
   written once, the per-epoch file's MiB beside an unsplit save's) and
   ``CaptioningPipeline(checkpoint_dir=...)`` captioning from the split
   files;
17. the single-card remainder: the flagship with a 4-expert Switch MoE as
   every encoder and decoder FFN (capacity factor 1.25) and
   ``LSTMTextEmbedding`` (D_EMBEDDING 512) as the decoder's word
   embedding, random weights from a seed, beam 3, bf16, one request of 320
   images through ``CaptioningPipeline``: the tuned path (head kernel
   forced, beam-select kernel on) against eager fast select (launches per
   step, ids in the vocab, score parity, captions/s) and the forced decode
   of its captions through the attention kernel; ``OPENVIIC_PALLAS=1``
   (fused_attention once an encoder layer), with its score parity and
   forced decode; ``resident_kernel`` and ``OPENVIIC_FUSED_STEP=1`` raise
   the MoE ``ValueError`` (the JAX package fails there) with no launch;
   head_topk, beam_select_attention and fused_attention on their inputs
   captured from these decodes against their plain versions, timed beside
   their bounds; f32 on the card against its host's CPU on 16 images
   (>= 99% identical); 10 bf16 XE steps whose loss must fall (ms per
   step, peak memory, the MoE layers' aux losses); ``return_probs`` on 7
   images (the best beam's word log-probs found in the kept
   distributions); ``beam_search_multi`` over the 320 and the 7 images
   (tokens equal to ``beam_search`` of each); the RDR segmenter on the
   card's host from whichever library loads (lexicon, rules and an SCRDR
   tree written by the phase; fixed expected segmentations); a synthetic
   original-code run of the flagship at full width (its ``state_dict``
   under the original names and a torch Adam state) through
   ``import_reference_checkpoint`` into a temporary directory and
   captioned from there: captions equal to the same weights loaded
   directly;
18. data parallel across processes (``data_parallel_phase``): (a)
   ``openviic_tpu_torch/parallel/dryrun.py`` at the flagship's widths
   (random weights from a seed, f32, dropout 0, Adam with the Noam
   schedule) over a global batch of 60 for 6 steps: two ranks on the card
   over gloo (losses within 1e-5 of one process on the same global
   batches, parameters bit-equal across ranks, the rank-0 checkpoint of
   step 3 resumed bit-identically on every rank), then one rank over NCCL
   on the dry run's default device (``cuda:<LOCAL_RANK>``) in this
   process, its losses and parameters bit-equal to one process;
   each run's ms a step and the gradient all-reduce's ms and MiB a step;
   (b) ``BaseTrainer`` across two rank processes on the card over gloo
   (NCCL refuses two ranks on one device) on phase 13's data, weights and
   TRAINING keys with ``DATASET.LOADER: grain``, MAX_REGIONS 40 and 30
   captions a rank a step (SCST: 15 images a rank an iteration, 3
   iterations an epoch): XE, the switch, one SCST epoch and the test
   predictions; every rank exits 0 in time, the ranks take the same
   decisions on scores that agree with rank 0's, head_topk launches once a
   decode step and beam_select_attention once a layer and step in each
   rank, rank 0 alone writes the checkpoints, ``metrics.jsonl`` and
   ``test_results.json``, and both kernels are held against their plain
   versions on rank 0's inputs captured from its first val decode, first
   test prediction and second SCST iteration; each rank's epoch seconds;
   (c) ``CaptioningPipeline(mesh="auto")`` (bf16, head kernel forced,
   attention kernel on; its launches) and ``mesh=[the card, the card]``
   at f32 each give captions bit-equal to the pipeline without a mesh;
19. model parallel across processes (``model_parallel_phase``):
   ``openviic_tpu_torch/parallel/layouts_dryrun.py`` at the flagship's
   widths (random weights from a seed, f32 unless said), four gloo ranks on
   the card (NCCL refuses two ranks on one device), each case against one
   process on the card: (a) XE at a global batch of 60 for 6 steps over
   {data 2, model 2} under SGD (losses within 1e-5, parameters within
   2e-4 / 1e-5) and {model 2} under Adam (losses; each rank's sharded
   parameters and moments half of one process's bytes); (b) the {model 2}
   decode of 64 images at beam 3: f32 tokens equal, bf16 with
   ``head_kernel=1`` (head_topk once a step in each rank on its 5 000-id
   shard) with the mean best-beam log-prob within 0.5% and, teacher-forced
   along its captions, each token's log-prob within 0.25 of one process's
   on 99% of the tokens (the captions' agreement printed beside that of
   one process with its encoder attention rounded otherwise); (c) the
   {model 2} encoder under
   ``OPENVIIC_PALLAS=1`` (fused_attention once a layer on each rank's 4
   heads); (d) the flagship encoder under the ring and under Ulysses, the
   ORT's (trig embedding off) under the ring, at {data 2, seq 2} (25 of
   the 50 positions a rank): forward within 2e-5, gradients within 1e-4 of
   their scale, one call a layer; (e) the encoder pipelined at {pipe 3} on
   ranks 0-2 with 4 microbatches: forward within 1e-5, gradients within
   2e-4 / 1e-4, and under ``OPENVIIC_PALLAS=1`` fused_attention once a
   microbatch a stage; (f) phase 17's 4-expert MoE encoder at {expert 4}:
   forward within 1e-5, gradients within 2e-4 / 1e-4; ms a step, a decode
   or a forward, bytes per axis, the ops staged through the host; then
   head_topk on rank 0's shard at decode steps 0, 12 and 24 and
   fused_attention on rank 0's first tensor-parallel and pipeline-stage
   calls against their plain versions, timed beside their bounds; (g) one
   NCCL rank in this process, every axis of size 1, bit-equal to no group;
20. the trainer's backends (``backends_phase``): (a) in phase 13's child
   process, phase 13's trainer with ``CHECKPOINT_BACKEND: orbax`` (the
   DCP backend): XE, the switch and one SCST epoch, head_topk once a
   decode step and beam_select_attention once a layer and step, the
   seconds each save blocks the loop beside phase 13's native saves and
   ``last_model.orbax``'s MiB; a second run resumed from
   ``last_model.orbax`` after one epoch, equal bit for bit under
   deterministic algorithms; ``CaptioningPipeline`` from
   ``best_model.orbax`` (bf16, head kernel forced, attention kernel on)
   with the captions and ids of the native checkpoint of the same weights
   (``orbax_trainer_part``); (b) the flagship at full width with
   ``UsualEmbedding`` over a seeded 300-d vector file of the vocab's words
   (read as text, then from its ``.npz``), one request of 320 images at
   beam 5, bf16: the tuned path, ``resident_kernel`` and
   ``OPENVIIC_FUSED_STEP=1``, each against eager fast select (launches per
   step, valid ids, score parity); head_topk and resident_layer_step on
   their captured inputs against their plain versions; f32 on the card
   against its host's CPU on 16 images; a pipeline from a checkpoint and a
   ``vocab.bin`` carrying the vectors with equal captions
   (``vectors_part``); (c) two child processes with
   ``OPENVIIC_COMPILE_CACHE`` set: the first, started beside phase 2's
   build, compiles every kernel there, the second, once the first has
   ended, starts no nvcc and loads them (``cache_part``); (d) the
   launcher (``parallel.launch.spawn``) on [the card, the card] over gloo:
   one XE epoch of phase 13's data at a global batch of 60, losses within
   1e-5 of one process, then one SCST epoch of 43-image batches (the two
   odd ones whole on both ranks), each batch's mean reward within 1e-5 of
   one process's; parameters bit-equal across the ranks, rank 0 alone
   writing the checkpoint (``local_parallel_part``);
21. tensor parallelism on every family (``tensor_parallel_families_phase``):
   ``parallel/layouts_dryrun.py --family all`` at the yamls' full widths
   (random weights from a seed), four gloo ranks on the card, the families
   alternating between two {model 2} meshes (ranks 0-1 and 2-3), each case
   against one process on the card: every family (the flagship, AoA, the
   augmented memory, M², CAMO with its one-head encoder attention gathered
   to the whole head, the ORT with the trig embedding off and on, DLCT,
   RSTNet through its signal table built on each rank, and phase 17's MoE
   and ``LSTMTextEmbedding`` flagship): one f32 XE step at a batch of 16
   (loss within 1e-5), the f32 eager decode of 16 images (tokens equal),
   the bf16 tuned decode of 64 images at beam 3 (head_topk on each rank's
   vocab shard, beam_select_attention on its 4 heads, the fast kernel; the
   mean best-beam log-prob within 0.5% and, teacher-forced along its
   captions, each token's log-prob within 0.25 of one process's on 99% of
   the tokens); the flagship's path (b) (``resident_layer_step`` on every
   rank from the layers' weights gathered whole, whose gather is timed
   once) and path (c) with ``OPENVIIC_FUSED_STEP=1`` at {model 2} and path
   (a) at {model 4} (2 heads a rank: the general beam-select kernel); the
   ORT trig-on under ``OPENVIIC_GEO_FUSED=1`` (the geometry kernel on the
   rank's heads of ``fc_gs``): each within 0.5% of one process's score on
   the same path and every kernel launched once a layer and step (geo: a
   layer and request) on every rank; then those four kernels on rank 0's
   inputs captured at step 12 (geo: its first call) against their plain
   versions, timed beside their bounds;
22. the last line: ``{"ok": true, "device": {...}}``.

The line before the last is a JSON object with one entry per kernel (six:
its launches on its decode path, error, times and bound, and its launches
and cases in the families, two-stream, RSTNet, remainder, data-parallel,
model-parallel (phases 19 and 21) and backends phases, 0 where a kernel
does not run); the line before that is the card's name and power limit.  Any failure raises,
and the script exits non-zero without those lines.  ``--cpu`` runs phases
3-20 at tiny
widths with the plain versions on the CPU (the artifact's first image;
the serving cell at batch 8, 8 requests from 2 clients; XE,
SCST and the trainer at tiny widths; the families, RSTNet and the
remainder on 2 images and 6 steps, RSTNet's trainer on 4 images whose
references are cut to 6 words; of phase 18 the dry run's one rank over gloo
in this process, bit-equal to no group, and serving over ``["cpu",
"cpu"]``; of phase 19 its check (g) over gloo; phase 20's (a) and (b) at
tiny widths, (c) as the build directory moved and given back in this
process, (d) as one host-local gloo rank in this process; phase 21 is
left to the CPU tests) and ends with
``cpu rehearsal ok`` instead.  The script writes nothing outside
``openviic_tpu_torch/_build/`` but the serving, trainer, RDR, import,
data-parallel, model-parallel and backends phases' temporary directories,
which it deletes.
"""

from __future__ import annotations

import sys

sys.dont_write_bytecode = True  # write nothing into the checkout but _build/

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (dense, no sparsity) for the bound column.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
# transcendentals (sin, cos, exp, log) at the special-function rate: 16
# MUFU results per SM per clock, 132 SMs, the 1.98 GHz boost clock
PEAK_SFU_OPS = 132 * 16 * 1.98e9

# lm_hidden, lm_vocab: RSTNet's language model (its HIDDEN_SIZE, VOCAB_SIZE)
FLAGSHIP = dict(d_model=512, heads=8, layers=3, d_ff=2048, d_feature=1024,
                n_regions=50, vocab=10_000, max_len=25, beam=5, batch=320, ort_beam=3,
                lm_hidden=768, lm_vocab=64_001)
TINY = dict(d_model=32, heads=2, layers=2, d_ff=64, d_feature=24,
            n_regions=7, vocab=300, max_len=12, beam=5, batch=8, ort_beam=3,
            lm_hidden=32, lm_vocab=320)
AGREEMENT_MIN = 0.95
LSE_ATOL = 1e-3
# the unit roundoff of an f32 sum that truncates (a tensor core's may):
# D products summed in any order stay within D * this of the exact sum,
# relative to the sum of their magnitudes
F32_TRUNC_U = 2.0 ** -23
ULP_FLOOR = 1 / 16  # bf16 ulps are counted at magnitudes of at least this
# resident_layer_step's y against its plain version: both round the same
# intermediates through bf16 (products' operands, q.k products, softmax
# weights); an f32 sum taken in another order can flip one such rounding,
# which moves y by a few ulps at most
RESIDENT_Y_ULPS = 4
RESIDENT_Y_SHARE = 0.01
# a decode path's mean best-beam log-prob against its reference path's
SCORE_RTOL = 0.005
# a forced token's per-step log-prob through a kernel path against the
# eager step's: two bf16 ulps of a logit in [16, 32), as the head's bf16
# logits round at 0.125 there
FORCED_ATOL = 0.25
FORCED_SHARE = 0.99


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(name: str, fn):
    t0 = time.perf_counter()
    out = fn()
    log(f"phase {name}: {time.perf_counter() - t0:.3f} s")
    return out


def model_config(s, attn_kernel: bool = False):
    from openviic_tpu_torch.config import ConfigNode

    def attn():
        return {
            "ARCHITECTURE": "ScaledDotProductAttention", "HEAD": s["heads"],
            "D_MODEL": s["d_model"], "D_KEY": s["d_model"] // s["heads"],
            "D_VALUE": s["d_model"] // s["heads"], "D_FF": s["d_ff"],
            "D_FEATURE": s["d_ff"], "MEMORY": 40, "USE_AOA": False,
            "CAN_BE_STATEFUL": False, "DROPOUT": 0.1,
        }

    model = {
        "ARCHITECTURE": "StandardTransformerUsingRegion",
        "VISION_EMBEDDING": {"ARCHITECTURE": "FeatureEmbedding",
                             "D_FEATURE": s["d_feature"], "D_MODEL": s["d_model"],
                             "DROPOUT": 0.1},
        "ENCODER": {"ARCHITECTURE": "Encoder", "D_MODEL": s["d_model"],
                    "LAYERS": s["layers"], "SELF_ATTENTION": attn()},
        "DECODER": {
            "ARCHITECTURE": "Decoder", "D_MODEL": s["d_model"], "LAYERS": s["layers"],
            "ATTENTION": {"D_MODEL": s["d_model"], "SELF_ATTENTION": attn(),
                          "ENC_ATTENTION": attn()},
            "TEXT_EMBEDDING": {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": s["d_model"],
                               "D_EMBEDDING": 300, "WORD_EMBEDDING": None,
                               "WORD_EMBEDDING_CACHE": None, "DROPOUT": 0.1},
        },
    }
    # an int forces the head kernel (True is the measured auto gate): the
    # paths below hold it to one launch per decode step
    training = {"EVALUATING_BEAM_SIZE": s["beam"], "DECODE_HEAD_KERNEL": 1,
                "DECODE_ATTN_KERNEL": attn_kernel}
    return ConfigNode({"MODEL": model, "TRAINING": training})


def make_vocab(s):
    from openviic_tpu_torch.data import Vocab

    specials = ["<pad>", "<bos>", "<eos>", "<unk>"]
    return Vocab(specials + [f"w{i}" for i in range(s["vocab"] - 4)], s["max_len"])


# ---------------------------------------------------------------- phase 3
def exact_inputs(gen, n, d, v, device):
    """bf16 inputs whose products and f32 sums are exact (multiples of
    1/512 below 2^15 in magnitude), so every summation order gives the same
    logits and ids must match exactly."""
    x = torch.randint(-8, 9, (n, d), generator=gen).float() / 8
    w = torch.randint(-8, 9, (v, d), generator=gen).float() / 64
    return x.to(device, torch.bfloat16), w.to(device, torch.bfloat16)


def gaussian_inputs(gen, n, d, v, device):
    """Decode-like inputs: a layer-normed hidden state and the head's init."""
    x = torch.randn((n, d), generator=gen)
    w = (torch.rand((v, d), generator=gen) * 2 - 1) / d ** 0.5
    return x.to(device, torch.bfloat16), w.to(device, torch.bfloat16)


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    _, exponent = torch.frexp(v)
    return torch.ldexp(torch.ones_like(v), exponent - 8)


def lse_bracket(x, w):
    """Per row, the least and the greatest logsumexp of logits that are the
    bf16 rounding of an f32 sum of the exact products x_j w_ij, in any
    order: each exact dot product (float64) moved by the f32 bound D *
    F32_TRUNC_U * sum_j |x_j w_ij| down and up, rounded to bf16 (rounding
    is monotone, and so is logsumexp in each logit).  A logit whose exact
    value lies that close to a rounding boundary may come out one bf16 ulp
    apart in two correct kernels; every other logit is pinned.  Also
    returns the logsumexp of the exact logits rounded to bf16."""
    xd, wd = x.double(), w.double()
    exact = xd @ wd.T
    reach = x.shape[1] * F32_TRUNC_U * (xd.abs() @ wd.abs().T)
    lo = torch.logsumexp((exact - reach).to(torch.bfloat16).double(), dim=1)
    hi = torch.logsumexp((exact + reach).to(torch.bfloat16).double(), dim=1)
    return lo, hi, torch.logsumexp(exact.to(torch.bfloat16).double(), dim=1)


def compare(name, x, w, k, exact: bool):
    """Kernel (wrapper) against the plain version on the same inputs.
    Returns the largest absolute error over values and lse."""
    from openviic_tpu_torch.ops.head_topk import head_topk, head_topk_reference

    vals, idxs, lse = head_topk(x, w, k)
    rv, ri, rl = head_topk_reference(x, w, k + 1)
    if x.is_cuda:
        torch.cuda.synchronize()
    if vals.shape != (x.shape[0], k) or idxs.shape != vals.shape or lse.shape != (x.shape[0],):
        raise AssertionError(f"{name}: output shapes {vals.shape}, {idxs.shape}, {lse.shape}")
    if not (torch.isfinite(vals).all() and torch.isfinite(lse).all()):
        raise AssertionError(f"{name}: non-finite output")
    val_err = (vals - rv[:, :k]).abs()
    if (val_err > bf16_ulp(rv[:, :k])).any():
        raise AssertionError(f"{name}: values differ by more than 1 bf16 ulp "
                             f"(max {val_err.max().item()})")
    lse_err = (lse - rl).abs().max().item()
    lo, hi, lse_exact = lse_bracket(x, w)
    outside = torch.clamp(torch.maximum(lo - lse.double(), lse.double() - hi), min=0.0)
    if outside.max().item() > LSE_ATOL:
        raise AssertionError(f"{name}: lse {outside.max().item():.3g} outside what f32 sums of the "
                             f"exact products give (> {LSE_ATOL}); against the plain version "
                             f"{lse_err:.3g}")
    same = (idxs == ri[:, :k]).all(dim=1)
    if exact:
        excluded = torch.zeros_like(same)
    else:
        # a gap of at most one ulp among the top k+1 is a near-tie that two
        # summation orders may round either way
        gaps = rv[:, :-1] - rv[:, 1:]
        excluded = (gaps <= bf16_ulp(rv[:, :-1])).any(dim=1)
    bad = int((~same & ~excluded).sum())
    if bad:
        raise AssertionError(f"{name}: ids differ on {bad} rows")
    err = max(val_err.max().item(), lse_err)
    wide = int(((hi - lo) > LSE_ATOL).sum())
    log(f"  {name}: N={x.shape[0]} D={x.shape[1]} V={w.shape[0]} k={k}: ids equal"
        f"{'' if exact else f' on {int((~excluded).sum())} rows without a 1-ulp near-tie ({int(excluded.sum())} near-tie rows, {int((~same).sum())} of them differ)'}"
        f", max |dval| {val_err.max().item():.3g}, max |dlse| {lse_err:.3g} against the plain "
        f"version; against the exact logits rounded to bf16: kernel "
        f"{(lse.double() - lse_exact).abs().max().item():.3g}, plain "
        f"{(rl.double() - lse_exact).abs().max().item():.3g}; lse within {LSE_ATOL} of the "
        f"exact range on every row ({wide} rows where a bf16 rounding boundary lies within f32 "
        f"reach widen it past {LSE_ATOL})")
    return err, (vals, idxs, lse)


def tie_case(gen, device, k):
    """Duplicated head rows give exactly equal logits; the lower id must come
    first, in the kernel as in the plain version."""
    from openviic_tpu_torch.ops.head_topk import head_topk_reference

    x, w = exact_inputs(gen, 64, 512, FLAGSHIP["vocab"], device)
    V = w.shape[0]
    top = head_topk_reference(x, w, 1)[1][:, 0].long().unique()
    for orig in top.tolist():
        w[(orig + V // 2) % V] = w[orig]  # the copy lands above or below
    _, (vals, idxs, _) = compare("tie case", x, w, k, exact=True)
    tied = vals[:, 0] == vals[:, 1]
    if int(tied.sum()) == 0 or not (idxs[tied, 0] < idxs[tied, 1]).all():
        raise AssertionError("tie case: no tie, or a tie not resolved to the lower id")
    log(f"  tie case: {int(tied.sum())} rows with a tied top-2, all resolved to the lower id")


def time_cuda(fn, iters: int, graph: bool = False) -> float:
    """ms per call of ``fn`` over ``iters`` calls, between CUDA events.  With
    ``graph`` the calls are captured once into a CUDA graph and replayed, so
    the time is the device's alone, without the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(iters)]  # noqa: E731
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            run()
        captured.replay()
        run = captured.replay
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_costs(fn, iters: int) -> dict:
    """What ``fn`` costs launched from Python, one call after another: ms
    per call between CUDA events (``launch_ms``; the device's time, or the
    host's where the host is slower) and ms of the host's clock per call
    until the last one returns (``host_ms``: the wrapper's own cost, its
    checks, ctypes call and launch)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dict(launch_ms=start.elapsed_time(end) / iters, host_ms=host * 1e3 / iters)


def head_bound(N, D, V, k):
    """The head kernel's bound: its bf16 products at the tensor-core peak
    against x and w read once and the outputs written once."""
    flops = 2.0 * N * D * V
    bytes_moved = (N * D + V * D) * 2 + N * k * (4 + 4) + N * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, bytes_moved / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops, bytes_moved


def kernel_phase(device, s):
    """head_topk against its plain version at the decode rows (N = batch x
    beam) and the first step's (N = batch), a ragged shape at two vocab
    sizes and the tie case; then device times (CUDA graphs) of the kernel,
    its plain version and matmul + logsumexp + topk, and the kernel's host
    cost per call launched from Python."""
    from openviic_tpu_torch.ops.head_topk import head_topk, head_topk_reference

    gen = torch.Generator().manual_seed(0)
    N, D, V, k = s["batch"] * s["beam"], s["d_model"], s["vocab"], s["beam"]
    compare("main shape, exact inputs", *exact_inputs(gen, N, D, V, device), k, exact=True)
    x, w = gaussian_inputs(gen, N, D, V, device)
    err, _ = compare("main shape, gaussian inputs", x, w, k, exact=False)
    x0, w0 = gaussian_inputs(gen, s["batch"], D, V, device)
    err = max(err, compare("first step's rows, gaussian inputs", x0, w0, k, exact=False)[0])
    for ragged_v in ((7094, 277) if s is FLAGSHIP else (277,)):
        compare("ragged shape", *exact_inputs(gen, 37, D, ragged_v, device), k, exact=True)
    if s is FLAGSHIP:
        tie_case(gen, device, k)
    if device.type != "cuda":
        return None

    def library():
        logits = x @ w.T
        return torch.logsumexp(logits.float(), dim=1), torch.topk(logits, k, dim=1)

    ms = time_cuda(lambda: head_topk(x, w, k), 50, graph=True)
    plain_ms = time_cuda(lambda: head_topk_reference(x, w, k), 10, graph=True)
    library_ms = time_cuda(library, 50, graph=True)
    costs = host_costs(lambda: head_topk(x, w, k), 50)
    ms0 = time_cuda(lambda: head_topk(x0, w0, k), 50, graph=True)
    bound_ms, bound_by, flops, bytes_moved = head_bound(N, D, V, k)
    log(f"  head_topk at N={N} D={D} V={V} k={k}: kernel {ms:.4f} ms (launched from Python: "
        f"{costs['launch_ms']:.4f} ms, host {costs['host_ms']:.4f} ms per call), plain "
        f"{plain_ms:.4f} ms, matmul+logsumexp+topk {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.1f} GFLOP, {bytes_moved / 1e6:.2f} MB); "
        f"at N={s['batch']}: kernel {ms0:.4f} ms, "
        f"bound {head_bound(s['batch'], D, V, k)[0]:.4f} ms")
    return entry("head_topk", "openviic_tpu_torch/csrc/head_topk.cu",
                 "openviic_tpu/ops/head_topk.py:103", err, ms, plain_ms, bound_ms, bound_by,
                 library_ms, first_step_ms=ms0, **costs)


# ---------------------------------------------------------------- phase 4
def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_requests(device, requests, decode):
    """decode(request) -> (captions, ids[, totals]) over each request,
    host-timed around work that ends in a synchronize.  Returns (results,
    seconds)."""
    results, seconds = [], []
    for request in requests:
        t0 = time.perf_counter()
        out = decode(request)
        sync(device)
        seconds.append(time.perf_counter() - t0)
        results.append(out)
    return results, seconds


def check_outputs(name, s, vocab, requests, results) -> None:
    """Every request gets one caption of vocab words per image and ids of
    the right shape, all inside the vocab."""
    for request, (captions, ids, *_) in zip(requests, results):
        if len(captions) != len(request) or ids.shape != (len(request), s["max_len"]):
            raise AssertionError(f"{name}: {len(captions)} captions, ids {ids.shape} for "
                                 f"{len(request)} images")
        if ids.min() < 0 or ids.max() >= len(vocab):
            raise AssertionError(f"{name}: token id outside [0, {len(vocab)}): "
                                 f"{ids.min()}..{ids.max()}")
        for caption in captions:
            if not isinstance(caption, str) or any(
                tok not in vocab.stoi or tok in vocab.specials for tok in caption.split()
            ):
                raise AssertionError(f"{name}: caption not made of vocab words: {caption!r}")


def agreement(results, other) -> float:
    """The share of images whose captions are identical in two runs."""
    pairs = [(a, b) for ra, rb in zip(results, other) for a, b in zip(ra[0], rb[0])]
    return float(np.mean([a == b for a, b in pairs]))


def throughput(s, requests, seconds) -> float:
    """Captions per second over the full-batch requests."""
    full = [(len(r), t) for r, t in zip(requests, seconds) if len(r) == s["batch"]]
    return sum(n for n, _ in full) / sum(t for _, t in full)


def serve_phase(device, s, card: str):
    from openviic_tpu_torch.decoding import BeamSearcher
    from openviic_tpu_torch.ops.head_topk import head_topk
    from openviic_tpu_torch.serving import CaptioningPipeline

    config, vocab = model_config(s), make_vocab(s)
    pipe = CaptioningPipeline.from_state_dict(config, vocab, batch_size=s["batch"], device=device,
                                              seed=0)
    rng = np.random.default_rng(0)
    n_images = 2 * s["batch"] + 7
    feats = rng.standard_normal((n_images, s["n_regions"], s["d_feature"]), dtype=np.float32)
    images = [{"region_features": f} for f in feats]
    requests = [images[: s["batch"]], images[s["batch"] : 2 * s["batch"]], images[2 * s["batch"] :]]
    pipe.caption_features(requests[2])  # warm-up: cuBLAS handles, allocator

    sync(device)
    head_topk.launches = 0
    steps0 = pipe.searcher.steps
    results, seconds = run_requests(
        device, requests, lambda request: pipe.caption_features(request, return_ids=True))
    launches = head_topk.launches
    steps = pipe.searcher.steps - steps0
    expected = steps if device.type == "cuda" else 0
    if steps <= 0 or launches != expected:
        raise AssertionError(f"head_topk launched {launches} times over {steps} decode steps")
    check_outputs("serve", s, vocab, requests, results)
    log(f"  served {sum(len(r) for r in requests)} images in requests of "
        f"{[len(r) for r in requests]}: {[round(t, 4) for t in seconds]} s; "
        f"{steps} decode steps, {launches} head_topk launches")
    log(f"  decode throughput at batch {s['batch']}, beam {s['beam']}: "
        f"{throughput(s, requests, seconds):.1f} captions/s on {card}")
    auto = BeamSearcher(pipe.model, head_kernel=True).effective_head_kernel(
        pipe._batch(requests[0]), s["beam"])
    log(f"  head_kernel=True (the auto gate) resolves to {auto} at {s['batch']} images x "
        f"beam {s['beam']}; the serve phase forces the kernel with head_kernel=1")
    log(f"  sample caption: {results[0][0][0]!r}")

    fast = CaptioningPipeline.from_state_dict(config, vocab, batch_size=s["batch"],
                                              head_kernel=False, device=device, seed=0)
    fast_captions = fast.caption_features(requests[0])
    same = np.mean([a == b for a, b in zip(results[0][0], fast_captions)])
    log(f"  captions identical to the fast-select path: {same:.4f} of {len(fast_captions)}")
    if same < AGREEMENT_MIN:
        raise AssertionError(f"agreement {same:.4f} < {AGREEMENT_MIN}")
    return dict(launches=launches, pipe=pipe, vocab=vocab, requests=requests,
                results=results, steps=steps)


# ---------------------------------------------------------------- phase 5
def ulp_errors(got: torch.Tensor, want: torch.Tensor, floor: float = ULP_FLOOR):
    """(max |error|, max error in bf16 ulps, share of elements beyond one
    ulp); ulps are counted at max(|want|, floor): below the floor, f32 sums
    of unit-size terms in another order differ by more than a bf16 ulp of
    the small result."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ulps = err / bf16_ulp(w.abs().clamp_min(floor))
    return err.max().item(), ulps.max().item(), (ulps > 1).float().mean().item()


def step_case(gen, img, s, t, device):
    """Inputs of one mid-decode step (bf16 activations and caches): an
    ancestry whose own slot holds position t, <pad> input tokens on ~5% of
    the rows, raw per-slot <pad> flags at ~10% of the earlier positions after
    0 (at t, the slot's own input token's), positions past t masked, images
    with 25-50 live regions."""
    beam, L, M, D, h = s["beam"], s["max_len"], s["n_regions"], s["d_model"], s["heads"]
    N, d = img * beam, D // h

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device, torch.bfloat16)

    anc = torch.randint(0, beam, (img, beam, L), generator=gen)
    anc[:, :, t] = torch.arange(beam)
    is_pad = torch.rand((N, 1), generator=gen) < 0.05
    pads = torch.rand((N, L), generator=gen) < 0.1
    pads[:, 0] = False
    pads[:, t] = is_pad[:, 0]  # each slot's flag at t is its current input token's
    live_regions = torch.randint(M // 2, M + 1, (img,), generator=gen)
    case = dict(
        x=randn(N, D), k=randn(N, L, h, d), v=randn(N, L, h, d),
        ck=randn(img, M, h, d), cv=randn(img, M, h, d), anc=anc,
        smask=pads | (torch.arange(L) > t)[None],
        cmask=torch.arange(M)[None] >= live_regions[:, None], is_pad=is_pad,
    )
    return {k: v.to(device) for k, v in case.items()}


def distinct_rows(rows: torch.Tensor, live: torch.Tensor) -> int:
    """How many distinct cache rows the live (row, position) pairs read."""
    return int(torch.unique(rows[live]).numel())


def bound(flops: float, peak_flops: float, nbytes: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def unit_bound(nbytes: float, bf16_flops: float = 0.0, f32_flops: float = 0.0,
               sfu_ops: float = 0.0):
    """The bound of a call whose operations run on several units at once:
    products of bf16 operands (f32 accumulation) at the tensor-core peak,
    products with an f32 operand at the f32 peak, transcendentals at the
    special-function rate; the largest of those times and the bytes' time.
    Returns (bound_ms, bound_by, {term: ms})."""
    times = {"bytes": nbytes / PEAK_HBM_BYTES * 1e3,
             "bf16 products": bf16_flops / PEAK_BF16_FLOPS * 1e3,
             "f32 products": f32_flops / PEAK_F32_FLOPS * 1e3,
             "transcendentals": sfu_ops / PEAK_SFU_OPS * 1e3}
    worst = max(times, key=times.get)
    return times[worst], "bytes" if worst == "bytes" else "operations", times


def bound_detail(times) -> str:
    return ", ".join(f"{name} {ms:.4f} ms" for name, ms in times.items())


def entry(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by, library_ms, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=None,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, **extra)


def check_beam_select(name, args, mask_axis, device):
    """The kernel against its plain version within one bf16 ulp; returns
    max |error|."""
    from openviic_tpu_torch.ops.beam_select_attention import (
        beam_select_attention, beam_select_attention_reference, kernel_route)

    got = beam_select_attention(*args, mask_axis=mask_axis)
    want = beam_select_attention_reference(*args, mask_axis=mask_axis)
    sync(device)
    err, ulps, _ = ulp_errors(got, want)
    if not torch.isfinite(got).all() or ulps > 1:
        raise AssertionError(f"beam_select_attention {name} mask_axis={mask_axis}: "
                             f"{ulps:.2f} bf16 ulps (max |err| {err:.3g}) > 1")
    route = kernel_route(*args[:3]) if device.type == "cuda" else "plain"
    log(f"  beam_select_attention {name} mask_axis={mask_axis} (route {route}): "
        f"max |err| {err:.3g} = {ulps:.2f} bf16 ulps")
    return err


def beam_select_phase(device, s):
    """ops.beam_select_attention against its plain version: the main shape
    at mid-decode (t = L // 2) with both mask axes, at t = 0 and t = L - 1,
    q sliced from a fused qkv projection (as the decode gives it), a ragged
    shape (7 images, 35 rows) at the last step with a fully masked row,
    L = 40 (two chunks of 32 positions) and the general kernel's shape (4
    heads of 100); then times at t = 0, L // 2 and L - 1, the bound and the
    yardstick at t = L // 2."""
    from openviic_tpu_torch.ops.beam_select_attention import (
        ancestor_rows, beam_select_attention, beam_select_attention_reference)

    gen = torch.Generator().manual_seed(1)
    beam, L, D, h = s["beam"], s["max_len"], s["d_model"], s["heads"]
    worst, timed = 0.0, {}

    def args_of(c, img, LL, axis):
        N = img * beam
        src = ancestor_rows(c["anc"])
        mask = c["smask"] if axis == "p" else c["smask"][src, torch.arange(LL, device=device)]
        return (c["x"].reshape(N, 1, h, D // h), c["k"], c["v"], c["anc"],
                mask.reshape(N, 1, 1, LL).contiguous())

    for img, t, LL, axes in ((s["batch"], L // 2, L, ("p", "q")), (s["batch"], 0, L, ("p",)),
                             (s["batch"], L - 1, L, ("p",)), (7, L - 1, L, ("p", "q")),
                             (40, 37, 40, ("p", "q"))):
        c = step_case(gen, img, dict(s, max_len=LL), t, device)
        for axis in axes:
            args = args_of(c, img, LL, axis)
            if img == 7 and axis == "q":  # a fully masked row: uniform over all L positions
                args[4][3] = True
            name = f"N={img * beam} L={LL} h={h} t={t}"
            if img == 7 and axis == "q":
                name += ", row 3 fully masked"
            worst = max(worst, check_beam_select(name, args, axis, device))
            if img == s["batch"] and axis == "p":
                timed[t] = (args, c)
    # q as the decode gives it: a slice of the fused qkv projection's rows
    args, c = timed[L // 2]
    N = s["batch"] * beam
    qkv = torch.randn((N, 1, 3 * D), generator=gen).to(device, torch.bfloat16)
    sliced = (qkv[..., :D].reshape(N, 1, h, D // h),) + args[1:]
    worst = max(worst, check_beam_select(f"N={N} t={L // 2}, q sliced from qkv", sliced, "p",
                                         device))
    # the general kernel's shape: rows of 4 x 100 elements
    g = torch.Generator().manual_seed(2)
    odd = tuple(torch.randn(shape, generator=g).to(device, torch.bfloat16)
                for shape in ((35, 1, 4, 100), (35, L, 4, 100), (35, L, 4, 100)))
    odd += (torch.randint(0, beam, (7, beam, L), generator=g).to(device),
            (torch.rand((35, 1, 1, L), generator=g) < 0.3).to(device))
    worst = max(worst, check_beam_select("N=35 h=4 d=100", odd, "q", device))
    if device.type != "cuda":
        return None

    q, k, v, anc, mask = args
    h, d = q.shape[2], q.shape[3]
    src = ancestor_rows(anc)
    pos = torch.arange(L, device=device)
    dead = c["smask"][src, pos]

    def library():  # torch.gather of the ancestor K/V, then SDPA; timed here only
        idx = anc[..., None].expand(-1, -1, -1, h * d)
        b_s = anc.shape[0]
        ks = torch.gather(k.reshape(b_s, beam, L, h * d), 1, idx).reshape(N, L, h, d)
        vs = torch.gather(v.reshape(b_s, beam, L, h * d), 1, idx).reshape(N, L, h, d)
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2),
            attn_mask=~dead[:, None, None, :])

    times = {t: time_cuda(lambda: beam_select_attention(*a, mask_axis="p"), 50, graph=True)
             for t, (a, _) in timed.items()}
    ms = times[L // 2]
    plain_ms = time_cuda(lambda: beam_select_attention_reference(*args, mask_axis="p"), 10,
                         graph=True)
    library_ms = time_cuda(library, 50, graph=True)
    costs = host_costs(lambda: beam_select_attention(*sliced, mask_axis="p"), 50)
    live = ~dead
    rows = distinct_rows(src * L + pos, live)
    nbytes, flops = beam_select_work(N, L, h, d, rows, int(live.sum()))
    bound_ms, bound_by = bound(flops, PEAK_F32_FLOPS, nbytes)
    log(f"  beam_select_attention at N={N} L={L}: kernel {times[0]:.4f} / {ms:.4f} / "
        f"{times[L - 1]:.4f} ms at t = 0 / {L // 2} / {L - 1} (synthetic ancestry: "
        f"{rows} distinct live cache rows at t = {L // 2}); at t = {L // 2}: launched from "
        f"Python {costs['launch_ms']:.4f} ms, host {costs['host_ms']:.4f} ms per call (q sliced "
        f"from qkv), plain {plain_ms:.4f} ms, gather+SDPA {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return entry("beam_select_attention", "openviic_tpu_torch/csrc/beam_select_attention.cu",
                 "openviic_tpu/ops/beam_select_attention.py:173", worst, ms, plain_ms,
                 bound_ms, bound_by, library_ms, ms_t0=times[0], ms_tlast=times[L - 1], **costs)


def beam_select_work(N, L, h, d, rows, n_live):
    """(bytes, flops) one beam-select call must move and do: the distinct
    live K and V cache rows read once, q read and the output written, the
    ancestry and mask read; a dot and a weighted add per live position."""
    return rows * h * d * 2 * 2 + 2 * N * h * d * 2 + N * L * (8 + 1), 4.0 * n_live * h * d


def captured_beam_select(device, s, pipe, request, t):
    """Path (a)'s own inputs to beam_select_attention at decode step t
    (layer 0's call), captured while the pipeline serves ``request``: the
    kernel against its plain version within one bf16 ulp, both timed (CUDA
    graphs), and beside them the kernel's mean device time per launch
    over one profiled request of path (a) (torch.profiler)."""
    import openviic_tpu_torch.models.attention as attention
    from openviic_tpu_torch.ops.beam_select_attention import (
        ancestor_rows, beam_select_attention, beam_select_attention_reference)

    n_layers = len(pipe.model.decoder.layers)
    calls, captured = [0], {}

    def capture(q_t, k, v, ancestry, position_mask, mask_axis="q"):
        if calls[0] == t * n_layers:
            q_copy = torch.empty_strided(q_t.shape, q_t.stride(), dtype=q_t.dtype,
                                         device=q_t.device)
            q_copy.copy_(q_t)  # with the decode's row stride
            captured.update(args=(q_copy, k.clone(), v.clone(), ancestry.clone(),
                                  position_mask.clone()), mask_axis=mask_axis)
        calls[0] += 1
        return beam_select_attention(q_t, k, v, ancestry, position_mask, mask_axis=mask_axis)

    attention.beam_select_attention = capture
    try:
        pipe.caption_features(request, return_ids=True)
    finally:
        attention.beam_select_attention = beam_select_attention
    if not captured:
        raise AssertionError(f"path (a) made {calls[0]} beam-select calls, none at step {t}")
    args, axis = captured["args"], captured["mask_axis"]
    err = check_beam_select(f"captured from path (a) at t={t}", args, axis, device)
    if device.type != "cuda":
        return {}
    q, k, v, anc, mask = args
    N, L = k.shape[:2]
    src = ancestor_rows(anc)
    pos = torch.arange(L, device=device)
    pm = mask.reshape(N, L)
    live = ~(pm[src, pos] if axis == "p" else pm)
    rows = distinct_rows(src * L + pos, live)
    ms = time_cuda(lambda: beam_select_attention(*args, mask_axis=axis), 50, graph=True)
    plain_ms = time_cuda(lambda: beam_select_attention_reference(*args, mask_axis=axis), 10,
                         graph=True)
    nbytes, flops = beam_select_work(N, L, q.shape[2], q.shape[3], rows, int(live.sum()))
    bound_ms, _ = bound(flops, PEAK_F32_FLOPS, nbytes)
    profile_ms, launches = profiled_kernel_ms(
        device, lambda: pipe.caption_features(request, return_ids=True), "beam_select")
    per_launch = profile_ms / max(launches, 1)
    log(f"  beam_select_attention, path (a)'s inputs at t={t}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({rows} distinct live cache rows, "
        f"{int(live.sum())} live positions of {N} rows); profiled path (a) request: "
        f"{launches} launches, {profile_ms:.3f} ms, {per_launch:.4f} ms per launch (every step)")
    return dict(captured_t=t, captured_err=err, captured_ms=ms, captured_plain_ms=plain_ms,
                captured_bound_ms=bound_ms, profile_ms_per_launch=per_launch,
                profile_launches=launches)


def device_times(prof) -> dict:
    """{kernel name: (device ms, launches)} summed over a torch.profiler
    window."""
    out = {}
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = getattr(event, "self_cuda_time_total", 0.0)
        if us and event.device_type == torch.autograd.DeviceType.CUDA:
            total, count = out.get(event.key, (0.0, 0))
            out[event.key] = (total + us / 1e3, count + event.count)
    return out


def profiled_kernel_ms(device, fn, match: str):
    """(device ms, launches) of the CUDA kernels whose name holds ``match``
    over one call of ``fn`` under torch.profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sync(device)
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        sync(device)
    found = [v for key, v in device_times(prof).items() if match in key]
    if not found:
        raise AssertionError(f"the profile shows no kernel named like {match!r}")
    return sum(ms for ms, _ in found), sum(count for _, count in found)


def check_resident_step(name, args, t, weights, h, device):
    """ops.resident_layer_step against its plain version on ``args`` (x,
    caches, cross K/V, ancestry, masks, is_pad): y within RESIDENT_Y_ULPS
    bf16 ulps of max(|y|, 1) with at most RESIDENT_Y_SHARE of the elements
    beyond one, k_new and v_new within one ulp.  Returns (max |error|,
    detail)."""
    from openviic_tpu_torch.ops.resident_layer_step import (
        resident_layer_step, resident_layer_step_reference)

    got = resident_layer_step(*args, t, weights, h)
    want = resident_layer_step_reference(*args, t, weights, h)
    sync(device)
    y_err, y_ulps, y_share = ulp_errors(got[0], want[0], floor=1.0)
    kv = [ulp_errors(g, w) for g, w in zip(got[1:], want[1:])]
    ok = (torch.isfinite(got[0]).all() and y_ulps <= RESIDENT_Y_ULPS
          and y_share <= RESIDENT_Y_SHARE and all(u <= 1 for _, u, _ in kv))
    detail = (f"y {y_ulps:.2f} ulps of max(|y|, 1) (max |err| {y_err:.3g}, "
              f"{y_share:.2e} beyond 1 ulp); k_new/v_new {max(u for _, u, _ in kv):.2f} ulps")
    if not ok:
        raise AssertionError(f"{name}: {detail}")
    return max(y_err, *(e for e, _, _ in kv)), detail


def check_fused_step(name, ins, k0, v0, t, weights, h, device):
    """ops.fused_layer_step against its plain version on ``ins`` (x, cross
    K/V, masks) and copies of the caches ``k0``/``v0``: y and the cache row
    t within one bf16 ulp, the other rows bit-unchanged.  Returns (max
    |error|, detail)."""
    from openviic_tpu_torch.ops.fused_decoder_step import (
        fused_layer_step, fused_layer_step_reference)

    L = k0.shape[1]
    kk, vk, kp, vp = k0.clone(), v0.clone(), k0.clone(), v0.clone()
    y = fused_layer_step(ins[0], kk, vk, *ins[1:], t, weights, h)[0]
    y_ref = fused_layer_step_reference(ins[0], kp, vp, *ins[1:], t, weights, h)[0]
    sync(device)
    others = torch.arange(L, device=device) != t
    untouched = bool(torch.equal(kk[:, others], k0[:, others])
                     and torch.equal(vk[:, others], v0[:, others]))
    errs = [ulp_errors(y, y_ref), ulp_errors(kk[:, t], kp[:, t]), ulp_errors(vk[:, t], vp[:, t])]
    ok = torch.isfinite(y).all() and untouched and all(u <= 1 for _, u, _ in errs)
    detail = (f"y {errs[0][1]:.2f} ulps (max |err| {errs[0][0]:.3g}), cache row t "
              f"{max(errs[1][1], errs[2][1]):.2f} ulps, other rows "
              f"{'bit-unchanged' if untouched else 'CHANGED'}")
    if not ok:
        raise AssertionError(f"{name}: {detail}")
    return max(e for e, _, _ in errs), detail


def layer_step_bound(resident: bool, t, weights, N, smask, cmask, anc=None):
    """A layer step's bound on these inputs: the distinct live self-cache
    rows (through the ancestry, resident) and the live cross rows (image
    granularity, resident; one copy per row, fused) read once, the weights,
    activations and masks; the products at the tensor-core peak (the fused
    step's f32 operands as three bf16 terms each).  ``smask`` (N, L) and
    ``cmask`` (IMG or N, M) bool, True = masked.  Returns (bound_ms,
    bound_by, bytes, flops)."""
    from openviic_tpu_torch.ops.beam_select_attention import ancestor_rows

    L, M = smask.shape[1], cmask.shape[1]
    D, F = weights["wo"].shape[0], weights["w1"].shape[1]
    pos = torch.arange(L, device=smask.device)
    weight_bytes = sum(w.numel() for w in weights.values()) * 2
    gemm_flops = 2.0 * N * D * (6 * D + 2 * F)
    if resident:
        img, beam = anc.shape[:2]
        src = ancestor_rows(anc)
        live = ~(smask[src, pos] | (pos == t))
        self_rows = distinct_rows(src * L + pos, live)
        cross_rows = int((~cmask).sum())  # image granularity
        live_cross = int((~cmask).sum(dim=1).repeat_interleave(beam).sum())
        nbytes = ((self_rows + cross_rows) * D * 2 * 2 + weight_bytes + 4 * N * D * 2
                  + N * L * (8 + 1) + img * M + N)
        flops = gemm_flops + 4.0 * (int(live.sum()) + N + live_cross) * D
    else:
        live = ~smask & (pos != t)
        live_cross = int((~cmask).sum())  # one copy per row
        nbytes = ((int(live.sum()) + live_cross) * D * 2 * 2 + weight_bytes + 2 * N * D * 2
                  + 2 * N * D * 2 + N * (L + M))
        # f32 products go to the tensor cores as three bf16 terms each
        flops = 3 * gemm_flops + 4.0 * (int(live.sum()) + N + live_cross) * D
    return bound(flops, PEAK_BF16_FLOPS, nbytes) + (nbytes, flops)


# The layer steps' times at the flagship shape (N = 1600, t = 12, M = 50)
# before their attention took any encoder length: PERF.md section 6 rows 3
# and 4 (CUDA-graph device times on an H100 80GB HBM3 at 700 W), printed
# beside this run's.
EARLIER_STEP_MS = {"resident_layer_step": 0.2386, "fused_layer_step": 0.3281}


def layer_step_phase(device, s, layer, resident: bool):
    """ops.resident_layer_step (resident) or ops.fused_layer_step against its
    plain version, with the flagship's layer-0 weights: the main shape at a
    mid-decode step and a ragged shape (7 images, 35 rows) at the last
    step, and for the resident step the main shape at t = 0 and t = L - 1
    and 37 images (185 rows, which on the card leave the last cluster tile
    short: asserted) at a mid-decode step too; then times (a CUDA graph's,
    and launched from Python), the unfused eager ``DecoderLayer.step`` it
    replaces, and the bound."""
    from openviic_tpu_torch.ops.fused_decoder_step import (
        fused_layer_step, fused_layer_step_reference)
    from openviic_tpu_torch.ops.resident_layer_step import (
        resident_layer_step, resident_layer_step_reference)

    name = "resident_layer_step" if resident else "fused_layer_step"
    gen = torch.Generator().manual_seed(2 if resident else 3)
    weights = layer.fused_weights(torch.bfloat16)
    beam, L, M, D, h = s["beam"], s["max_len"], s["n_regions"], s["d_model"], s["heads"]
    F = weights["w1"].shape[1]
    worst, timed_case = 0.0, None
    shapes = [(s["batch"], L // 2), (7, L - 1), (s["batch"], 0), (s["batch"], L - 1),
              (37, L // 2)]
    for img, t in shapes:
        c = step_case(gen, img, s, t, device)
        N = img * beam
        if resident:
            args = (c["x"][:, None], c["k"], c["v"], c["ck"], c["cv"], c["anc"],
                    c["smask"].reshape(N, 1, 1, L), c["cmask"].reshape(img, 1, 1, M), c["is_pad"])
            err, detail = check_resident_step(f"{name} N={N} t={t}", args, t, weights, h, device)
        else:
            rows = lambda a: a.reshape(img, M, D).repeat_interleave(beam, dim=0)  # noqa: E731
            k0, v0 = c["k"].reshape(N, L, D), c["v"].reshape(N, L, D)
            ins = (c["x"], rows(c["ck"]), rows(c["cv"]), c["smask"],
                   c["cmask"].repeat_interleave(beam, dim=0))
            err, detail = check_fused_step(f"{name} N={N} t={t}", ins, k0, v0, t, weights, h,
                                           device)
            args = (ins, k0, v0)
        if img == 37 and device.type == "cuda":
            from openviic_tpu_torch.ops.layer_step import occupancy

            tile = occupancy(resident, N, D, F, L, M, h)["rows_per_tile"]
            if N % tile == 0:
                raise AssertionError(f"{name} N={N}: tiles of {tile} rows leave "
                                     f"no short tile; pick another row count")
            detail += f"; tiles of {tile} rows, the last of {N % tile}"
        worst = max(worst, err)
        log(f"  {name} N={N} L={L} M={M} D={D} F={F} t={t}: {detail}")
        if timed_case is None:
            timed_case = (c, args, img, t)
    if device.type != "cuda":
        return None

    c, args, img, t = timed_case
    N = img * beam
    if resident:
        kernel = lambda: resident_layer_step(*args, t, weights, h)  # noqa: E731
        plain = lambda: resident_layer_step_reference(*args, t, weights, h)  # noqa: E731
        cache = {"self": {"k": c["k"].clone(), "v": c["v"].clone()},
                 "cross": {"k": c["ck"], "v": c["cv"]}}
        eager = lambda: layer.step(  # noqa: E731
            c["x"][:, None], cache, t, args[6], args[7], ancestry=c["anc"],
            beam_select=beam, mask_axis="p")
    else:
        ins, k0, v0 = args
        kk, vk = k0.clone(), v0.clone()
        kernel = lambda: fused_layer_step(ins[0], kk, vk, *ins[1:], t, weights, h)  # noqa: E731
        plain = lambda: fused_layer_step_reference(  # noqa: E731
            ins[0], kk, vk, *ins[1:], t, weights, h)
        cache = {"self": {"k": k0.clone().reshape(N, L, h, D // h),
                          "v": v0.clone().reshape(N, L, h, D // h)},
                 "cross": {"k": ins[1].reshape(N, M, h, D // h),
                           "v": ins[2].reshape(N, M, h, D // h)}}
        eager = lambda: layer.step(  # noqa: E731
            c["x"][:, None], cache, t, ins[3].reshape(N, 1, 1, L), ins[4].reshape(N, 1, 1, M))
    ms = time_cuda(kernel, 20, graph=True)
    plain_ms = time_cuda(plain, 5, graph=True)
    eager_ms = time_cuda(eager, 20)
    costs = host_costs(kernel, 20)
    # how far the kernel's numerics sit from the eager bf16 step it replaces
    # (informational: the eager step rounds every intermediate to bf16)
    y_kernel, y_eager = kernel()[0].reshape(N, D), eager().reshape(N, D)
    keep = ~c["is_pad"][:, 0] if resident else torch.ones(N, dtype=torch.bool, device=device)
    e_err, e_ulps, e_share = ulp_errors(y_kernel[keep], y_eager[keep], floor=1.0)
    log(f"  {name} against the eager DecoderLayer.step: max |dy| {e_err:.3g} = {e_ulps:.1f} "
        f"ulps of max(|y|, 1), {e_share:.3f} of the elements beyond 1 ulp")

    if resident:
        bound_ms, bound_by, nbytes, flops = layer_step_bound(
            True, t, weights, N, c["smask"], c["cmask"], anc=c["anc"])
    else:
        bound_ms, bound_by, nbytes, flops = layer_step_bound(False, t, weights, N, c["smask"],
                                                             ins[4])
    log(f"  {name} at N={N} t={t}: kernel {ms:.4f} ms (PERF.md's before the M-independent "
        f"attention: {EARLIER_STEP_MS[name]} ms; launched from Python: "
        f"{costs['launch_ms']:.4f} ms, host {costs['host_ms']:.4f} ms per call), plain "
        f"{plain_ms:.4f} ms, eager DecoderLayer.step {eager_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")
    replaces = ("openviic_tpu/ops/resident_layer_step.py:201" if resident
                else "openviic_tpu/ops/fused_decoder_step.py:190")
    return entry(name, "openviic_tpu_torch/csrc/layer_step.cu", replaces, worst, ms, plain_ms,
                 bound_ms, bound_by, None, eager_ms=eager_ms, **costs)


# ---------------------------------------------------------------- phase 6
def counted_wrappers():
    """Every kernel wrapper of the port, each with its launch count."""
    from openviic_tpu_torch.ops.beam_select_attention import beam_select_attention
    from openviic_tpu_torch.ops.fused_attention import fused_attention
    from openviic_tpu_torch.ops.fused_decoder_step import fused_layer_step
    from openviic_tpu_torch.ops.geo_attention import geo_fused_attention
    from openviic_tpu_torch.ops.head_topk import head_topk
    from openviic_tpu_torch.ops.resident_layer_step import resident_layer_step

    return (head_topk, beam_select_attention, resident_layer_step, fused_layer_step,
            fused_attention, geo_fused_attention)


@contextlib.contextmanager
def env_flag(name: str, value: str = "1"):
    """Set one of the port's environment flags for the block."""
    before = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            del os.environ[name]
        else:
            os.environ[name] = before


def searcher_decode(pipe, searcher, vocab, beam, **options):
    """decode(request) -> (captions, ids, best-beam total log-probs);
    ``options`` go to the searcher (RSTNet's ``language_table``)."""
    def decode(request):
        outputs, log_probs = searcher(pipe._batch(request), beam, **options)
        ids = outputs[: len(request)].cpu().numpy()
        totals = log_probs[: len(request)].sum(-1).cpu().numpy()
        return vocab.decode_caption(ids), ids, totals
    return decode


def drive(name, device, s, vocab, requests, searcher, decode, card, per_step=None,
          per_request=None):
    """Warm up (on the card, on the last request), zero every count, run
    the requests, read the counts.  ``per_step`` and ``per_request`` map
    kernel names to their launches per decode step and per request; every
    other kernel must not launch.  Returns (results, launches by name)."""
    cuda = device.type == "cuda"
    counted = counted_wrappers()
    if cuda:
        decode(requests[-1])
        sync(device)
    for fn in counted:
        fn.launches = 0
    steps0 = searcher.steps
    results, seconds = run_requests(device, requests, decode)
    steps = searcher.steps - steps0
    launches = {fn.__name__: fn.launches for fn in counted}
    per_step, per_request = per_step or {}, per_request or {}
    want = {fn.__name__: (per_step.get(fn.__name__, 0) * steps
                          + per_request.get(fn.__name__, 0) * len(requests) if cuda else 0)
            for fn in counted}
    if steps <= 0 or launches != want:
        raise AssertionError(f"{name}: launches {launches} over {steps} decode steps and "
                             f"{len(requests)} requests, expected {want}")
    check_outputs(name, s, vocab, requests, results)
    log(f"  {name}: {[round(t, 4) for t in seconds]} s per request, "
        f"{throughput(s, requests, seconds):.1f} captions/s on {card}; {steps} steps, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return results, launches


def rescore(device, requests, decode, results, name):
    """Best-beam total log-probs of a run whose decode returned none:
    decoded again (uncounted), and the ids must come out the same."""
    rescored = run_requests(device, requests, decode)[0]
    for (_, ids, *_), (_, again, _) in zip(results, rescored):
        if not np.array_equal(ids, again):
            raise AssertionError(f"{name}: a second decode of the same batch differs")
    return rescored


def score_parity(name, results, ref, ref_name):
    """Print caption agreement and gate the mean best-beam log-prob within
    SCORE_RTOL of the reference path's."""
    same = agreement(results, ref)
    got = np.concatenate([r[2] for r in results])
    want = np.concatenate([r[2] for r in ref])
    gap = np.abs(got - want)
    rel = abs(got.mean() - want.mean()) / abs(want.mean())
    log(f"  {name} against {ref_name}: captions identical {same:.4f}; mean best-beam "
        f"log-prob {got.mean():.4f} against {want.mean():.4f} (relative {rel:.2e}); "
        f"|difference| <= 0.5 on {np.mean(gap <= 0.5):.4f} of the images")
    if rel > SCORE_RTOL:
        raise AssertionError(f"{name}: mean best-beam log-prob differs by {rel:.2e} > "
                             f"{SCORE_RTOL} from {ref_name}")
    return same


def decode_paths_phase(device, s, served, card: str):
    """Three more decode paths of the flagship at the serve shape, over the
    same three requests: (a) CaptioningPipeline with DECODE_ATTN_KERNEL and
    the head kernel; (b) resident_kernel with the head kernel; (c) the
    non-resident path with OPENVIIC_FUSED_STEP=1, and without it.  Each
    path's launches per decode step are asserted, its ids must lie in the
    vocab, and the mean best-beam log-prob of its captions must be within
    SCORE_RTOL of its reference path's; caption agreement is printed beside
    that of two eager paths (non-resident against beam-resident), since
    with random weights at bf16 near-equal beams make captions flip under
    any change of rounding.  Returns each step kernel's launches on its
    path, and the reference paths' results."""
    from openviic_tpu_torch.decoding import BeamSearcher
    from openviic_tpu_torch.serving import CaptioningPipeline

    vocab, requests, pipe = (served[k] for k in ("vocab", "requests", "pipe"))
    n_layers = len(pipe.model.decoder.layers)
    beam = s["beam"]

    def run(name, searcher, decode, **expect):
        return drive(name, device, s, vocab, requests, searcher, decode, card, **expect)

    out = {}
    base = rescore(device, requests, searcher_decode(pipe, pipe.searcher, vocab, beam),
                   served["results"], "serve")

    attn_pipe = CaptioningPipeline.from_state_dict(model_config(s, attn_kernel=True), vocab,
                                                   batch_size=s["batch"], device=device, seed=0)
    res_a, launches = run(
        "(a) DECODE_ATTN_KERNEL + head kernel", attn_pipe.searcher,
        lambda request: attn_pipe.caption_features(request, return_ids=True),
        per_step={"beam_select_attention": n_layers, "head_topk": 1})
    out["beam_select_attention"] = launches["beam_select_attention"]
    out["beam_select_captured"] = captured_beam_select(device, s, attn_pipe, requests[0],
                                                       s["max_len"] // 2)
    res_a = rescore(device, requests, searcher_decode(attn_pipe, attn_pipe.searcher, vocab, beam),
                    res_a, "(a)")
    score_parity("(a)", res_a, base, "the head-kernel path")

    resident = BeamSearcher(pipe.model, torch.bfloat16, head_kernel=1, resident_kernel=True)
    res_b, launches = run("(b) resident_kernel + head kernel", resident,
                          searcher_decode(pipe, resident, vocab, beam),
                          per_step={"resident_layer_step": n_layers, "head_topk": 1})
    out["resident_layer_step"] = launches["resident_layer_step"]
    score_parity("(b)", res_b, base, "the head-kernel path")

    with env_flag("OPENVIIC_FUSED_STEP"):
        fused = BeamSearcher(pipe.model, torch.bfloat16, beam_resident=False)
        res_c, launches = run("(c) non-resident, OPENVIIC_FUSED_STEP=1", fused,
                              searcher_decode(pipe, fused, vocab, beam),
                              per_step={"fused_layer_step": n_layers})
    out["fused_layer_step"] = launches["fused_layer_step"]
    plain = BeamSearcher(pipe.model, torch.bfloat16, beam_resident=False)
    res_nr, _ = run("(c) non-resident, no step kernel", plain,
                    searcher_decode(pipe, plain, vocab, beam))
    score_parity("(c)", res_c, res_nr, "the non-resident path without the flag")
    score_parity("non-resident (eager)", res_nr, base, "the beam-resident head-kernel path")
    out["refs"] = {"base": base, "non_resident": res_nr}
    return out


# ---------------------------------------------------------------- phase 7
@torch.no_grad()
def forced_scores(model, batch, ids, vocab, resident: bool, language_table=None, **flags):
    """Per-step log-probs of the tokens ``ids`` (one full batch of images,
    max_len) fed back one step at a time, beam 1, through
    ``model.decode_step``, beam-resident or not (RSTNet's steps through
    ``language_table`` where given)."""
    from openviic_tpu_torch.models.base import make_decode_cache

    L = vocab.max_caption_length
    tokens = torch.cat([torch.full_like(ids[:, :1], vocab.bos_idx), ids[:, :-1]], dim=1)
    memory, mask = model.encoder_forward(batch)
    b_s = memory.shape[0]
    cache = make_decode_cache(model.config.DECODER, vocab, b_s, dtype=torch.bfloat16,
                              device=ids.device)
    cache = model.prepare_cache(cache, memory)
    if language_table is not None:
        cache["language_table"] = language_table.to(torch.bfloat16)
    ancestry = torch.zeros((b_s, 1, L), dtype=torch.long, device=ids.device) if resident else None
    per_step = []
    for t in range(L):
        log_probs, cache = model.decode_step(
            t, tokens[:, t : t + 1], cache, mask, ancestry=ancestry,
            beam_select=1 if resident else None, **flags)
        per_step.append(torch.gather(log_probs, 1, ids[:, t : t + 1])[:, 0])
    return torch.stack(per_step, dim=1)


def check_forced(name, ids, vocab, got, want, gate=True):
    """Per-step |d log-prob| of the forced tokens (steps up to the first
    <eos>): at least FORCED_SHARE of them within FORCED_ATOL."""
    is_eos = (ids == vocab.eos_idx).long()
    scored = (torch.cumsum(is_eos, dim=1) - is_eos) == 0
    diff = (got - want).abs()[scored]
    share = (diff <= FORCED_ATOL).float().mean().item()
    totals = ((got - want) * scored).sum(dim=1).abs()
    log(f"  {name}: per-step |d log-prob| max {diff.max().item():.4g}, mean "
        f"{diff.mean().item():.3g}, within {FORCED_ATOL} on {share:.4f} of "
        f"{diff.numel()} steps; per-caption |d total| mean {totals.mean().item():.3g}, "
        f"max {totals.max().item():.3g}")
    if gate and share < FORCED_SHARE:
        raise AssertionError(f"{name}: {share:.4f} of the forced steps within "
                             f"{FORCED_ATOL} < {FORCED_SHARE}")


def forced_phase(device, s, served):
    """The step kernels inside a whole decode with the tokens forced: the
    serve phase's captions of the first request are fed back one step at a
    time (beam 1) through the eager step and through each kernel path, and
    each step's log-prob of the forced token must agree with the eager
    path's within FORCED_ATOL on at least FORCED_SHARE of the scored
    (image, step) pairs (steps up to the first <eos>).  Unlike caption
    agreement, a rounding difference cannot turn into another caption."""
    pipe, vocab, model = served["pipe"], served["vocab"], served["pipe"].model
    ids = torch.from_numpy(served["results"][0][1]).to(device)
    batch = pipe._batch(served["requests"][0])

    def score(resident, **flags):
        return forced_scores(model, batch, ids, vocab, resident, **flags)

    def check(name, got, want):
        check_forced(name, ids, vocab, got, want)

    eager = score(True)
    check("(a) attention kernel against the eager step", score(True, attn_kernel=True), eager)
    check("(b) resident kernel against the eager step", score(True, resident_kernel=True), eager)
    eager_nr = score(False)
    with env_flag("OPENVIIC_FUSED_STEP"):
        fused = score(False)
    check("(c) fused step against the eager non-resident step", fused, eager_nr)
    check("eager non-resident against eager beam-resident", eager_nr, eager)
    return {"eager": eager, "eager_nr": eager_nr}


# ---------------------------------------------------------------- phase 9
def ort_config(s, trig: bool):
    """The Object Relation Transformer of ``configs/object_relation_transformer.yaml``
    at the widths of ``s`` (3+3 layers, d_model 512, 8 heads, d_ff 2048,
    1024-d features at full width), the yaml's beam 3, with
    ``ENCODER.TRIGNOMETRIC_EMBEDDING`` set to ``trig`` (the yaml has it
    false; true is the ORT paper's dim_g = 64, wave_len 1000)."""
    config = model_config(s)
    model = config.MODEL.to_dict()
    model["ARCHITECTURE"] = "ObjectRelationTransformer"
    model["ENCODER"]["ARCHITECTURE"] = "GeometricEncoder"
    model["ENCODER"]["TRIGNOMETRIC_EMBEDDING"] = trig
    model["ENCODER"]["SELF_ATTENTION"]["ARCHITECTURE"] = "AugmentedGeometryScaledDotProductAttention"
    training = dict(config.TRAINING.to_dict(), EVALUATING_BEAM_SIZE=s["ort_beam"])
    from openviic_tpu_torch.config import ConfigNode

    return ConfigNode({"MODEL": model, "TRAINING": training})


def attention_paths_phase(device, s, served, paths, card: str):
    """The decode paths of the two attention kernels at the serve shape:
    (d) OPENVIIC_PALLAS=1 on the served beam-resident flagship (the encoder:
    one fused_attention per encoder layer and request); (e) the same with
    beam_resident=False (also one per decoder self- and cross-attention per
    step); (f) the ORT with the trig embedding off, with and without
    OPENVIIC_PALLAS=1 (its (B, h, n, n) geometric bias through the kernel);
    (g) the ORT with the trig embedding on, with and without
    OPENVIIC_GEO_FUSED=1 (one geo_fused_attention per encoder layer and
    request).  Each asserts its launches, valid ids and score parity with
    its flag-off twin, and prints captions/s and caption agreement; (d),
    (e) and (g) then pass the forced decode against their twins.  Returns
    each kernel's launches on its path."""
    from openviic_tpu_torch.decoding import BeamSearcher
    from openviic_tpu_torch.serving import CaptioningPipeline

    vocab, requests, pipe = (served[k] for k in ("vocab", "requests", "pipe"))
    n_enc = len(pipe.model.encoder.layers)
    n_dec = len(pipe.model.decoder.layers)
    beam = s["beam"]
    refs = paths["refs"]
    out = {}

    def run(name, searcher, decode, reqs=requests, **expect):
        return drive(name, device, s, vocab, reqs, searcher, decode, card, **expect)

    with env_flag("OPENVIIC_PALLAS"):
        res_d, launches = run("(d) OPENVIIC_PALLAS=1, served path", pipe.searcher,
                              lambda request: pipe.caption_features(request, return_ids=True),
                              per_step={"head_topk": 1}, per_request={"fused_attention": n_enc})
        out["fused_attention"] = launches["fused_attention"]
        res_d = rescore(device, requests, searcher_decode(pipe, pipe.searcher, vocab, beam),
                        res_d, "(d)")
        non_resident = BeamSearcher(pipe.model, torch.bfloat16, beam_resident=False)
        res_e, _ = run("(e) OPENVIIC_PALLAS=1, beam_resident=False", non_resident,
                       searcher_decode(pipe, non_resident, vocab, beam),
                       per_step={"fused_attention": 2 * n_dec},
                       per_request={"fused_attention": n_enc})
    score_parity("(d)", res_d, refs["base"], "the served path without the flag")
    score_parity("(e)", res_e, refs["non_resident"], "the non-resident path without the flag")

    # the ORT: the same images, with boxes in pixels (all 50 regions live;
    # the pipeline pads features and boxes to 56 rows of zeros)
    gen = torch.Generator().manual_seed(8)
    boxes = pixel_boxes(gen, sum(len(r) for r in requests), s["n_regions"],
                        torch.full((sum(len(r) for r in requests),), s["n_regions"])).numpy()
    flat = [dict(image, region_boxes=b) for r in requests for image, b in zip(r, boxes)]
    sizes = np.cumsum([0] + [len(r) for r in requests])
    ort_requests = [flat[a:b] for a, b in zip(sizes[:-1], sizes[1:])]
    ort_forced = {}
    for trig, flag, kernel in ((False, "OPENVIIC_PALLAS", "fused_attention"),
                               (True, "OPENVIIC_GEO_FUSED", "geo_fused_attention")):
        tag = "(g) ORT trig-on" if trig else "(f) ORT trig-off"
        ort = CaptioningPipeline.from_state_dict(ort_config(s, trig), vocab, batch_size=s["batch"],
                                                 head_kernel=1, device=device, seed=1)
        beam_o = ort.beam_size
        decode = searcher_decode(ort, ort.searcher, vocab, beam_o)
        res_off, _ = run(f"{tag}, no flag", ort.searcher, decode, reqs=ort_requests,
                         per_step={"head_topk": 1})
        with env_flag(flag):
            res_on, launches = run(f"{tag}, {flag}=1", ort.searcher, decode, reqs=ort_requests,
                                   per_step={"head_topk": 1}, per_request={kernel: n_enc})
        if trig:
            out["geo_fused_attention"] = launches["geo_fused_attention"]
        score_parity(tag, res_on, res_off, "its path without the flag")
        if trig:
            ort_forced = dict(pipe=ort, ids=res_off[0][1], request=ort_requests[0], flag=flag)

    # forced decodes of (d), (e) and (g) against their flag-off twins
    ids = torch.from_numpy(served["results"][0][1]).to(device)
    batch = pipe._batch(requests[0])
    eager, eager_nr = paths["forced"]["eager"], paths["forced"]["eager_nr"]
    with env_flag("OPENVIIC_PALLAS"):
        check_forced("(d) OPENVIIC_PALLAS=1 against the served eager step", ids, vocab,
                     forced_scores(pipe.model, batch, ids, vocab, True), eager)
        check_forced("(e) OPENVIIC_PALLAS=1 against the eager non-resident step", ids, vocab,
                     forced_scores(pipe.model, batch, ids, vocab, False), eager_nr)
    # (g) with the boxes as the pipeline gives them (f32), then in bf16, as
    # the beam search casts every floating input (the JAX package's rule):
    # there the eager path computes its log displacements in bf16, so the
    # trig embedding's 100-rad-per-unit frequencies carry errors of order
    # 1 rad that the kernel's f32 displacements do not, in the JAX package
    # as here (tests/test_torch_port_ort.py, ROADMAP.md section C).  The
    # bf16 case is gated on the card, at the served width; at the CPU
    # rehearsal's two heads and random weights that gap alone exceeds
    # FORCED_ATOL (as JAX's own does in the test), so there it is printed
    ort = ort_forced["pipe"]
    ids_g = torch.from_numpy(ort_forced["ids"]).to(device)
    batch_g = ort._batch(ort_forced["request"])
    batch_bf16 = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                  for k, v in batch_g.items()}
    for boxes, batch_x in (("f32", batch_g), ("bf16", batch_bf16)):
        off = forced_scores(ort.model, batch_x, ids_g, vocab, True)
        with env_flag(ort_forced["flag"]):
            on = forced_scores(ort.model, batch_x, ids_g, vocab, True)
        check_forced(f"(g) OPENVIIC_GEO_FUSED=1 against the ORT eager encoder, {boxes} boxes",
                     ids_g, vocab, on, off, gate=boxes == "f32" or device.type == "cuda")
    return out


# ---------------------------------------------------------------- phase 8
FUSED_ATOL = 2e-5  # the JAX test's bar (tests/test_pallas_attention.py)
GEO_ULPS, GEO_SHARE, GEO_ATOL = 2, 0.99, 0.05


def mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """The -1e30 additive form of a True = masked mask, as ``_attend`` makes it."""
    return torch.zeros(mask.shape, device=mask.device).masked_fill(mask, -1e30)


def check_fused_attention(name, q, k, v, bias, device, tile=None, want=None):
    """ops.fused_attention (through ``tile``, or the one it chooses) against
    its plain version: f32 out, finite, within FUSED_ATOL.  Returns (max
    |error|, output)."""
    from openviic_tpu_torch.ops import fused_attention as fa

    if want is None:
        want = fa.fused_attention_reference(q, k, v, bias)
    got = fa.fused_attention(q, k, v, bias, tile=tile)
    sync(device)
    err = (got - want).abs().max().item()
    if got.dtype != torch.float32 or got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"fused_attention {name}: {got.dtype} {tuple(got.shape)}, "
                             f"finite {bool(torch.isfinite(got).all())}")
    if err > FUSED_ATOL:
        raise AssertionError(f"fused_attention {name}: max |err| {err:.3g} > {FUSED_ATOL}")
    return err, got


def fused_attention_cases(gen, s, device):
    """(name, q, k, v, bias) at the shapes the decode paths give the kernel:
    the encoder (images x regions padded to a multiple of 8, mask bias), the
    non-resident step's self- (nq = 1, nk = max_len, position mask; q/k/v
    strided slices of one fused projection, as ``project_qkv_fused`` gives
    them) and cross-attention (nk = regions), the ORT trig-off encoder's full
    (B, h, n, n) bias, a ragged f32 shape (7 images, nk = 13) with one fully
    masked row; then the tiles' edges: nq = 1 at nk = 1, nk = 200 (past
    64-key tiles) and nk = 300 (past the decode tile's 256 kept scores),
    nq = 65 (past a 64-query tile), and bf16 q/k/v sliced 2 bytes off
    16-byte alignment with odd strides (the kernel loads them element by
    element) at the encoder's and the step's nq."""
    img, beam, L, h, D = s["batch"], s["beam"], s["max_len"], s["heads"], s["d_model"]
    d, n = D // h, -(-s["n_regions"] // 8) * 8
    N = img * beam

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(device, dtype)

    def unaligned(B, m):  # (B, m, h, d) bf16 views 2 bytes past 16-byte alignment
        return randn(B, m, h * d + 1)[..., 1:].view(B, m, h, d)

    def random_mask(B, nq, nk, p=0.2):
        mask = torch.rand((B, 1, nq, nk), generator=gen) < p
        mask[..., 0] = False
        return mask_bias(mask).to(device)

    live = torch.randint(n // 2, s["n_regions"] + 1, (img,), generator=gen)
    enc_mask = (torch.arange(n)[None] >= live[:, None]).reshape(img, 1, 1, n)
    q_s = randn(N, 1, 3 * D)[..., :D].reshape(N, 1, h, d)  # strided, as sliced from q|k|v
    t = L // 2
    pos_mask = (torch.rand((N, L), generator=gen) < 0.1) | (torch.arange(L) > t)[None]
    pos_mask[:, 0] = False
    cross_live = live.repeat_interleave(beam)
    cross_mask = (torch.arange(n)[None] >= cross_live[:, None]).reshape(N, 1, 1, n)
    geo_bias = torch.log(torch.clamp_min(torch.relu(torch.randn((img, h, n, n), generator=gen)),
                                         1e-6)) + mask_bias(enc_mask.expand(img, h, n, n))
    ragged_mask = torch.rand((7, 1, 1, 13), generator=gen) < 0.3
    ragged_mask[..., 0] = False
    ragged_mask[3] = True  # every key of image 3: its rows are uniform
    few = 16  # images of the edge cases
    return [
        ("encoder", randn(img, n, h, d), randn(img, n, h, d), randn(img, n, h, d),
         mask_bias(enc_mask).to(device)),
        ("step self", q_s, randn(N, L, h, d), randn(N, L, h, d),
         mask_bias(pos_mask.reshape(N, 1, 1, L)).to(device)),
        ("step cross", q_s, randn(N, n, h, d), randn(N, n, h, d),
         mask_bias(cross_mask).to(device)),
        ("ORT trig-off bias", randn(img, n, h, d), randn(img, n, h, d), randn(img, n, h, d),
         geo_bias.to(device)),
        ("ragged f32", randn(7, 13, h, d, dtype=torch.float32),
         randn(7, 13, h, d, dtype=torch.float32), randn(7, 13, h, d, dtype=torch.float32),
         mask_bias(ragged_mask).to(device)),
        ("nq 1, nk 1", randn(few, 1, h, d), randn(few, 1, h, d), randn(few, 1, h, d), None),
        ("nq 1, nk 200", randn(few, 1, h, d), randn(few, 200, h, d), randn(few, 200, h, d),
         random_mask(few, 1, 200)),
        ("nq 1, nk 300", randn(few, 1, h, d), randn(few, 300, h, d), randn(few, 300, h, d),
         random_mask(few, 1, 300)),
        ("nq 65, nk 200", randn(few, 65, h, d), randn(few, 200, h, d), randn(few, 200, h, d),
         random_mask(few, 65, 200)),
        ("unaligned bf16 encoder", unaligned(few, n), unaligned(few, n), unaligned(few, n),
         random_mask(few, 1, n)),
        ("unaligned bf16 step", unaligned(few, 1), unaligned(few, L), unaligned(few, L),
         random_mask(few, 1, L)),
    ]


CROSSOVER_NQ = (1, 2, 4, 8, 16, 32)


def attention_bound(q, k, v, bias):
    """fused_attention's bound on these inputs, counting the work their
    masks leave: q read once (its live columns only); the K and V rows of
    the keys that some query of their (batch, head) can see (a bias above
    -5e29), with every key of a fully masked row (its output is the mean of
    V); the f32 bias as given and the f32 output; q.k of bf16 operands at
    the tensor-core peak, p.v (an f32 operand) at the f32 peak and one
    exponent, each over the (query, key) pairs so counted."""
    B, nq, h, d = q.shape
    nk, dv = k.shape[1], v.shape[3]
    if bias is None:
        seen = torch.ones((B, h, nq, nk), dtype=torch.bool, device=q.device)
    else:
        seen = (bias > -5e29).expand(B, h, nq, nk)
    seen = seen | ~seen.any(dim=-1, keepdim=True)
    pairs, keys = int(seen.sum()), int(seen.any(dim=2).sum())
    nbytes = ((q[..., 0].numel() * d + keys * (d + dv)) * q.element_size()
              + (0 if bias is None else bias.numel() * 4) + B * nq * h * dv * 4)
    qk_flops, pv_flops = 2.0 * pairs * d, 2.0 * pairs * dv
    return unit_bound(nbytes, bf16_flops=qk_flops, f32_flops=pv_flops, sfu_ops=pairs) + (
        qk_flops, nbytes, keys / (B * h * nk))


def fused_attention_phase(device, s):
    """ops.fused_attention against its plain version at every case of
    ``fused_attention_cases`` (within FUSED_ATOL; the fully masked rows
    finite and uniform; the edge cases also through the tile that their nq
    does not choose), then its time at the encoder and the two step shapes
    beside its bound, the plain version's and SDPA's on f32 copies with the
    same float mask, and the DECODE/MMA crossover over nq."""
    from openviic_tpu_torch.ops import fused_attention as fa

    fused_attention, fused_attention_reference = fa.fused_attention, fa.fused_attention_reference
    gen = torch.Generator().manual_seed(4)
    worst = 0.0
    cases = fused_attention_cases(gen, s, device)
    forced = {"nq 1, nk 200": fa.MMA, "nq 1, nk 300": fa.MMA, "nq 65, nk 200": fa.DECODE,
              "unaligned bf16 encoder": fa.DECODE, "unaligned bf16 step": fa.MMA}
    for name, q, k, v, bias in cases:
        tiles = [None] + ([forced[name]] if name in forced else [])
        want = fused_attention_reference(q, k, v, bias)
        for tile in tiles:
            err, got = check_fused_attention(name, q, k, v, bias, device, tile, want)
            detail = ""
            if name == "ragged f32":
                uniform = v[3].float().mean(dim=0, keepdim=True).expand_as(got[3])
                u_err = (got[3] - uniform).abs().max().item()
                if u_err > FUSED_ATOL:
                    raise AssertionError(f"fused_attention: a fully masked row is not uniform "
                                         f"(max |err| {u_err:.3g} against the mean of v)")
                detail = f"; fully masked rows finite and uniform (max |err| {u_err:.3g})"
            worst = max(worst, err)
            used = fa.resolve_tile(q.shape[1], q.dtype, tile)
            log(f"  fused_attention {name} ({fa.TILE_NAMES[used]} tile): q {tuple(q.shape)} "
                f"{str(q.dtype)[6:]}, nk {k.shape[1]}, bias "
                f"{None if bias is None else tuple(bias.shape)}: max |err| {err:.3g}{detail}")
    if device.type != "cuda":
        return None

    rows = {}
    for name, q, k, v, bias in cases[:3]:
        qf, kf, vf = (t.float().transpose(1, 2).contiguous() for t in (q, k, v))

        def library():  # SDPA in f32 with the same float mask; timed here only
            return torch.nn.functional.scaled_dot_product_attention(qf, kf, vf, attn_mask=bias)

        ms = time_cuda(lambda: fused_attention(q, k, v, bias), 50, graph=True)
        plain_ms = time_cuda(lambda: fused_attention_reference(q, k, v, bias), 10, graph=True)
        library_ms = time_cuda(library, 50, graph=True)
        costs = host_costs(lambda: fused_attention(q, k, v, bias), 50)
        lib_err = (library().transpose(1, 2) - fused_attention(q, k, v, bias)).abs().max().item()
        bound_ms, bound_by, times, flops, nbytes, seen = attention_bound(q, k, v, bias)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms, **costs)
        log(f"  fused_attention at the {name} shape {tuple(q.shape)}, nk {k.shape[1]} "
            f"({fa.TILE_NAMES[fa.choose_tile(q.shape[1], q.dtype)]} tile): kernel {ms:.4f} ms "
            f"(launched from Python: {costs['launch_ms']:.4f} ms, host {costs['host_ms']:.4f} "
            f"ms per call), plain {plain_ms:.4f} ms, SDPA f32 {library_ms:.4f} ms (max |diff| "
            f"{lib_err:.3g}), bound {bound_ms:.4f} ms ({bound_by}; {bound_detail(times)}; "
            f"{flops / 1e9:.3f} GFLOP q.k, {nbytes / 1e6:.2f} MB with {seen:.3f} of the keys "
            f"seen)")

    # the DECODE/MMA crossover: the encoder's images, heads and keys, nq queries
    _, q, k, v, bias = cases[0]
    cells, crossover = [], None
    for nq in CROSSOVER_NQ:
        qn = q[:, :1].expand(-1, nq, -1, -1).contiguous()
        t_dec = time_cuda(lambda: fused_attention(qn, k, v, bias, tile=fa.DECODE), 20, graph=True)
        t_mma = time_cuda(lambda: fused_attention(qn, k, v, bias, tile=fa.MMA), 20, graph=True)
        cells.append(f"nq {nq}: decode {t_dec:.4f} / mma {t_mma:.4f} ms")
        if t_dec <= t_mma:
            crossover = nq
    log(f"  fused_attention tiles over nq at {tuple(k.shape)} keys: {'; '.join(cells)}; decode "
        f"wins up to nq {crossover}; the port's DECODE_MAX_NQ is {fa.DECODE_MAX_NQ}")

    enc = rows["encoder"]
    return entry("fused_attention", "openviic_tpu_torch/csrc/fused_attention.cu",
                 "openviic_tpu/ops/pallas_attention.py:164", worst, enc["ms"],
                 enc["plain_ms"], enc["bound_ms"], enc["bound_by"], enc["library_ms"],
                 launch_ms=enc["launch_ms"], host_ms=enc["host_ms"],
                 step_self=rows["step self"], step_cross=rows["step cross"])


def pixel_boxes(gen, bs, n, live):
    """(bs, n, 4) f32 boxes in pixels of a 640 x 480 image, zero past each
    image's ``live`` regions (as the pipeline pads them)."""
    x0 = torch.rand((bs, n), generator=gen) * 600
    y0 = torch.rand((bs, n), generator=gen) * 440
    w = 8 + torch.rand((bs, n), generator=gen) * (640 - x0 - 8)
    hh = 8 + torch.rand((bs, n), generator=gen) * (480 - y0 - 8)
    boxes = torch.stack([x0, y0, x0 + w, y0 + hh], dim=-1)
    return boxes * (torch.arange(n)[None] < live[:, None])[..., None]


def geo_library(q, k, v, boxes, wg, bg, mask, scale):
    """The materialised path the geometry kernel replaces, as one yardstick:
    the box embedding, fc_gs and SDPA with the f32 bias (timed only)."""
    from openviic_tpu_torch.models.geometry import box_relational_embedding

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        emb = box_relational_embedding(boxes.float(), dim_g=wg.shape[0])
        wts = torch.relu(emb @ wg.float() + bg.float()).permute(0, 3, 1, 2)
        bias = torch.log(torch.clamp_min(wts, 1e-6)) + mask_bias(mask)
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias.to(q.dtype), scale=scale)
    return library


def geo_bound(q, dim_g: int) -> dict:
    """The geometry kernel's work on q (bs, n, h, d) at ``dim_g``: its bf16
    products (q.k and p.v), the f32 fold of the sin/cos planes, the
    transcendentals (sin/cos, the displacements' logs, each bias's log and
    exp) and the bytes (q, k, v, out; boxes and mask); ``unit_bound``'s
    bound of them."""
    bs, n, h, d = q.shape
    pairs = bs * n * n
    work = dict(mma=2.0 * pairs * h * 2 * d, fold=2.0 * pairs * h * 2 * 4 * (dim_g // 8),
                sincos=pairs * 2 * 4 * (dim_g // 8),
                nbytes=4 * bs * n * h * d * q.element_size() + bs * n * (4 * 4 + 1))
    work["sfu"] = work["sincos"] + pairs * (2 + 2 * h)
    work["bound_ms"], work["bound_by"], work["times"] = unit_bound(
        work["nbytes"], bf16_flops=work["mma"], f32_flops=work["fold"], sfu_ops=work["sfu"])
    return work


def geo_attention_phase(device, s):
    """ops.geo_fused_attention against its plain version at the ORT encoder
    shape (images x regions padded to 8, the trig embedding's dim_g =
    d_model / heads), a ragged shape (7 images, n = 13, f32), n 16 rows
    longer than the encoder's (the MMA kernel past 64 rows: its 8-warp,
    128-key instance, one slab per phase), the encoder shape with bf16
    boxes (the kernel's own bf16 geometry rows) and n = 160 (the SIMT
    kernel): within
    GEO_ULPS bf16 ulps on GEO_SHARE of the elements and GEO_ATOL
    everywhere; then its time beside its bound, the plain version's and the
    composite of box_relational_embedding + fc_gs + SDPA with the
    materialised bias."""
    from openviic_tpu_torch.ops.geo_attention import (
        geo_fused_attention, geo_fused_attention_reference, kernel_route)

    gen = torch.Generator().manual_seed(5)
    h, D = s["heads"], s["d_model"]
    d, n = D // h, -(-s["n_regions"] // 8) * 8
    dim_g = d
    bound_g = (6.0 / (dim_g + 1)) ** 0.5  # _per_head_xavier
    worst, timed_case = 0.0, None
    for bs, nn_, dtype, box_dtype in ((s["batch"], n, torch.bfloat16, torch.float32),
                                      (7, 13, torch.float32, torch.float32),
                                      (40, n + 16, torch.bfloat16, torch.float32),
                                      (s["batch"], n, torch.bfloat16, torch.bfloat16),
                                      (20, 160, torch.bfloat16, torch.float32)):
        most = min(nn_, s["n_regions"])
        live = torch.randint(min(nn_ // 2, most), most + 1, (bs,), generator=gen)
        boxes = pixel_boxes(gen, bs, nn_, live).to(device, box_dtype)
        mask = (torch.arange(nn_)[None] >= live[:, None]).reshape(bs, 1, 1, nn_).to(device)
        q, k, v = (torch.randn((bs, nn_, h, d), generator=gen).to(device, dtype) for _ in range(3))
        wg = ((torch.rand((dim_g, h), generator=gen) * 2 - 1) * bound_g).to(device)
        bg = (0.1 * torch.randn((h,), generator=gen)).to(device)
        args = (q, k, v, boxes, wg, bg, mask, 1.0 / d ** 0.5)
        got = geo_fused_attention(*args)
        want = geo_fused_attention_reference(*args)
        sync(device)
        err, ulps, share = ulp_errors(got, want)
        beyond = float(((got.float() - want.float()).abs()
                        > GEO_ULPS * bf16_ulp(want.float().abs().clamp_min(ULP_FLOOR))).float().mean())
        if (got.dtype != q.dtype or not torch.isfinite(got).all() or err > GEO_ATOL
                or beyond > 1 - GEO_SHARE):
            raise AssertionError(f"geo_fused_attention bs={bs} n={nn_}: max |err| {err:.3g}, "
                                 f"{beyond:.4f} of the elements beyond {GEO_ULPS} bf16 ulps")
        worst = max(worst, err)
        route = (kernel_route(*(t.to(torch.bfloat16) for t in (q, k, v)), dim_g // 8)
                 if device.type == "cuda" else "plain")
        log(f"  geo_fused_attention bs={bs} n={nn_} h={h} dk={d} dim_g={dim_g} "
            f"{str(dtype)[6:]}, {str(box_dtype)[6:]} boxes (route {route}): max |err| "
            f"{err:.3g} = {ulps:.2f} bf16 ulps, {share:.2e} beyond 1 ulp, {beyond:.2e} beyond "
            f"{GEO_ULPS}")
        if timed_case is None:
            timed_case = args
    if device.type != "cuda":
        return None
    q = timed_case[0]
    library = geo_library(*timed_case)
    ms = time_cuda(lambda: geo_fused_attention(*timed_case), 20, graph=True)
    plain_ms = time_cuda(lambda: geo_fused_attention_reference(*timed_case), 3, graph=True)
    library_ms = time_cuda(library, 20, graph=True)
    costs = host_costs(lambda: geo_fused_attention(*timed_case), 20)
    work = geo_bound(q, dim_g)
    mma, fold, sfu, sincos, nbytes = (work[k] for k in ("mma", "fold", "sfu", "sincos", "nbytes"))
    bound_ms, bound_by, times = work["bound_ms"], work["bound_by"], work["times"]
    log(f"  geo_fused_attention at {tuple(q.shape)}: kernel {ms:.4f} ms (launched from Python: "
        f"{costs['launch_ms']:.4f} ms, host {costs['host_ms']:.4f} ms per call), plain "
        f"{plain_ms:.4f} ms, embedding+fc_gs+SDPA {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; "
        f"{bound_detail(times)}; {mma / 1e9:.2f} GFLOP bf16 at 989 TFLOP/s, {fold / 1e9:.2f} "
        f"GFLOP f32 at 67 TFLOP/s, {sfu / 1e6:.1f} M transcendentals ({sincos / 1e6:.1f} M "
        f"sin/cos) at {PEAK_SFU_OPS / 1e12:.2f} T/s (16 per SM per clock, 132 SMs, 1.98 GHz), "
        f"{nbytes / 1e6:.2f} MB at 3.35 TB/s)")
    return entry("geo_fused_attention", "openviic_tpu_torch/csrc/geo_attention.cu",
                 "openviic_tpu/ops/geo_attention.py:134", worst, ms, plain_ms, bound_ms,
                 bound_by, library_ms, **costs)


def head_large_k_phase(device, s):
    """head_topk at k = 32 and k = 128 (the shared-memory lists) against its
    plain version at the decode rows (exact and gaussian inputs) and the
    first step's rows (gaussian), with the kernel's device time at each."""
    from openviic_tpu_torch.ops.head_topk import head_topk

    gen = torch.Generator().manual_seed(6)
    D, V = s["d_model"], s["vocab"]
    worst = 0.0
    for k in (32, 128):
        k = min(k, V - 1)
        for N in (s["batch"] * s["beam"], s["batch"]):
            if N > s["batch"]:
                compare(f"k={k}, exact inputs", *exact_inputs(gen, N, D, V, device), k,
                        exact=True)
            x, w = gaussian_inputs(gen, N, D, V, device)
            err, _ = compare(f"k={k}, gaussian inputs", x, w, k, exact=False)
            worst = max(worst, err)
            if device.type == "cuda":
                log(f"  head_topk k={k} at N={N}: "
                    f"{time_cuda(lambda: head_topk(x, w, k), 10, graph=True):.4f} ms")
    return worst


GATE_BEAMS = (1, 3, 5, 8, 16)  # 16: the largest k of the register lists


def head_gate_phase(device, s):
    """One beam-resident selection step both ways at each (rows, beam): the
    head kernel + ``_finish_select`` against fast select (the head's raw
    logits, their logsumexp and ``_select_topk_hier``), at images x beam
    rows (the row count rounded down to a multiple of the beam).  Prints
    the times and, per beam, the crossover: the fewest rows from which the
    kernel wins at every larger row count measured."""
    from openviic_tpu_torch.decoding.beam_search import (
        _finish_select, _head_kernel_wins, _select_topk_hier)
    from openviic_tpu_torch.ops.head_topk import head_topk

    gen = torch.Generator().manual_seed(7)
    D, V = s["d_model"], s["vocab"]
    w = gaussian_inputs(gen, 1, D, V, device)[1]
    row_counts = ((1, 2, 4, 8, 16, 24, 40, 80, 160, 320, 480, 960, 1600, 3200)
                  if device.type == "cuda"
                  else (16, 32))
    table = {}
    for beam in GATE_BEAMS:
        for nominal in row_counts:
            b_s = nominal // beam
            if b_s < 1:
                continue
            x = gaussian_inputs(gen, b_s * beam, D, V, device)[0]
            seq = torch.randn((b_s, beam), generator=gen).to(device) * 5
            fin = torch.zeros((b_s, beam), dtype=torch.bool, device=device)

            def kernel():
                vals, idxs, lse = head_topk(x, w, beam)
                lse = lse.reshape(b_s, beam)
                return _finish_select(vals.reshape(b_s, beam, beam),
                                      idxs.long().reshape(b_s, beam, beam),
                                      seq - lse, fin, seq, beam)

            def fast():
                logits = torch.nn.functional.linear(x, w).float()
                lse = torch.logsumexp(logits, dim=-1).reshape(b_s, beam)
                return _select_topk_hier(logits.reshape(b_s, beam, V), seq - lse, fin, seq, beam)

            if device.type == "cuda":
                table[beam, b_s * beam] = (time_cuda(kernel, 20), time_cuda(fast, 20))
            else:
                kernel(), fast()
                table[beam, b_s * beam] = (0.0, 0.0)
    if device.type != "cuda":
        return table
    log("  selection step, ms (kernel + _finish_select / fast select), NVIDIA H100 per run:")
    for beam in GATE_BEAMS:
        rows = sorted(r for b, r in table if b == beam)
        cells = [f"{r}: {table[beam, r][0]:.4f}/{table[beam, r][1]:.4f}" for r in rows]
        wins = [table[beam, r][0] < table[beam, r][1] for r in rows]
        cross = next((r for i, r in enumerate(rows) if all(wins[i:])), None)
        gate = [r for r in rows if _head_kernel_wins(r // beam, beam)]
        log(f"  beam {beam}: {'; '.join(cells)}; kernel wins from "
            f"{cross if cross is not None else 'no row count measured'}; the port's gate "
            f"takes the kernel at {gate or 'none'}")
    return table


# ---------------------------------------------------------------- phase 9
# the JAX package's test CIDEr of the trained artifact, measured on a TPU
# at bf16 with its head kernel (BENCH_r05.json, trained_test_cider)
JAX_TPU_TRAINED_CIDER = 0.1162
TRAINED_STEPS = (0, 12, 29)  # the decode steps whose kernel inputs are captured
F32_AGREEMENT_MIN = 0.99  # the f32 decode on the card against the card host's CPU
F32_CIDER_ATOL = 0.002
HEAD_AGREEMENT_MIN = 0.99  # the head kernel against fast select (JAX: 100%)
TRAINED_TIMED = 3  # decodes timed per path (host-bound: the median is kept)
# the resident kernel, the fused step and OPENVIIC_PALLAS against their eager
# bf16 twins: the JAX package's own such paths agree with theirs on 87.5%,
# 84.4% and 93.8% of the artifact's first 32 images at bf16 on the CPU
# (tests/test_torch_port_trained_agreement.py; near-tied beams flip under
# any change of rounding), so AGREEMENT_MIN (95%) stands for the attention
# kernel only
TRAINED_AGREEMENT_MIN = 0.80


def trained_config(head_kernel=False, attn_kernel=False):
    """The artifact's config with the pipeline's decode switches."""
    from openviic_tpu_torch.artifact import artifact_config
    from openviic_tpu_torch.config import ConfigNode

    cfg = artifact_config().to_dict()
    cfg["TRAINING"].update(DECODE_HEAD_KERNEL=head_kernel, DECODE_ATTN_KERNEL=attn_kernel)
    return ConfigNode(cfg)


@contextlib.contextmanager
def capture_calls(module, name: str, every: int, first: int = 0):
    """Wrap ``module.<name>`` (a kernel wrapper as a model module calls it):
    copies of the arguments of calls first, first + every, first + 2 *
    every, ... (one a decode step), kept by step for TRAINED_STEPS and for
    the last step run (key "last": (step, call))."""
    real = getattr(module, name)
    calls, kept = [0], {}

    def clone(a):
        if isinstance(a, torch.Tensor):
            out = torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device=a.device)
            return out.copy_(a)  # with the caller's strides
        if isinstance(a, dict):
            return {k: clone(v) for k, v in a.items()}
        if isinstance(a, (tuple, list)):
            return type(a)(clone(v) for v in a)
        return a

    def wrapper(*args, **kwargs):
        n = calls[0] - first
        calls[0] += 1
        if n >= 0 and n % every == 0:
            call = (clone(args), clone(kwargs))
            if n // every in TRAINED_STEPS:
                kept[n // every] = call
            kept["last"] = (n // every, call)
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield kept
    finally:
        setattr(module, name, real)


def captured_steps(kept):
    """{step: (args, kwargs)} at TRAINED_STEPS, the last step run standing in
    for a later one the decode did not reach (early exit)."""
    if "last" not in kept:
        raise AssertionError("the decode made no call of a kernel it should have launched")
    last_t, last_call = kept["last"]
    out = {t: kept[t] for t in TRAINED_STEPS if t in kept}
    if TRAINED_STEPS[-1] not in out:
        out[last_t] = last_call
    return out


def trained_kernel_cases(device, captured, what="trained decode"):
    """Each kernel on its own inputs captured from the artifact decode
    (``what``; the kernels of ``captured``'s keys), against its plain
    version under its gate, and timed beside its bound (on the card).
    Returns {kernel: [rows]}."""
    from openviic_tpu_torch.ops.beam_select_attention import (
        ancestor_rows, beam_select_attention, beam_select_attention_reference)
    from openviic_tpu_torch.ops.fused_attention import fused_attention, fused_attention_reference
    from openviic_tpu_torch.ops.fused_decoder_step import (
        fused_layer_step, fused_layer_step_reference)
    from openviic_tpu_torch.ops.head_topk import head_topk, head_topk_reference
    from openviic_tpu_torch.ops.resident_layer_step import (
        resident_layer_step, resident_layer_step_reference)

    cuda = device.type == "cuda"
    rows, failures = {}, []

    @contextlib.contextmanager
    def case():  # every case runs; the first failure is raised at the end
        try:
            yield
        except AssertionError as exc:
            log(f"  FAILED: {exc}")
            failures.append(exc)

    def row(kernel, label, err, fn, plain, bound_ms, bound_by, library=None, **extra):
        r = dict(case=label, max_abs_err=err, **extra)
        if cuda:
            r.update(ms=time_cuda(fn, 20, graph=True), plain_ms=time_cuda(plain, 5, graph=True),
                     bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=None if library is None else time_cuda(library, 20, graph=True))
            lib = "" if library is None else f", library {r['library_ms']:.4f} ms"
            log(f"  {kernel} {label}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
                f"{lib}, bound {bound_ms:.4f} ms ({bound_by})")
        rows.setdefault(kernel, []).append(r)

    def steps_of(key):
        return captured_steps(captured[key]).items() if key in captured else ()

    for t, ((x, w, k), _) in steps_of("head_topk"):
        with case():
            err, _ = compare(f"head_topk, {what} t={t}", x, w, k, exact=False)
            bound_ms, bound_by, _, _ = head_bound(x.shape[0], x.shape[1], w.shape[0], k)
            row("head_topk", f"t={t} N={x.shape[0]} V={w.shape[0]}", err,
                lambda: head_topk(x, w, k), lambda: head_topk_reference(x, w, k),
                bound_ms, bound_by)

    for t, (args, kwargs) in steps_of("beam_select_attention"):
        with case():
            axis = kwargs.get("mask_axis", args[5] if len(args) > 5 else "q")
            args = args[:5]
            err = check_beam_select(f"{what} t={t}", args, axis, device)
            q, kc, _, anc, mask = args
            N, L = kc.shape[:2]
            pos = torch.arange(L, device=device)
            pm = mask.reshape(N, L)
            src = ancestor_rows(anc)
            live = ~(pm[src, pos] if axis == "p" else pm)
            nbytes, flops = beam_select_work(N, L, q.shape[2], q.shape[3],
                                             distinct_rows(src * L + pos, live), int(live.sum()))
            bound_ms, bound_by = bound(flops, PEAK_F32_FLOPS, nbytes)
            row("beam_select_attention", f"t={t} N={N} L={L}", err,
                lambda: beam_select_attention(*args, mask_axis=axis),
                lambda: beam_select_attention_reference(*args, mask_axis=axis), bound_ms, bound_by)

    for t, (args, kwargs) in steps_of("resident_layer_step"):
        with case():
            step_args, (t_arg, weights) = args[:9], args[9:11]
            h = kwargs["n_heads"]
            err, detail = check_resident_step(f"resident_layer_step, {what} t={t}",
                                              step_args, t_arg, weights, h, device)
            N, L = step_args[1].shape[:2]
            log(f"  resident_layer_step, {what} t={t} N={N} L={L} "
                f"M={step_args[3].shape[1]}: {detail}")
            bound_ms, bound_by, _, _ = layer_step_bound(
                True, t_arg, weights, N, step_args[6].reshape(N, L),
                step_args[7].reshape(step_args[7].shape[0], -1), anc=step_args[5])
            row("resident_layer_step", f"t={t} N={N} L={L}", err,
                lambda: resident_layer_step(*step_args, t_arg, weights, h),
                lambda: resident_layer_step_reference(*step_args, t_arg, weights, h),
                bound_ms, bound_by)

    for t, (args, kwargs) in steps_of("fused_layer_step"):
        with case():
            x, k0, v0, ck, cv, smask, cmask, t_arg, weights = args[:9]
            h = kwargs["n_heads"]
            ins = (x, ck, cv, smask, cmask)
            err, detail = check_fused_step(f"fused_layer_step, {what} t={t}", ins, k0, v0,
                                           t_arg, weights, h, device)
            N, L = k0.shape[:2]
            log(f"  fused_layer_step, {what} t={t} N={N} L={L} M={ck.shape[1]}: {detail}")
            bound_ms, bound_by, _, _ = layer_step_bound(False, t_arg, weights, N, smask, cmask)
            kk, vk = k0.clone(), v0.clone()
            row("fused_layer_step", f"t={t} N={N} L={L}", err,
                lambda: fused_layer_step(x, kk, vk, ck, cv, smask, cmask, t_arg, weights, h),
                lambda: fused_layer_step_reference(x, kk, vk, ck, cv, smask, cmask, t_arg,
                                                   weights, h), bound_ms, bound_by)

    attention_calls = [(label, captured[key][0]) for key, label in (
        ("fused_attention_encoder", "encoder"),
        ("fused_attention_table", "language-model table 1 x 1")) if key in captured]
    for part in ("self", "cross"):
        attention_calls += [(f"step {part} t={t}", call)
                            for t, call in steps_of(f"fused_attention_{part}")]
    for label, (args, kwargs) in attention_calls:
        with case():
            q, k, v = args[:3]
            bias, scale = kwargs.get("bias"), kwargs.get("sm_scale")
            err, _ = check_fused_attention(f"{what} {label}", q, k, v, bias, device)
            log(f"  fused_attention, {what} {label}: q {tuple(q.shape)}, nk {k.shape[1]}: "
                f"max |err| {err:.3g}")
            bound_ms, bound_by = attention_bound(q, k, v, bias)[:2]
            qf, kf, vf = (t.float().transpose(1, 2).contiguous() for t in (q, k, v))

            def library(qf=qf, kf=kf, vf=vf, bias=bias, scale=scale):  # SDPA f32, timed only
                return torch.nn.functional.scaled_dot_product_attention(
                    qf, kf, vf, attn_mask=bias, scale=scale)
            row("fused_attention", f"{label} q {tuple(q.shape)} nk {k.shape[1]}", err,
                lambda: fused_attention(q, k, v, bias=bias, sm_scale=scale),
                lambda: fused_attention_reference(q, k, v, bias, scale), bound_ms, bound_by,
                library=library)
    if failures:
        raise failures[0]
    return rows


def trained_phase(device, s, card: str, loaded):
    """The committed trained flagship (saved_models/realistic_d512_bench/:
    vocab 7 094, max_len 30, 150 test images of up to 40 regions) decoded
    at beam 5 through CaptioningPipeline.caption_features: at f32 on the
    card (TF32 off) and on the card host's CPU (>= F32_AGREEMENT_MIN of the
    captions identical, CIDEr within F32_CIDER_ATOL); at bf16 through every
    decode path of the flagship: eager fast select, serve (head kernel),
    (a) attention kernel, (b) resident kernel, (c) non-resident with and
    without OPENVIIC_FUSED_STEP=1, (d) and (e) OPENVIIC_PALLAS=1.  Each
    path's launches are counted from zero and gated; its CIDEr, agreement
    with the eager bf16 path and captions/s (CUDA events, after a warm-up)
    are printed; the head kernel must agree with fast select on >=
    HEAD_AGREEMENT_MIN of the images, the attention kernel with eager bf16
    on >= AGREEMENT_MIN, the other kernel paths with their eager bf16 twin
    (the non-resident eager path for (c) and (e)) on >=
    TRAINED_AGREEMENT_MIN, the bar the JAX package's own paths meet.  Each
    kernel is then held against its plain version on its own inputs
    captured at t = 0, 12 and 29 (the last step run, where the decode ends
    earlier) and timed.  The CPU rehearsal decodes the first image for
    REHEARSAL_MAX_LEN steps (``rehearsal_artifact``)."""
    import importlib

    from openviic_tpu_torch import artifact
    from openviic_tpu_torch.decoding import BeamSearcher
    from openviic_tpu_torch.models import attention as attention_module
    from openviic_tpu_torch.models import decoders as decoders_module
    from openviic_tpu_torch.serving import CaptioningPipeline

    # the module, not the function the package exports under its name
    beam_search_module = importlib.import_module("openviic_tpu_torch.decoding.beam_search")

    cuda = device.type == "cuda"
    vocab, state, refs = loaded["vocab"], loaded["state_dict"], loaded["refs"]
    n_images = len(loaded["ids"]) if cuda else 1
    ids = loaded["ids"][:n_images]
    images = [{"region_features": f} for f in loaded["feats"][:n_images]]
    beam = 5

    def pipeline(dev, bf16=True, **flags):
        return CaptioningPipeline.from_state_dict(trained_config(**flags), vocab,
                                                  state_dict=state, beam_size=beam,
                                                  batch_size=n_images, use_bf16=bf16, device=dev)

    def cider(captions):
        return artifact.artifact_cider(captions, ids, refs)

    # f32: the card against the card host's CPU
    f32_card = pipeline(device, bf16=False).caption_features(images)
    # (the rehearsal's "card" is the CPU)
    f32_cpu = pipeline("cpu", bf16=False).caption_features(images) if cuda else f32_card
    f32_same = float(np.mean([a == b for a, b in zip(f32_card, f32_cpu)]))
    c_card, c_cpu = cider(f32_card), cider(f32_cpu)
    log(f"  f32 decode of {n_images} images, beam {beam}: captions identical on the card and "
        f"its host's CPU {f32_same:.4f}; CIDEr {c_card:.4f} (card) / {c_cpu:.4f} (CPU)")
    if f32_same < F32_AGREEMENT_MIN or abs(c_card - c_cpu) > F32_CIDER_ATOL:
        raise AssertionError(f"f32 card against CPU: {f32_same:.4f} identical (< "
                             f"{F32_AGREEMENT_MIN}?), CIDEr gap {abs(c_card - c_cpu):.4f} (> "
                             f"{F32_CIDER_ATOL}?)")

    eager_pipe = pipeline(device)
    serve_pipe = pipeline(device, head_kernel=1)
    attn_pipe = pipeline(device, head_kernel=1, attn_kernel=True)
    model = serve_pipe.model
    n_layers = len(model.decoder.layers)
    counted = counted_wrappers()

    def searched(searcher):
        def decode():
            outputs, _ = searcher(serve_pipe._batch(images), beam)
            ids_ = outputs[:n_images].cpu().numpy()
            return vocab.decode_caption(ids_), ids_
        return decode

    def served(pipe):
        return lambda: pipe.caption_features(images, return_ids=True)

    paths = [  # name, searcher, decode, launches per step, per request, env flag
        ("eager fast select", eager_pipe.searcher, served(eager_pipe), {}, {}, None),
        ("serve (head kernel)", serve_pipe.searcher, served(serve_pipe), {"head_topk": 1}, {},
         None),
        ("(a) attention kernel", attn_pipe.searcher, served(attn_pipe),
         {"head_topk": 1, "beam_select_attention": n_layers}, {}, None),
    ]
    resident = BeamSearcher(model, torch.bfloat16, head_kernel=1, resident_kernel=True)
    paths.append(("(b) resident kernel", resident, searched(resident),
                  {"head_topk": 1, "resident_layer_step": n_layers}, {}, None))
    fused = BeamSearcher(model, torch.bfloat16, beam_resident=False)
    paths.append(("(c) non-resident, OPENVIIC_FUSED_STEP=1", fused, searched(fused),
                  {"fused_layer_step": n_layers}, {}, "OPENVIIC_FUSED_STEP"))
    paths.append(("(c) non-resident, no step kernel", fused, searched(fused), {}, {}, None))
    paths.append(("(d) OPENVIIC_PALLAS=1, served", serve_pipe.searcher, served(serve_pipe),
                  {"head_topk": 1}, {"fused_attention": n_layers}, "OPENVIIC_PALLAS"))
    paths.append(("(e) OPENVIIC_PALLAS=1, non-resident", fused, searched(fused),
                  {"fused_attention": 2 * n_layers}, {"fused_attention": n_layers},
                  "OPENVIIC_PALLAS"))
    # the kernel inputs each path captures in its warm-up decode
    captures = {
        "serve (head kernel)": [("head_topk", beam_search_module, "head_topk", 1, 0)],
        "(a) attention kernel": [("beam_select_attention", attention_module,
                                  "beam_select_attention", n_layers, 0)],
        "(b) resident kernel": [("resident_layer_step", decoders_module,
                                 "resident_layer_step", n_layers, 0)],
        "(c) non-resident, OPENVIIC_FUSED_STEP=1": [
            ("fused_layer_step", decoders_module, "fused_layer_step", n_layers, 0)],
        "(d) OPENVIIC_PALLAS=1, served": [
            ("fused_attention_encoder", attention_module, "fused_attention", 10 ** 9, 0)],
        "(e) OPENVIIC_PALLAS=1, non-resident": [
            ("fused_attention_self", attention_module, "fused_attention", 2 * n_layers,
             n_layers),
            ("fused_attention_cross", attention_module, "fused_attention", 2 * n_layers,
             n_layers + 1)],
    }

    results, captured = {}, {}

    def capturing(name):
        stack = contextlib.ExitStack()
        captured.update({key: stack.enter_context(capture_calls(mod, attr, every, first))
                         for key, mod, attr, every, first in captures.get(name, [])})
        return stack

    for name, searcher, decode, per_step, per_request, flag in paths:
        with env_flag(flag) if flag else contextlib.nullcontext():
            if cuda:
                with capturing(name):
                    decode()  # warm-up, and the kernels' inputs
            sync(device)
            for fn in counted:
                fn.launches = 0
            steps0 = searcher.steps
            if cuda:  # the median of TRAINED_TIMED decodes
                times = []
                for _ in range(TRAINED_TIMED):
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    captions, out_ids = decode()
                    end.record()
                    sync(device)
                    times.append(start.elapsed_time(end) / 1e3)
                seconds = float(np.median(times))
            else:  # the rehearsal decodes once, capturing
                with capturing(name):
                    captions, out_ids = decode()
                seconds = float("nan")
        steps = searcher.steps - steps0
        launches = {fn.__name__: fn.launches for fn in counted}
        want = {fn.__name__: (per_step.get(fn.__name__, 0) * steps
                              + per_request.get(fn.__name__, 0) * TRAINED_TIMED if cuda else 0)
                for fn in counted}
        if steps <= 0 or launches != want:
            raise AssertionError(f"trained {name}: launches {launches} over {steps} steps, "
                                 f"expected {want}")
        if out_ids.shape != (n_images, vocab.max_caption_length) or out_ids.max() >= len(vocab):
            raise AssertionError(f"trained {name}: ids {out_ids.shape}, max {out_ids.max()}")
        results[name] = dict(captions=captions, cider=cider(captions), seconds=seconds,
                             steps=steps // (TRAINED_TIMED if cuda else 1),
                             launches={k: v for k, v in launches.items() if v})

    eager = results["eager fast select"]["captions"]
    for name, r in results.items():
        r["agreement"] = float(np.mean([a == b for a, b in zip(r["captions"], eager)]))
        log(f"  trained bf16 {name}: CIDEr {r['cider']:.4f}, captions identical to eager bf16 "
            f"{r['agreement']:.4f}, {n_images / r['seconds']:.1f} captions/s on {card} "
            f"({r['seconds'] * 1e3:.1f} ms for {n_images} images, {r['steps']} steps); launches "
            f"{r['launches']}")
    nr = results["(c) non-resident, no step kernel"]["captions"]
    for name in ("(c) non-resident, OPENVIIC_FUSED_STEP=1", "(e) OPENVIIC_PALLAS=1, non-resident"):
        r = results[name]
        r["agreement_non_resident"] = float(np.mean([a == b for a, b in zip(r["captions"], nr)]))
        log(f"  trained bf16 {name} against the eager non-resident path: captions identical "
            f"{r['agreement_non_resident']:.4f}")
    log(f"  trained CIDEr: f32 {c_card:.4f}, bf16 eager {results['eager fast select']['cider']:.4f}"
        f", bf16 head kernel {results['serve (head kernel)']['cider']:.4f}; the JAX package's, "
        f"measured on a TPU at bf16 with its head kernel (BENCH_r05.json): "
        f"{JAX_TPU_TRAINED_CIDER}")
    cases = trained_kernel_cases(device, captured)
    # each kernel path against its eager bf16 twin (beam-resident fast
    # select, or the non-resident eager path); on the card only: the
    # rehearsal's one image cannot carry a share
    for name, r in results.items():
        if not cuda or name in ("eager fast select", "(c) non-resident, no step kernel"):
            continue
        bar = {"serve (head kernel)": HEAD_AGREEMENT_MIN,
               "(a) attention kernel": AGREEMENT_MIN}.get(name, TRAINED_AGREEMENT_MIN)
        same = r.get("agreement_non_resident", r["agreement"])
        if same < bar:
            raise AssertionError(f"trained bf16 {name}: captions identical to its eager bf16 "
                                 f"twin {same:.4f} < {bar}")
    return dict(paths={k: {key: v for key, v in r.items() if key != "captions"}
                       for k, r in results.items()},
                f32=dict(card_cider=c_card, cpu_cider=c_cpu, agreement=f32_same), kernels=cases,
                f32_captions=f32_card)


# ---------------------------------------------------------------- serving cell
# the flagship served from a checkpoint at serve.py's batch and the tuned
# twin's EVALUATING_BEAM_SIZE; 32 clients of 8 requests each, as
# scripts/bench_serve.py sends them
SERVE_CELL = dict(batch=32, beam=3, requests=256, clients=32, max_wait_ms=25)
TINY_SERVE_CELL = dict(batch=8, beam=3, requests=8, clients=2, max_wait_ms=25)
SERVE_NAME = "serving_cell"
SERVE_SEED = 3
# the patch backbone on the card against its host's CPU: the thumbnails are
# integer sums (exact in float64) and must be equal; the features are sums
# of 192 f32 products of magnitude below 0.3, whose order of summation may
# differ (within 192 ulps of a sum below 8: 1e-4), and roi_pool's weighted
# means of those features within 1e-5 of each other on the same map
EXTRACT_ATOL = 1e-4
ROI_ATOL = 1e-5
N_ARRAYS = 8  # caption_images' seeded 480 x 640 x 3 uint8 arrays
PIXEL_SHAPE = (480, 640, 3)


def serving_config(s, cell, checkpoint_path: str):
    """The serving cell's config: the flagship's model, the head kernel
    forced (1) and the beam-select attention kernel on, beam 3."""
    from openviic_tpu_torch.config import ConfigNode

    cfg = model_config(s, attn_kernel=True).to_dict()
    cfg["MODEL"]["NAME"] = SERVE_NAME
    cfg["TRAINING"].update(EVALUATING_BEAM_SIZE=cell["beam"], CHECKPOINT_PATH=checkpoint_path)
    return ConfigNode(cfg)


def write_run(run_dir: str, model, vocab=None, vocab_file=None) -> None:
    """A checkpoint directory as the trainer leaves it: ``best_model.ckpt``
    (the port's format) and ``vocab.bin`` (pickled, or copied from
    ``vocab_file``)."""
    import pickle
    import shutil

    from openviic_tpu_torch.training.checkpoint import BEST_NAME, save_checkpoint

    os.makedirs(run_dir)
    if vocab_file is not None:
        shutil.copyfile(vocab_file, os.path.join(run_dir, "vocab.bin"))
    else:
        with open(os.path.join(run_dir, "vocab.bin"), "wb") as f:
            pickle.dump(vocab, f)
    save_checkpoint(os.path.join(run_dir, BEST_NAME), model,
                    {"step": 0, "generator": torch.Generator().manual_seed(0)}, {"epoch": 0})


@contextlib.contextmanager
def without_pillow():
    """``import PIL`` raises ImportError in the block, whether or not Pillow
    is installed."""
    saved = {k: v for k, v in sys.modules.items() if k == "PIL" or k.startswith("PIL.")}
    for k in saved:
        del sys.modules[k]
    sys.modules["PIL"] = None
    try:
        yield
    finally:
        del sys.modules["PIL"]
        sys.modules.update(saved)


@contextlib.contextmanager
def quiet_port_logger():
    """The port's logger at WARNING for the block: the phase prints its own
    lines, not a line per request or checkpoint load."""
    from openviic_tpu_torch.utils import setup_logger

    logger = setup_logger()
    level = logger.level
    logger.setLevel(logging.WARNING)
    try:
        yield
    finally:
        logger.setLevel(level)


def http_post(port: int, path: str, body: bytes):
    """(status, reply JSON) of a POST to the local server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def http_get(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return json.loads(resp.read())


def serving_launches(name, counted, steps, n_layers, cuda):
    """The launch counts of a served run against the cell's decode: one
    head_topk a step, one beam_select_attention a layer and step, nothing
    else (none on the CPU, where the plain versions run)."""
    launches = {fn.__name__: fn.launches for fn in counted}
    want = dict.fromkeys(launches, 0)
    if cuda:
        want.update(head_topk=steps, beam_select_attention=n_layers * steps)
    if steps <= 0 or launches != want:
        raise AssertionError(f"{name}: launches {launches} over {steps} decode steps, "
                             f"expected {want}")
    return {k: v for k, v in launches.items() if v}


def http_phase(device, s, card: str):
    """The serving cell (``SERVE_CELL``): the flagship at full width with
    random weights from a seed, written with the port's ``save_checkpoint``
    and a pickled ``vocab.bin`` into a temporary directory and loaded by
    ``CaptioningPipeline(config, checkpoint_dir=...)``; bf16, beam 3, batch
    32, the head kernel forced and the beam-select attention kernel on.  A
    ``CaptionServer`` (port 0, max_batch 32, max_wait_ms 25) on 127.0.0.1
    takes ``/caption_features`` requests (``.npz`` payloads of 50 regions,
    made before the run) from 32 client threads, 8 each; then the same
    requests go straight into its batcher.  Every reply must equal the
    pipeline's own ``caption_features`` of the image; head_topk must launch
    once a decode step and beam_select_attention once a layer and step in
    each run; both kernels are held against their plain versions on their
    inputs captured from one served batch at t = 0, 12 and the last step; a
    pickled and a malformed body get a 400, and so does ``/caption``
    without Pillow, naming it; ``/healthz`` counts every request.  Prints
    requests/s, p50 and p99 latency and the mean batch fill."""
    import importlib
    import io
    import tempfile
    import threading

    from openviic_tpu_torch.builders import build_model
    from openviic_tpu_torch.models import attention as attention_module
    from openviic_tpu_torch.server import CaptionServer
    from openviic_tpu_torch.serving import CaptioningPipeline

    beam_search_module = importlib.import_module("openviic_tpu_torch.decoding.beam_search")
    cuda = device.type == "cuda"
    cell = SERVE_CELL if s is FLAGSHIP else TINY_SERVE_CELL
    vocab = make_vocab(s)
    with tempfile.TemporaryDirectory(prefix="openviic_serving_") as tmp:
        config = serving_config(s, cell, tmp)
        model = build_model(config.MODEL, vocab, device="cpu", seed=SERVE_SEED)
        t0 = time.perf_counter()
        write_run(os.path.join(tmp, SERVE_NAME), model, vocab=vocab)
        t1 = time.perf_counter()
        pipe = CaptioningPipeline(config, batch_size=cell["batch"], device=device)
        sync(device)
        t2 = time.perf_counter()
        ckpt_mib = os.path.getsize(os.path.join(tmp, SERVE_NAME, "best_model.ckpt")) / 2 ** 20
    log(f"  serving cell: checkpoint {ckpt_mib:.1f} MiB written in {t1 - t0:.3f} s, loaded onto "
        f"{card} by CaptioningPipeline(config, checkpoint_dir) in {t2 - t1:.3f} s; beam "
        f"{pipe.beam_size}, batch {pipe.batch_size}, {pipe.compute_dtype}")
    n_layers = len(pipe.model.decoder.layers)
    rng = np.random.default_rng(SERVE_SEED)
    feats = rng.standard_normal((cell["requests"], s["n_regions"], s["d_feature"]),
                                dtype=np.float32)
    images = [{"region_features": f} for f in feats]
    bodies = []
    for image in images:
        buf = io.BytesIO()
        np.savez(buf, **image)
        bodies.append(buf.getvalue())
    direct, direct_ids = pipe.caption_features(images, return_ids=True)  # also the warm-up
    check_outputs("serving cell, caption_features", s, vocab, [images], [(direct, direct_ids)])

    server = CaptionServer(pipe, host="127.0.0.1", port=0, max_batch=cell["batch"],
                           max_wait_ms=cell["max_wait_ms"])
    server.start()
    counted = counted_wrappers()
    sent = 0
    try:
        # one round of warm-up requests; the first batch served keeps the
        # kernels' inputs
        captured = {}
        real = pipe.caption_features

        def capturing(feature_dicts, **kwargs):
            if captured:
                return real(feature_dicts, **kwargs)
            with capture_calls(beam_search_module, "head_topk", 1) as head, \
                    capture_calls(attention_module, "beam_select_attention", n_layers) as attn:
                out = real(feature_dicts, **kwargs)
            captured.update(head_topk=head, beam_select_attention=attn)
            return out

        pipe.caption_features = capturing
        try:
            statuses = []
            warm = [threading.Thread(target=lambda i=i: statuses.append(http_post(
                server.port, "/caption_features", bodies[i])[0])) for i in range(cell["clients"])]
            for t in warm:
                t.start()
            for t in warm:
                t.join(timeout=600)
            sent += len(warm)
        finally:
            del pipe.caption_features
        if statuses != [200] * len(warm) or not captured:
            raise AssertionError(f"the warm-up requests were not served: {statuses}")

        # the timed run over HTTP
        replies, latency = [None] * len(bodies), [0.0] * len(bodies)
        errors = []
        per_client = cell["requests"] // cell["clients"]
        barrier = threading.Barrier(cell["clients"] + 1)

        def client(c):
            barrier.wait()
            for i in range(c * per_client, (c + 1) * per_client):
                t = time.perf_counter()
                status, reply = http_post(server.port, "/caption_features", bodies[i])
                latency[i] = time.perf_counter() - t
                if status != 200:
                    errors.append((i, status, reply))
                replies[i] = reply.get("caption")

        threads = [threading.Thread(target=client, args=(c,)) for c in range(cell["clients"])]
        for t in threads:
            t.start()
        stats0 = server.batcher.snapshot()
        for fn in counted:
            fn.launches = 0
        steps0 = pipe.searcher.steps
        barrier.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=900)
        http_s = time.perf_counter() - t0
        sent += len(bodies)
        if any(t.is_alive() for t in threads) or errors:
            raise AssertionError(f"HTTP run: {len(errors)} errors, first {errors[:1]}")
        http_launches = serving_launches("serving cell over HTTP", counted,
                                         pipe.searcher.steps - steps0, n_layers, cuda)
        http_steps = pipe.searcher.steps - steps0
        stats1 = server.batcher.snapshot()
        fill = (stats1["items"] - stats0["items"]) / (stats1["batches"] - stats0["batches"])
        wrong = [i for i, (a, b) in enumerate(zip(replies, direct)) if a != b]
        if wrong:
            raise AssertionError(f"HTTP run: {len(wrong)} replies differ from caption_features "
                                 f"of the same image, first {wrong[0]}: {replies[wrong[0]]!r} "
                                 f"against {direct[wrong[0]]!r}")

        # the same requests straight into the batcher
        for fn in counted:
            fn.launches = 0
        steps0 = pipe.searcher.steps
        stats0 = server.batcher.snapshot()
        t0 = time.perf_counter()
        futures = [server.batcher.submit("features", body) for body in bodies]
        got = [f.result(timeout=900) for f in futures]
        batcher_s = time.perf_counter() - t0
        sent += len(bodies)
        batcher_launches = serving_launches("serving cell into the batcher", counted,
                                            pipe.searcher.steps - steps0, n_layers, cuda)
        stats1 = server.batcher.snapshot()
        batcher_fill = (stats1["items"] - stats0["items"]) / (stats1["batches"] - stats0["batches"])
        if got != direct:
            raise AssertionError("the batcher's captions differ from caption_features")

        # refused bodies
        pickled = io.BytesIO()
        np.save(pickled, images[0], allow_pickle=True)
        refusals = {"pickled body": ("/caption_features", pickled.getvalue(), ""),
                    "malformed body": ("/caption_features", b"not an archive", ""),
                    "/caption without Pillow": ("/caption", b"\x89PNG\r\n\x1a\n" + bytes(64),
                                                "Pillow")}
        for name, (path, body, word) in refusals.items():
            with without_pillow() if "Pillow" in name else contextlib.nullcontext():
                status, reply = http_post(server.port, path, body)
            sent += 1
            if status != 400 or word not in reply.get("error", ""):
                raise AssertionError(f"{name}: {status} {reply}, expected a 400 naming {word!r}")
            log(f"  {name}: {status} {reply['error'][:100]!r}")
        health = http_get(server.port, "/healthz")
        if health["batcher"]["items"] != sent or health["model"] != SERVE_NAME:
            raise AssertionError(f"/healthz {health}: expected {sent} items")
    finally:
        server.stop()

    cases = trained_kernel_cases(device, captured, what="served batch")
    latency_ms = np.asarray(latency) * 1e3
    p50, p99 = (float(np.percentile(latency_ms, q)) for q in (50, 99))
    http = dict(requests=len(bodies), clients=cell["clients"], seconds=http_s,
                requests_per_s=len(bodies) / http_s, p50_ms=p50, p99_ms=p99, mean_fill=fill,
                steps=http_steps, launches=http_launches)
    into_batcher = dict(seconds=batcher_s, requests_per_s=len(bodies) / batcher_s,
                        mean_fill=batcher_fill, launches=batcher_launches)
    log(f"  HTTP: {len(bodies)} /caption_features requests from {cell['clients']} clients in "
        f"{http_s:.3f} s: {http['requests_per_s']:.1f} requests/s, latency p50 {p50:.1f} ms, "
        f"p99 {p99:.1f} ms, mean batch fill {fill:.2f} of {cell['batch']}; {http_steps} decode "
        f"steps, launches {http_launches}; on {card}")
    log(f"  straight into the batcher: {into_batcher['requests_per_s']:.1f} requests/s, mean "
        f"batch fill {batcher_fill:.2f}; launches {batcher_launches}; on {card}")
    log(f"  /healthz: {health}; every reply equal to caption_features of its image")
    return dict(pipe=pipe, vocab=vocab, http=http, batcher=into_batcher, health=health,
                checkpoint_mib=ckpt_mib, load_s=t2 - t1, kernels=cases)


def images_phase(device, s, card: str, serving):
    """caption_images on arrays: N_ARRAYS seeded 480 x 640 x 3 uint8 images
    through the serving cell's pipeline (the patch backbone at grid 7 and
    the model's feature width, roi_pool over the grid cells as regions) on
    the card.  The thumbnails must equal the same backbone's on the card's
    host CPU; the features and roi_pool (over the grid cells, random boxes
    and a degenerate box) must lie within EXTRACT_ATOL and ROI_ATOL of the
    CPU's on the same inputs.  The captions must be vocab words; prints
    whether Pillow was present."""
    import importlib.util

    from openviic_tpu_torch.data.extraction import PatchBackbone, grid_boxes, roi_pool

    pipe, vocab = serving["pipe"], serving["vocab"]
    rng = np.random.default_rng(SERVE_SEED)
    arrays = [rng.integers(0, 256, size=PIXEL_SHAPE, dtype=np.uint8) for _ in range(N_ARRAYS)]
    grid = 7
    card_bb = pipe.backbone("patch", grid)
    cpu_bb = PatchBackbone(grid, card_bb.dim, device="cpu")
    gboxes = grid_boxes(grid)
    corners = np.sort(rng.uniform(0, 1, size=(16, 2, 2)), axis=1).astype(np.float32)
    boxes = np.concatenate([gboxes, corners.reshape(16, 4),
                            np.asarray([[0.5, 0.5, 0.5, 0.5]], np.float32)])
    worst = dict(features=0.0, roi=0.0)
    with torch.no_grad():
        for arr in arrays:
            thumb = card_bb.resize(arr)
            if not torch.equal(thumb.cpu(), cpu_bb.resize(arr)):
                raise AssertionError("the card's thumbnail differs from its host CPU's")
            fmap = card_bb.embed(thumb)
            want = cpu_bb.embed(thumb.cpu())
            worst["features"] = max(worst["features"], float((fmap.cpu() - want).abs().max()))
            worst["roi"] = max(worst["roi"], float(
                (roi_pool(fmap, gboxes, boxes).cpu() - roi_pool(fmap.cpu(), gboxes, boxes))
                .abs().max()))
    if worst["features"] > EXTRACT_ATOL or worst["roi"] > ROI_ATOL:
        raise AssertionError(f"extraction on the card against its host CPU: {worst} (features "
                             f"<= {EXTRACT_ATOL}, roi_pool <= {ROI_ATOL}?)")
    sync(device)
    t0 = time.perf_counter()
    captions = pipe.caption_images(arrays, grid=grid)
    seconds = time.perf_counter() - t0
    if sorted(captions) != list(range(N_ARRAYS)):
        raise AssertionError(f"caption_images keys {sorted(captions)}")
    for caption in captions.values():
        if any(tok not in vocab.stoi or tok in vocab.specials for tok in caption.split()):
            raise AssertionError(f"caption_images: not vocab words: {caption!r}")
    try:
        pillow = importlib.util.find_spec("PIL") is not None
    except ImportError:  # an import hook refuses it
        pillow = False
    log(f"  caption_images: {N_ARRAYS} arrays of {PIXEL_SHAPE} at grid {grid}, dim "
        f"{card_bb.dim} ({grid * grid} cells as regions): {seconds:.3f} s with extraction on "
        f"{card}; thumbnails equal to the host CPU's, features within {worst['features']:.3g} "
        f"(<= {EXTRACT_ATOL}), roi_pool within {worst['roi']:.3g} (<= {ROI_ATOL}); Pillow "
        f"{'present' if pillow else 'absent'} on this machine; sample {captions[0]!r}")
    return dict(seconds=seconds, worst=worst, pillow=pillow)


REHEARSAL_MAX_LEN = 5  # the rehearsal's trained decodes: 5 steps of the artifact's 30


def rehearsal_artifact(loaded) -> dict:
    """The loaded artifact with a copy of its vocab whose captions end after
    REHEARSAL_MAX_LEN steps: the rehearsal's trained and caption_directory
    decodes run every path and check on the artifact's weights for those
    steps only (a decode's first steps do not depend on its length)."""
    import copy

    vocab = copy.copy(loaded["vocab"])
    vocab.max_caption_length = REHEARSAL_MAX_LEN
    return dict(loaded, vocab=vocab)


def directory_phase(device, s, card: str, loaded, trained):
    """caption_directory over the trained artifact's test images, written
    as ``<id>.npy`` (f16 regions at their real counts) beside a port
    checkpoint of its weights and its ``vocab.bin``, loaded by
    ``CaptioningPipeline(config, checkpoint_dir=...)`` at batch 32, beam 5:
    at f32 at least F32_AGREEMENT_MIN of the captions must equal the
    trained phase's f32 captions on the card, with CIDEr within
    F32_CIDER_ATOL; at bf16 through the head kernel (forced) its CIDEr,
    launches (one a step) and captions/s, the background loading of the
    files included, are printed.  The rehearsal takes the trained phase's
    image and its vocab cut short (``rehearsal_artifact``), pickled into
    the run."""
    import tempfile

    from openviic_tpu_torch import artifact
    from openviic_tpu_torch.ops.head_topk import head_topk
    from openviic_tpu_torch.serving import CaptioningPipeline

    cuda = device.type == "cuda"
    want = trained["f32_captions"]
    ids = loaded["ids"][: len(want)]
    refs = loaded["refs"]
    beam = 5
    # the rehearsal's batch is its image, as the trained phase's
    batch = SERVE_CELL["batch"] if cuda else len(ids)
    with tempfile.TemporaryDirectory(prefix="openviic_directory_") as tmp:
        features = os.path.join(tmp, "features")
        os.makedirs(features)
        with np.load(artifact.ARTIFACT_DIR / "test_features.npz") as z:
            for i in ids:
                np.save(os.path.join(features, f"{i}.npy"), {"region_features": z[i]},
                        allow_pickle=True)
        run = os.path.join(tmp, "run")
        # the rehearsal's vocab is cut short (rehearsal_artifact): pickled as it is
        write_run(run, loaded["model"], **({"vocab_file": artifact.ARTIFACT_DIR / "vocab.bin"}
                                           if cuda else {"vocab": loaded["vocab"]}))

        def pipeline(bf16, **flags):
            return CaptioningPipeline(trained_config(**flags), checkpoint_dir=run, beam_size=beam,
                                      batch_size=batch, use_bf16=bf16, device=device)

        f32 = pipeline(False).caption_directory(features)
        if sorted(f32) != sorted(ids):
            raise AssertionError(f"caption_directory ids {sorted(f32)[:3]}...")
        got = [f32[i] for i in ids]
        same = float(np.mean([a == b for a, b in zip(got, want)]))
        c_dir, c_trained = (artifact.artifact_cider(c, ids, refs) for c in (got, want))
        log(f"  caption_directory at f32, {len(ids)} files, batch {batch}, beam "
            f"{beam}: captions identical to the trained phase's f32 card captions {same:.4f}; "
            f"CIDEr {c_dir:.4f} against {c_trained:.4f}")
        if same < F32_AGREEMENT_MIN or abs(c_dir - c_trained) > F32_CIDER_ATOL:
            raise AssertionError(f"caption_directory f32: {same:.4f} identical (< "
                                 f"{F32_AGREEMENT_MIN}?), CIDEr gap {abs(c_dir - c_trained):.4f}"
                                 f" (> {F32_CIDER_ATOL}?)")
        # (the rehearsal leaves the head kernel's plain version out here:
        # the trained phase runs it at this width)
        bf16 = pipeline(True, head_kernel=1 if cuda else False)
        if cuda:
            bf16.caption_directory(features)  # warm-up
        sync(device)
        head_topk.launches = 0
        steps0 = bf16.searcher.steps
        t0 = time.perf_counter()
        served = bf16.caption_directory(features)
        seconds = time.perf_counter() - t0
        steps = bf16.searcher.steps - steps0
        if head_topk.launches != (steps if cuda else 0) or steps <= 0:
            raise AssertionError(f"caption_directory bf16: head_topk launched "
                                 f"{head_topk.launches} times over {steps} steps")
    c_bf16 = artifact.artifact_cider([served[i] for i in ids], ids, refs)
    log(f"  caption_directory at bf16, head kernel {'forced' if cuda else 'off'}: CIDEr "
        f"{c_bf16:.4f}, {len(ids) / seconds:.1f} "
        f"captions/s ({seconds:.3f} s for {len(ids)} files, loading included), {steps} steps, "
        f"{head_topk.launches} head_topk launches; on {card}")
    return dict(f32_agreement=same, f32_cider=c_dir, trained_f32_cider=c_trained,
                bf16_cider=c_bf16, bf16_captions_per_s=len(ids) / seconds, bf16_steps=steps,
                head_topk_launches=head_topk.launches)


# ---------------------------------------------------------------- phase 10
XE_WARMUP = 10_000  # configs/standard_transformer_using_region.yaml's WARMUP
XE_BATCH = 60  # its FEATURE_BATCH_SIZE
XE_STEPS_PER_CALL = 4  # configs/tpu/standard_transformer_using_region.yaml
XE_RUN_STEPS = 20
XE_REHEARSAL_RUN_STEPS = 8  # the rehearsal's run: the loss falls within 8 steps there too
XE_CPU_LOSS_RTOL = 1e-4
XE_CPU_TOL = 1e-3  # gradient leaves and updated parameters, of their max-abs
XE_MULTI_RTOL = 1e-5
XE_ACCUM_RTOL = 1e-4  # the loss; the gradients are held to XE_CPU_TOL, as f32 sums
# in another order (the microbatches' GEMMs) move the cancelling K-projection
# gradients by up to 8e-4 of their max-abs on the card


def xe_batches(vocab, loaded, n_batches: int, batch: int):
    """Teacher-forcing batches of the artifact's test captions (each
    reference encoded by preprocess_caption and encode_caption, with its
    image's features), in order, ``batch`` captions each."""
    from openviic_tpu_torch.data.datasets import caption_instance
    from openviic_tpu_torch.data.instance import InstanceList
    from openviic_tpu_torch.data.preprocess import preprocess_caption

    items = []
    for feats, image_id in zip(loaded["feats"], loaded["ids"]):
        for ref in loaded["refs"][image_id]:
            items.append(caption_instance(vocab, preprocess_caption(ref, None),
                                          region_features=feats))
            if len(items) == n_batches * batch:
                return [{k: torch.from_numpy(v) for k, v in InstanceList(
                    items[i : i + batch]).arrays().items()} for i in range(0, len(items), batch)]
    raise AssertionError(f"the artifact holds fewer than {n_batches * batch} captions")


def leaf_gaps(got: dict, want: dict, largest_grad=None) -> dict:
    """{leaf: the largest |got - want| over the leaf's max-abs} (the key
    projections' biases, whose gradient is zero but for rounding, over the
    largest gradient's)."""
    gaps = {}
    for name, w in want.items():
        scale = w.abs().max().item()
        if largest_grad is not None and name.endswith("fc_k.bias"):
            scale = largest_grad
        gaps[name] = (got[name].cpu() - w.cpu()).abs().max().item() / max(scale, 1e-30)
    return gaps


def gap_of_max_abs(got: dict, want: dict, largest_grad=None) -> tuple:
    """The worst of ``leaf_gaps``: (gap, leaf)."""
    gaps = leaf_gaps(got, want, largest_grad)
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def train_config(s, cuda: bool, loaded):
    """(the model config as a dict, its state dict): on the card the
    artifact's config and weights; in the rehearsal the artifact's config
    at tiny widths and one layer, with random weights."""
    from openviic_tpu_torch import artifact

    if cuda:
        return artifact.artifact_config().MODEL.to_dict(), loaded["state_dict"]
    return artifact.artifact_config(d_model=s["d_model"], heads=s["heads"], layers=1,
                                    d_ff=s["d_ff"]).MODEL.to_dict(), None


def train_model(model_cfg: dict, state, vocab, dev, dropout: float):
    """The f32 model of ``model_cfg`` with every DROPOUT set to ``dropout``,
    ``state`` loaded (random weights from seed 0 without it), on ``dev``."""
    from openviic_tpu_torch.builders import build_model
    from openviic_tpu_torch.config import ConfigNode

    def walk(node):
        if isinstance(node, dict):
            return {k: (dropout if k == "DROPOUT" else walk(v)) for k, v in node.items()}
        return node
    model = build_model(ConfigNode(walk(model_cfg)), vocab, device="cpu", seed=0)
    if state is not None:
        model.load_state_dict(state)
    return model.to(dev)


def xe_phase(device, s, card: str, loaded):
    """XE training of the flagship from the artifact's weights, at batch
    XE_BATCH of the artifact's test captions: one f32 step (dropout 0, TF32
    off) on the card against the same step on its host's CPU (loss within
    XE_CPU_LOSS_RTOL relative, every gradient leaf and updated parameter
    within XE_CPU_TOL of its max-abs); make_xe_multi_step over
    XE_STEPS_PER_CALL batches against as many single steps from the same
    state and generator (bf16, dropout 0.1; losses within XE_MULTI_RTOL);
    grad_accum 2 against the full batch at f32 (loss within XE_ACCUM_RTOL,
    gradients within XE_CPU_TOL); then XE_RUN_STEPS steps at bf16 mixed
    precision, dropout 0.1 and Noam warmup XE_WARMUP on one batch, whose
    losses must be finite and fall (the mean of the last 5 below the
    first), with ms per step (CUDA events) and peak memory; and under
    OPENVIIC_PALLAS=1 the step refuses (the kernel has no backward).  The
    CPU rehearsal runs it at tiny widths on batches of 12, its training run
    XE_REHEARSAL_RUN_STEPS steps long."""
    from openviic_tpu_torch.training import optim, steps

    cuda = device.type == "cuda"
    vocab = loaded["vocab"]
    model_cfg, state = train_config(s, cuda, loaded)
    batch = XE_BATCH if cuda else 12
    batches = [{k: v.to(device) for k, v in b.items()}
               for b in xe_batches(vocab, loaded, XE_STEPS_PER_CALL, batch)]
    d_model = model_cfg["ENCODER"]["D_MODEL"]

    def fresh(dev, dropout=0.0, seed=0):
        model = train_model(model_cfg, state, vocab, dev, dropout)
        opt, sched = optim.make_optimizer(model.parameters(), d_model, XE_WARMUP)
        return model, steps.init_xe_state(model, opt, sched, seed=seed)

    def grads(model):
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    def params(model):
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    # the card against its host's CPU, f32, dropout 0
    card_model, card_state = fresh(device)
    cpu_model, cpu_state = fresh(torch.device("cpu"))
    _, card_loss = steps.make_xe_step(card_model)(card_state, batches[0])
    _, cpu_loss = steps.make_xe_step(cpu_model)(cpu_state, {k: v.cpu() for k, v in
                                                            batches[0].items()})
    card_grads, cpu_grads = grads(card_model), grads(cpu_model)
    largest = max(g.abs().max().item() for g in cpu_grads.values())
    rel = abs(card_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    g_gap = gap_of_max_abs(card_grads, cpu_grads, largest)
    p_gap = gap_of_max_abs(params(card_model), params(cpu_model))
    log(f"  XE f32 step, card against its host's CPU: loss {card_loss.item():.6f} / "
        f"{cpu_loss.item():.6f} (relative {rel:.2e}); gradients within {g_gap[0]:.2e} of their "
        f"max-abs (worst {g_gap[1]}); updated parameters within {p_gap[0]:.2e}")
    if rel > XE_CPU_LOSS_RTOL or g_gap[0] > XE_CPU_TOL or p_gap[0] > XE_CPU_TOL:
        raise AssertionError(f"XE card against CPU: loss {rel:.2e} > {XE_CPU_LOSS_RTOL}, or "
                             f"gradients {g_gap} / parameters {p_gap} > {XE_CPU_TOL}")

    # k updates in one call against k single steps
    runs = []
    for multi in (False, True):
        model, st = fresh(device, dropout=0.1, seed=7)
        if multi:
            update = steps.make_xe_multi_step(model, mixed_precision=True)
            runs.append(update(st, batches)[1].cpu())
        else:
            update = steps.make_xe_step(model, mixed_precision=True)
            runs.append(torch.stack([update(st, b)[1] for b in batches]).cpu())
        del model, st, update  # the update holds the model
    multi_rel = ((runs[1] - runs[0]).abs() / runs[0].abs()).max().item()
    log(f"  XE multi-step (k = {len(batches)}, bf16, dropout 0.1) against single steps: losses "
        f"{[round(x, 5) for x in runs[1].tolist()]}, relative gap {multi_rel:.2e}")
    if multi_rel > XE_MULTI_RTOL:
        raise AssertionError(f"XE multi-step: relative gap {multi_rel:.2e} > {XE_MULTI_RTOL}")

    # grad_accum 2 against the full batch, f32
    full_model, full_state = fresh(device)
    _, full_loss = steps.make_xe_step(full_model)(full_state, batches[1])
    accum_model, accum_state = fresh(device)
    _, accum_loss = steps.make_xe_step(accum_model, grad_accum=2)(accum_state, batches[1])
    full_grads = grads(full_model)
    largest = max(g.abs().max().item() for g in full_grads.values())
    a_rel = abs(accum_loss.item() - full_loss.item()) / abs(full_loss.item())
    a_gap = gap_of_max_abs(grads(accum_model), full_grads, largest)
    log(f"  XE grad_accum 2 against the full batch (f32): loss relative gap {a_rel:.2e}, "
        f"gradients within {a_gap[0]:.2e} of their max-abs (worst {a_gap[1]})")
    if a_rel > XE_ACCUM_RTOL or a_gap[0] > XE_CPU_TOL:
        raise AssertionError(f"XE grad_accum: loss {a_rel:.2e} > {XE_ACCUM_RTOL}, or gradients "
                             f"{a_gap} > {XE_CPU_TOL}")
    del full_model, full_state, accum_model, accum_state, card_model, card_state

    # the training run: bf16 mixed precision, dropout 0.1, Noam warmup; its
    # memory counted from what earlier phases still hold
    if cuda:
        gc.collect()  # earlier phases' cycles, which would otherwise go mid-run
        sync(device)
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    model, st = fresh(device, dropout=0.1, seed=1)
    step = steps.make_xe_step(model, mixed_precision=True)
    eval_loss = steps.make_eval_loss_step(model)  # f32, dropout off
    eval_before = eval_loss(batches[0]).item()
    # weights whose bf16 cast is an exact rounding tie (low 16 bits 0x8000):
    # the first update, however small, breaks each toward descent
    ties = sum(int(((p.detach().view(torch.int32) & 0xFFFF) == 0x8000).sum())
               for p in model.parameters()) / sum(p.numel() for p in model.parameters())
    losses, ms = [], []
    n_run = XE_RUN_STEPS if cuda else XE_REHEARSAL_RUN_STEPS
    for _ in range(n_run):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        st, loss = step(st, batches[0])
        if cuda:
            end.record()
            sync(device)
            ms.append(start.elapsed_time(end))
        losses.append(loss.item())
    peak = (torch.cuda.max_memory_allocated(device) - held) / 2**30 if cuda else None
    first, last5 = losses[0], float(np.mean(losses[-5:]))
    log(f"  XE training run, {n_run} steps at bf16 mixed precision, dropout 0.1, Noam "
        f"warmup {XE_WARMUP}, batch {batch}: losses {[round(x, 4) for x in losses]}; first "
        f"{first:.4f}, mean of the last 5 {last5:.4f}; the batch's f32 eval loss "
        f"{eval_before:.5f} -> {eval_loss(batches[0]).item():.5f}; {ties:.4f} of the weights' "
        f"bf16 casts are rounding ties")
    if not np.isfinite(losses).all() or not last5 < first:
        raise AssertionError("XE training run: a loss is not finite, or the loss did not fall")
    step_ms = float(np.median(ms[1:])) if cuda else None
    if cuda:
        log(f"  XE step (batch {batch}, bf16 mixed precision): {step_ms:.3f} ms median over "
            f"steps 2-{XE_RUN_STEPS} (CUDA events; first step {ms[0]:.3f} ms), peak memory "
            f"{peak:.3f} GiB (the model, its gradients, Adam's moments and the steps' "
            f"activations) on {card}")

    with env_flag("OPENVIIC_PALLAS"):
        try:
            steps.make_xe_step(model)(st, batches[0])
        except RuntimeError as exc:
            if "no backward" not in str(exc):
                raise
            log(f"  XE step under OPENVIIC_PALLAS=1 refuses: {exc}")
        else:
            raise AssertionError("XE step under OPENVIIC_PALLAS=1 did not refuse")
    return dict(step_ms=step_ms, peak_gib=peak, losses=losses, card_cpu_loss_rel=rel,
                card_cpu_grad_gap=g_gap[0], multi_rel=multi_rel, accum_rel=a_rel)


# ---------------------------------------------------------------- phase 11
SCST_BATCH = 60  # configs/standard_transformer_using_region.yaml's DICT_BATCH_SIZE
SCST_BEAM = 5  # configs/tpu/standard_transformer_using_region.yaml's TRAINING_BEAM_SIZE
SCST_ITERATIONS = 20
SCST_RL_LR = 5e-6  # the yaml's RL_LEARNING_RATE
SCST_REWARD_TOL = 1e-5  # the device reward against the host's (tests/test_device_reward.py)
NATIVE_TOL = 1e-9  # the native scorers against the Python ones (tests/test_native.py)
# the ReLU inputs (fc1 outputs) that fall on opposite sides of 0 on the
# card and on its host's CPU: at most this many, each within
# SCST_PIN_ATOL of the card's value.  The SCST gradient is a sum that
# cancels over an image's beams, so one such element, differentiated on
# another branch of the ReLU, moves its fc1 bias by ~1e-2 of the leaf's
# max-abs and every leaf before it by ~2e-3 on the trained artifact (H100)
SCST_MAX_PINNED = 32
SCST_PIN_ATOL = 1e-4


@contextlib.contextmanager
def forward_hooks(model, suffix: str, hook_of):
    """A forward hook ``hook_of(name)`` on each module whose name ends with
    ``suffix``."""
    handles = [m.register_forward_hook(hook_of(n)) for n, m in model.named_modules()
               if n.endswith(suffix)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def input_means(means: dict):
    """A ``forward_hooks`` hook that keeps each module's input averaged
    over its rows, in float64 on the host."""
    def hook_of(name):
        def hook(mod, args, out):
            x = args[0].detach()
            means[name] = x.reshape(-1, x.shape[-1]).double().mean(0).cpu()
        return hook
    return hook_of


def key_centred(grads: dict, means: dict) -> dict:
    """``grads`` with each key projection's weight gradient less the outer
    product of its bias gradient and its input's mean.  That product is 0
    in exact arithmetic (the softmax's gradient sums to 0 over the keys,
    so the key bias's gradient does), whatever the mean; in f32 it is the
    rounding of those sums times the keys' common part: up to 2e-3 of the
    leaf's max-abs on the trained artifact, on the H100, on its host's CPU
    and on a float64 step (softmax in f32) alike."""
    out = dict(grads)
    for name, mean in means.items():
        w, b = f"{name}.weight", f"{name}.bias"
        out[w] = grads[w].double() - torch.outer(grads[b].double(), mean)
    return out


def recorded_fc1(outputs: dict):
    """A ``forward_hooks`` hook that keeps each output, on the host."""
    def hook_of(name):
        def hook(mod, args, out):
            outputs[name] = out.detach().cpu()
        return hook
    return hook_of


def pinned_fc1(want: dict, pinned: dict):
    """A ``forward_hooks`` hook that gives each (FFN fc1) output ``want``'s
    value where the two lie on opposite sides of 0, so that the ReLU after
    it takes ``want``'s branch; the gradient passes through as before.
    Records {module: (elements pinned, their largest |change|)}."""
    def hook_of(name):
        def hook(mod, args, out):
            w = want[name].to(out.device, out.dtype)
            flip = (out.detach() > 0) != (w > 0)
            change = torch.where(flip, w - out.detach(), torch.zeros_like(w))
            pinned[name] = (int(flip.sum()), change.abs().max().item())
            return out + change
        return hook
    return hook_of


def f32_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of float32 at each |x|."""
    a = x.float().abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def scst_data(loaded, batch: int, n_batches: int):
    """The artifact's test split as SCST data: each image's references
    preprocessed and joined (the dictionary dataset's captions), all of
    them tokenized as the df corpus (the artifact carries no train split),
    and ``n_batches`` batches of ``batch`` images, in order, wrapping
    around: (features, references) each."""
    from openviic_tpu_torch.data.preprocess import preprocess_caption

    tokens = [[preprocess_caption(r, None) for r in loaded["refs"][i]] for i in loaded["ids"]]
    corpus = [t for image in tokens for t in image]
    refs = [[" ".join(t) for t in image] for image in tokens]
    n = len(refs)
    batches = []
    for k in range(n_batches):
        idx = [(k * batch + j) % n for j in range(batch)]
        batches.append(({"region_features": torch.from_numpy(loaded["feats"][idx])},
                        [refs[i] for i in idx]))
    return corpus, batches


def scst_phase(device, s, card: str, loaded):
    """SCST from the artifact's weights (vocab 7 094, max_len 30) on its 150
    test images and their references, which also serve, tokenized, as the
    df corpus (the artifact has no train split), at SCST_BATCH images x
    SCST_BEAM beams:

    1. one batch's beams sampled once at f32 (dropout 0) and their device
       reward; the f32 SCST step with the RL Adam on the card against the
       same step on its host's CPU: the loss within XE_CPU_LOSS_RTOL
       relative; every gradient leaf within XE_CPU_TOL of its max-abs,
       the CPU's ReLUs taking the card's branch where the two devices'
       inputs lie on opposite sides of 0 (at most SCST_MAX_PINNED inputs,
       each within SCST_PIN_ATOL of the card's) and the key projections'
       weights compared as ``key_centred`` gives them; every updated parameter within
       XE_CPU_TOL of its max-abs; the card's update within XE_CPU_TOL of
       the learning rate (past the last bit of each weight) of the host's
       Adam applied to the card's gradients;
    2. the device reward (DeviceCiderFull) on those beams against the host
       reward through the Python Cider and the native CIDEr, both with the
       corpus's df (within SCST_REWARD_TOL);
    3. on the card's host: compute_scores with OPENVIIC_NATIVE=1 and =0 on
       the best beams' captions (every metric within NATIVE_TOL), and
       ptb_tokenize_batch against the Python tokenizer (equal); fails when
       no native library loads, and logs which one did;
    4. SCST_ITERATIONS iterations of scst_iteration as the tuned config runs
       them: bf16 sampling through the head kernel's auto gate, the device
       reward, the f32 step (dropout 0.1) with the RL Adam at SCST_RL_LR:
       ms per iteration (median of iterations 2 on, CUDA events) split into
       sample, reward and step, the step's peak memory of its own, head_topk
       launches per iteration (gated equal to the decode steps, > 0), the
       bf16 copy refreshed once per update, finite losses, parameters moved,
       the mean reward of the first and last 5 (not gated);
    5. dropout-active sampling (SCST_SAMPLE_DROPOUT) with the attention,
       resident and head kernels requested: one seed twice gives equal
       tokens, another seed other tokens; the resident step kernel is
       launched 0 times (train mode bypasses it; without dropout it runs),
       head_topk once a step and beam_select_attention once a layer and
       step;
    6. head_topk on its inputs from the first iteration's sample of 4 and
       from the first dropout sample of 5, and beam_select_attention on its
       inputs from that dropout sample, at t = 0, 12 and the last step,
       each against its plain version under the trained phase's gates.

    The rehearsal runs it at tiny widths, one layer and random weights, on
    4 images and one iteration, without the head kernel and the launch
    gates."""
    import importlib

    from openviic_tpu_torch import native
    from openviic_tpu_torch.config import ConfigNode
    from openviic_tpu_torch.decoding import BeamSearcher
    from openviic_tpu_torch.evaluation import Cider, PTBTokenizer, compute_scores
    from openviic_tpu_torch.models import attention as attention_module
    from openviic_tpu_torch.training import optim, steps
    from openviic_tpu_torch.training.trainer import ScstSetup, scst_iteration

    # the module, not the function the package exports under its name
    beam_search_module = importlib.import_module("openviic_tpu_torch.decoding.beam_search")
    cuda = device.type == "cuda"
    vocab = loaded["vocab"]
    batch, iterations = (SCST_BATCH, SCST_ITERATIONS) if cuda else (4, 1)
    beam = SCST_BEAM
    model_cfg, state = train_config(s, cuda, loaded)
    corpus, batches = scst_data(loaded, batch, iterations)
    train_gts = {f"{i}": c for i, c in enumerate(corpus)}
    feats, refs = batches[0]
    counted = counted_wrappers()
    n_layers = model_cfg["DECODER"]["LAYERS"]
    # (the rehearsal leaves the head kernel's plain version out here: the
    # trained phase runs it at the artifact's width)
    training = ConfigNode({"RL_LEARNING_RATE": SCST_RL_LR, "TRAINING_BEAM_SIZE": beam,
                           "DECODE_DTYPE": "bfloat16", "DECODE_HEAD_KERNEL": cuda,
                           "DEVICE_REWARD": True})

    failures = []  # every case runs; the failures raise at the end

    # 1. the f32 step on the card against its host's CPU, on fixed beams
    def setup_on(dev):
        model = train_model(model_cfg, state, vocab, dev, 0.0)
        return ScstSetup(model, steps.init_xe_state(model, None), corpus, training,
                         searcher=BeamSearcher(model))

    on_card, on_cpu = setup_on(device), setup_on(torch.device("cpu"))
    old = {n: p.detach().clone() for n, p in on_cpu.model.named_parameters()}
    outs, _ = on_card.searcher(feats, beam, out_size=beam)
    sampled = outs.reshape(batch * beam, -1)
    scorer = on_card.device_reward
    reward = scorer.score(sampled, *scorer.encode_refs_on_device(refs), beam_size=beam)
    card_fc1, pinned, means = {}, {}, {}
    with forward_hooks(on_card.model, "pwff.fc1", recorded_fc1(card_fc1)):
        _, card_loss = on_card.step(on_card.state, {k: v.to(device) for k, v in feats.items()},
                                    sampled, reward.reshape(batch, beam))
    # the CPU's ReLUs take the card's branch where the two devices' inputs
    # lie on opposite sides of 0 (each within rounding of 0)
    with forward_hooks(on_cpu.model, "pwff.fc1", pinned_fc1(card_fc1, pinned)), \
            forward_hooks(on_cpu.model, "fc_k", input_means(means)):
        _, cpu_loss = on_cpu.step(on_cpu.state, feats, sampled.cpu(),
                                  reward.cpu().reshape(batch, beam))
    del card_fc1
    n_pinned = sum(n for n, _ in pinned.values())
    pin_change = max(c for _, c in pinned.values())
    grads = {name: {n: p.grad.detach().cpu() for n, p in s_.model.named_parameters()}
             for name, s_ in (("card", on_card), ("cpu", on_cpu))}
    largest = max(g.abs().max().item() for g in grads["cpu"].values())
    # (random weights in the rehearsal earn a zero reward, and a zero loss)
    rel = abs(card_loss.item() - cpu_loss.item()) / max(abs(cpu_loss.item()), 1e-30)
    raw = leaf_gaps(grads["card"], grads["cpu"], largest)
    g_gaps = leaf_gaps(key_centred(grads["card"], means), key_centred(grads["cpu"], means),
                       largest)
    top = sorted(g_gaps, key=g_gaps.get, reverse=True)[:4]
    raw_k = max((n for n in raw if n.endswith("fc_k.weight")), key=raw.get)
    new = {name: {n: p.detach().cpu() for n, p in s_.model.named_parameters()}
           for name, s_ in (("card", on_card), ("cpu", on_cpu))}
    p_gap = gap_of_max_abs(new["card"], new["cpu"])
    # the update: the card's against the host's Adam on the card's gradients
    # (the same function of the same inputs: within 1e-3 of lr and the last
    # bit of each stored weight).  Against the CPU's own update it is held
    # through the gradients: Adam's first step divides by |g| + eps, so a
    # gradient within the bar may still move a weight by a share of lr
    replay = [old[n].clone().requires_grad_(True) for n in old]
    for p, n in zip(replay, old):
        p.grad = grads["card"][n]
    optim.make_rl_optimizer(replay, SCST_RL_LR).step()
    u_gap = max(((new["card"][n] - p.detach()).abs() - f32_ulp(p.detach())).clamp(min=0).max()
                .item() for n, p in zip(old, replay)) / SCST_RL_LR
    ended = float((sampled[:, :-1] == vocab.eos_idx).any(dim=1).float().mean())
    log(f"  SCST f32 step ({batch} images x {beam} beams sampled at f32, {ended:.3f} of them "
        f"ended before the last step), card against its host's CPU: loss "
        f"{card_loss.item():.8f} / {cpu_loss.item():.8f} (relative {rel:.2e}); {n_pinned} "
        f"ReLU inputs on opposite sides of 0 on the two devices, given the card's value on "
        f"the CPU (change at most {pin_change:.2e}; per FFN {pinned}); gradients within "
        f"{g_gaps[top[0]]:.2e} of their max-abs, the widest leaves "
        + ", ".join(f"{n} {g_gaps[n]:.2e}" for n in top)
        + f" (the {len(means)} key projections' weights less their bias gradient times "
        f"their input's mean; as they are, the widest {raw_k} {raw[raw_k]:.2e})"
        + f"; updated parameters within {p_gap[0]:.2e} of their max-abs; the card's update "
        f"against the host's Adam on the card's gradients within {u_gap:.2e} of lr past the "
        f"last bit")
    bad_grads = {n: g for n, g in g_gaps.items() if g > XE_CPU_TOL}
    if (rel > XE_CPU_LOSS_RTOL or bad_grads or n_pinned > SCST_MAX_PINNED
            or pin_change > SCST_PIN_ATOL or p_gap[0] > XE_CPU_TOL or u_gap > XE_CPU_TOL):
        failures.append(f"SCST card against CPU: loss {rel:.2e} > {XE_CPU_LOSS_RTOL}, or "
                        f"gradient leaves {bad_grads} > {XE_CPU_TOL}, or {n_pinned} ReLU "
                        f"inputs pinned > {SCST_MAX_PINNED} or changed by {pin_change:.2e} > "
                        f"{SCST_PIN_ATOL}, or parameters {p_gap} > {XE_CPU_TOL}, or the "
                        f"update {u_gap:.2e} > {XE_CPU_TOL} of lr")
    del replay, old, new

    # 2. the device reward against the host's (Python, then native CIDEr)
    if not native.available():
        raise AssertionError("no native scorer library loads (committed or built from source)")
    hosts = {"Python Cider": Cider(train_gts), "native CIDEr": native.NativeCider(gts=train_gts)}
    reward_gaps = {}
    for name, cider in hosts.items():
        on_card.train_cider = cider
        want = torch.from_numpy(on_card.host_reward(sampled, refs))
        reward_gaps[name] = (reward.cpu() - want).abs().max().item()
    log(f"  SCST device reward on {card} (mean {reward.mean().item():.5f}) against "
        f"the host reward: " + ", ".join(f"{k} {v:.2e}" for k, v in reward_gaps.items())
        + " (the df corpus is the artifact's test references: it carries no train split)")
    if max(reward_gaps.values()) > SCST_REWARD_TOL:
        failures.append(f"SCST device reward: {reward_gaps} > {SCST_REWARD_TOL}")
    del on_card, on_cpu, hosts

    # 3. the native scorers on the card's host
    best = {f"{i}": [c] for i, c in enumerate(vocab.decode_caption(
        sampled[::beam].cpu().numpy()))}
    gts = {f"{i}": r for i, r in enumerate(refs)}
    scores = {}
    for flag in ("1", "0"):
        with env_flag("OPENVIIC_NATIVE", flag):
            scores[flag] = compute_scores(gts, best)
    native_gap = max(float(np.max(np.abs(np.asarray(scores["1"][j][k], np.float64)
                                         - np.asarray(scores["0"][j][k], np.float64))))
                     for j in range(2) for k in scores["0"][0])
    lines = [r for image in refs for r in image] + list(loaded["refs"][loaded["ids"][0]])
    py_tok = PTBTokenizer().tokenize({i: [line] for i, line in enumerate(lines)})
    ptb_equal = native.ptb_tokenize_batch(lines) == [py_tok[i][0] for i in range(len(lines))]
    log(f"  native scorers on the card's host ({native.library_path()}): compute_scores with "
        f"OPENVIIC_NATIVE=1 against =0 on {len(best)} captions, largest gap {native_gap:.2e} "
        f"(CIDEr {scores['1'][0]['CIDEr']:.5f}, METEOR {scores['1'][0]['METEOR']:.5f}); PTB "
        f"on {len(lines)} lines equal to the Python tokenizer: {ptb_equal}")
    if native_gap > NATIVE_TOL or not ptb_equal:
        failures.append(f"native scorers: gap {native_gap:.2e} > {NATIVE_TOL}, or PTB "
                        f"differs ({ptb_equal})")

    # 4. the SCST run, as the tuned config runs it
    if cuda:
        gc.collect()
        sync(device)
    model = train_model(model_cfg, state, vocab, device, 0.1)
    setup = ScstSetup(model, steps.init_xe_state(model, None, seed=0), corpus, training)
    before = [p.detach().clone() for p in model.parameters()]
    events, peaks, launches, n_steps, losses, rewards = [], [], [], [], [], []

    def marks(stage):
        if cuda:
            events[-1][stage] = torch.cuda.Event(enable_timing=True)
            events[-1][stage].record()
            if stage == "reward":  # the step's memory of its own, from here
                sync(device)
                peaks.append(torch.cuda.memory_allocated(device))
                torch.cuda.reset_peak_memory_stats(device)
            elif stage == "step":
                sync(device)
                peaks[-1] = torch.cuda.max_memory_allocated(device) - peaks[-1]

    captured = {}  # the head kernel's inputs in the first iteration's sample
    for k in range(iterations):
        for fn in counted:
            fn.launches = 0
        steps0 = setup.searcher.steps
        if cuda:
            events.append({"start": torch.cuda.Event(enable_timing=True)})
            events[-1]["start"].record()
        with (capture_calls(beam_search_module, "head_topk", 1) if cuda and k == 0
              else contextlib.nullcontext()) as kept:
            loss, mean_reward = scst_iteration(setup, *batches[k], marks=marks)
        if kept is not None:
            captured["SCST sample"] = {"head_topk": kept}
        losses.append(loss.item())
        rewards.append(mean_reward.item())
        n_steps.append(setup.searcher.steps - steps0)
        launches.append({fn.__name__: fn.launches for fn in counted if fn.launches})
    moved = max((p.detach() - b).abs().max().item() for p, b in zip(model.parameters(), before))
    first5, last5 = float(np.mean(rewards[:5])), float(np.mean(rewards[-5:]))
    log(f"  SCST run, {iterations} iterations of {batch} images x {beam} beams (bf16 sampling, "
        f"head kernel by the auto gate: {setup.searcher.effective_head_kernel(feats, beam)}, "
        f"device reward, f32 step with dropout 0.1, RL Adam at {SCST_RL_LR}): losses "
        f"{[round(x, 5) for x in losses]}; mean reward of the first 5 {first5:.5f}, of the last "
        f"5 {last5:.5f}; parameters moved by up to {moved:.3e}; the bf16 copy cast "
        f"{setup.searcher.shadow.casts} times; decode steps {n_steps}")
    # (a zero advantage, as random weights earn in the rehearsal, moves nothing)
    if not np.isfinite(losses).all() or (any(losses) and not moved > 0):
        failures.append("SCST run: a loss is not finite, or the parameters did not move")
    if setup.searcher.shadow.casts != iterations:
        failures.append(f"SCST run: the bf16 copy was cast {setup.searcher.shadow.casts} "
                        f"times over {iterations} updates")
    result = dict(losses=losses, rewards=rewards, card_cpu_loss_rel=rel,
                  card_cpu_grad_gap=g_gaps[top[0]], pinned_relu_inputs=n_pinned,
                  card_cpu_update_gap=u_gap, reward_gaps=reward_gaps, native_gap=native_gap,
                  steps_per_iteration=n_steps)
    if cuda:
        want = [{"head_topk": n} for n in n_steps]
        if launches != want or min(n_steps) <= 0:
            failures.append(f"SCST run: launches {launches}, expected {want}")
        spans = {"sample": ("start", "sample"), "reward": ("sample", "reward"),
                 "step": ("reward", "step"), "iteration": ("start", "step")}
        ms = {k: float(np.median([e[a].elapsed_time(e[b]) for e in events[1:]]))
              for k, (a, b) in spans.items()}
        peak = max(peaks) / 2**30
        log(f"  SCST iteration on {card}: {ms['iteration']:.3f} ms (median of iterations "
            f"2-{iterations}, CUDA events): sample {ms['sample']:.3f}, reward "
            f"{ms['reward']:.3f}, step {ms['step']:.3f}; the step's peak memory of its own "
            f"{peak:.3f} GiB; head_topk {n_steps[-1]} launches in the last iteration "
            f"({np.mean(n_steps):.1f} a mean iteration, one per decode step)")
        result.update(ms_per_iteration=ms["iteration"], sample_ms=ms["sample"],
                      reward_ms=ms["reward"], step_ms=ms["step"], step_peak_gib=peak,
                      head_topk_launches_per_iteration=float(np.mean(n_steps)),
                      head_topk_launches=int(sum(n_steps)))
    del setup, before

    # 5. dropout-active sampling with every step kernel requested
    def sample(searcher, seed):
        for fn in counted:
            fn.launches = 0
        steps0 = searcher.steps
        out, lp = searcher(feats, beam, out_size=beam, dropout_rng=seed)
        return out, lp, searcher.steps - steps0, {fn.__name__: fn.launches for fn in counted
                                                  if fn.launches}

    every = BeamSearcher(model, torch.bfloat16, head_kernel=cuda, attn_kernel=True,
                         resident_kernel=True)
    with contextlib.ExitStack() as stack:  # the first sample's kernel inputs
        kept = {"beam_select_attention": stack.enter_context(capture_calls(
            attention_module, "beam_select_attention", n_layers))}
        if cuda:
            kept["head_topk"] = stack.enter_context(capture_calls(
                beam_search_module, "head_topk", 1))
        a, lp_a, steps_a, count_a = sample(every, 1)
    captured["SCST dropout sample"] = kept
    b, lp_b, _, _ = sample(every, 1)
    c, lp_c, _, _ = sample(every, 2)
    same = bool(torch.equal(a, b) and torch.equal(lp_a, lp_b))
    differ = float((a != c).any(dim=-1).float().mean())
    log(f"  SCST dropout sampling (head, attention and resident kernels requested): seed 1 "
        f"twice equal {same}; seed 2 changes {differ:.3f} of the beams; launches over "
        f"{steps_a} steps {count_a}")
    if not same or differ == 0:
        failures.append("SCST dropout sampling: not reproducible per seed, or not seeded")
    if cuda:  # the launches (the rehearsal counts none)
        resident = BeamSearcher(model, torch.bfloat16, head_kernel=True, resident_kernel=True)
        _, _, steps_r, count_r = sample(resident, 1)
        _, _, steps_e, count_e = sample(resident, None)  # eval mode: the resident kernel runs
        log(f"  SCST sampling with the resident kernel alone: with dropout, over {steps_r} "
            f"steps {count_r}; without, over {steps_e} steps {count_e}")
        want_a = {"head_topk": steps_a, "beam_select_attention": n_layers * steps_a}
        want_r = {"head_topk": steps_r}
        want_e = {"head_topk": steps_e, "resident_layer_step": n_layers * steps_e}
        if count_a != want_a or count_r != want_r or count_e != want_e:
            failures.append(f"SCST dropout sampling launches: {count_a}, {count_r}, "
                            f"{count_e}, expected {want_a}, {want_r}, {want_e}")
        result.update(dropout_launches=count_a, dropout_steps=steps_a)

    # 6. each kernel of the SCST path on its inputs from the samples above,
    # at t = 0, 12 and the last step, against its plain version
    result["kernels"] = {}
    for what, kept in captured.items():
        try:
            cases = trained_kernel_cases(device, kept, what)
        except AssertionError as exc:
            failures.append(f"{what}: {exc}")
            continue
        for kernel, rows in cases.items():
            result["kernels"].setdefault(kernel, []).extend(
                dict(r, case=f"{what} {r['case']}") for r in rows)
    if failures:
        raise AssertionError("; ".join(failures))
    return result


# ---------------------------------------------------------------- phase 12
TRAINER_SPLIT = (90, 30, 30)  # the artifact's images as train, dev and test, by id order
TRAINER_EPOCHS = 3  # U's start(max_epochs); R runs 1 epoch, then a new trainer the rest
TRAINER_NAME = "trainer_phase"
# the tuned twin sets no LOG_EVERY: the trainer's default, a metrics row (and
# the host's wait for its loss) every 50 steps; the rows are compared in a
# second pair of runs at 1
TRAINER_LOG_EVERY = 50
# fields of a metrics.jsonl row that read the clock
CLOCK_FIELDS = ("time", "train/captions_per_sec")


def trainer_dataset(root: str, loaded, split, max_words=None) -> dict:
    """Write the artifact's test images and references under ``root`` in
    the JAX package's dataset layout: ``features/<id>.npy`` (each image's
    f16 regions at its real count, which the dataset reads as f32) and
    ``train.json`` / ``dev.json`` / ``test.json``, split by id order; with
    ``max_words`` each reference cut to its first ``max_words`` words (the
    rehearsal's short captions: its decodes then run a few steps).
    Returns {split: (images, annotations)}."""
    from openviic_tpu_torch import artifact

    ids = sorted(loaded["ids"], key=int)[: sum(split)]
    os.makedirs(os.path.join(root, "features"))
    with np.load(artifact.ARTIFACT_DIR / "test_features.npz") as z:
        for i in ids:
            np.save(os.path.join(root, "features", f"{i}.npy"), {"region_features": z[i]},
                    allow_pickle=True)
    counts, start = {}, 0
    for name, n in zip(("train", "dev", "test"), split):
        part = ids[start:start + n]
        start += n
        data = {"images": [{"id": int(i), "file_name": f"{i}.jpg"} for i in part],
                "annotations": [{"image_id": int(i),
                                 "caption": " ".join(c.split()[:max_words])}
                                for i in part for c in loaded["refs"][i]]}
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(data, f, ensure_ascii=False)
        counts[name] = (len(part), len(data["annotations"]))
    return counts


def trainer_config(data: str, checkpoint_path: str, s, cuda: bool, log_every: int):
    """The trainer's config: the artifact's model (at tiny widths and one
    layer in the rehearsal) and the tuned twin's TRAINING keys
    (``configs/tpu/standard_transformer_using_region.yaml``), the head
    kernel forced (1) on the card, PATIENCE 0 (epoch 0 is best and
    switches), a metrics row every ``log_every`` steps."""
    from openviic_tpu_torch import artifact
    from openviic_tpu_torch.config import ConfigNode

    widths = {} if cuda else dict(d_model=s["d_model"], heads=s["heads"], layers=1,
                                  d_ff=s["d_ff"])
    model = artifact.artifact_config(name=TRAINER_NAME, **widths).MODEL.to_dict()
    return ConfigNode({
        "TRAINER": "viTrainer",
        "DATASET": {
            "FEATURE_BATCH_SIZE": XE_BATCH, "DICT_BATCH_SIZE": 300, "MIN_FREQ": 5,
            "CACHE_FEATURES": 2000,
            "VOCAB": dict(BOS_TOKEN="<bos>", EOS_TOKEN="<eos>", PAD_TOKEN="<pad>",
                          UNK_TOKEN="<unk>", TOKENIZER=None, WORD_EMBEDDING=None,
                          USE_MAPPING=False, PRETRAINED_LANGUAGE_MODEL=None),
            "JSON_PATH": {k.upper(): os.path.join(data, f"{k}.json")
                          for k in ("train", "dev", "test")},
            "FEATURE_PATH": {"FEATURES": os.path.join(data, "features"), "SCENE_TEXT": None,
                             "IMAGE": None},
        },
        "TRAINING": {
            "CHECKPOINT_PATH": checkpoint_path, "LEARNING_RATE": 1.0,
            "RL_LEARNING_RATE": SCST_RL_LR, "WARMUP": XE_WARMUP, "SCORE": "CIDEr",
            "GET_SCORES": True, "TRAINING_BEAM_SIZE": SCST_BEAM, "EVALUATING_BEAM_SIZE": 3,
            "PATIENCE": 0, "RNG_IMPL": "rbg", "MIXED_PRECISION": True,
            "DECODE_DTYPE": "bfloat16", "STEPS_PER_CALL": XE_STEPS_PER_CALL,
            "DECODE_HEAD_KERNEL": 1 if cuda else False, "DECODE_ATTN_KERNEL": True,
            "LOG_EVERY": log_every,
        },
        "MODEL": model,
    })


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` for the block."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def trainer_captures(cuda: bool, n_layers: int, captured: dict):
    """A function of a label that gives a context in which the kernel
    wrappers a decode calls (beam_select_attention, and head_topk on the
    card) keep their inputs at TRAINED_STEPS and the last step
    (``capture_calls``) under ``captured[label]``; the first time a label
    is given only."""
    import importlib

    from openviic_tpu_torch.models import attention as attention_module

    beam_search_module = importlib.import_module("openviic_tpu_torch.decoding.beam_search")

    @contextlib.contextmanager
    def capture(label):
        if label is None or label in captured:
            yield
            return
        with contextlib.ExitStack() as stack:
            kept = {"beam_select_attention": stack.enter_context(capture_calls(
                attention_module, "beam_select_attention", n_layers))}
            if cuda:
                kept["head_topk"] = stack.enter_context(capture_calls(
                    beam_search_module, "head_topk", 1))
            yield
        captured[label] = kept

    return capture


def clock_trainer(tr, device, rec: dict, capture) -> None:
    """Record, on ``tr``'s instance, each epoch's seconds (the device
    synchronized at each end) of train, val loss, val decode, val scoring,
    checkpoint save and load, with its phase, mean loss and steps; the
    kernels' inputs of the first val decode and the first test prediction
    through ``capture`` (``trainer_captures``)."""
    def epoch_rec():
        return rec["epochs"].setdefault(tr.epoch, {})

    def clocked(key, fn):
        def run(*args, **kwargs):
            sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(device)
            e = epoch_rec()
            e[key] = e.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    def phase(kind, fn):
        def run():
            step0 = tr.state["step"]
            loss = fn()
            epoch_rec().update(phase=kind, loss=loss, steps=tr.state["step"] - step0)
            return loss
        return run

    def decode_loader(real):
        def run(loader, beam):
            label = {id(tr.val_dict_dataloader): "trainer val decode",
                     id(tr.test_dict_dataloader): "trainer test prediction"}.get(id(loader))
            gen = real(loader, beam)
            while True:
                sync(device)
                t0 = time.perf_counter()
                try:
                    with capture(label):
                        it, items, caps = next(gen)
                except StopIteration:
                    break
                sync(device)
                e = epoch_rec()
                e["decode"] = e.get("decode", 0.0) + time.perf_counter() - t0
                e["decode_images"] = e.get("decode_images", 0) + len(caps)
                yield it, items, caps
        return run

    tr.train = phase("xe", clocked("train", tr.train))
    tr.train_scst = phase("scst", clocked("train", tr.train_scst))
    tr.evaluate_loss = clocked("val_loss", tr.evaluate_loss)
    tr.evaluate_metrics = clocked("val_metrics", tr.evaluate_metrics)
    tr._decode_loader = decode_loader(tr._decode_loader)
    tr.save_checkpoint = clocked("save", tr.save_checkpoint)
    tr.load_checkpoint = clocked("load", tr.load_checkpoint)


@contextlib.contextmanager
def clocked_trainer_module(device, tr, rec: dict, iterations: list, capture):
    """Wrap ``training.trainer``'s ``scst_iteration``: each iteration's
    clock at its start and at the end of its sample, reward and step (the
    device synchronized at each), and the kernels' inputs of the second
    iteration through ``capture``; and its ``device_prefetch``: the host's
    seconds waiting for the train loaders' next batch, by epoch
    (``loader_wait``)."""
    from openviic_tpu_torch.training import trainer as trainer_module

    real, real_prefetch = trainer_module.scst_iteration, trainer_module.device_prefetch

    def prefetch(iterable, device_, depth=2):
        stream = real_prefetch(iterable, device_, depth)
        train = iterable in (tr.train_dataloader, tr.train_dict_dataloader)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(stream)
            except StopIteration:
                return
            if train:
                e = rec["epochs"].setdefault(tr.epoch, {})
                e["loader_wait"] = e.get("loader_wait", 0.0) + time.perf_counter() - t0
            yield item

    def timed(setup, batch, captions, marks=None):
        sync(device)
        t = {"start": time.perf_counter()}

        def mark(stage):
            sync(device)
            t[stage] = time.perf_counter()

        with capture("trainer SCST iteration 2" if len(iterations) == 1 else None):
            out = real(setup, batch, captions, marks=mark)
        iterations.append(t)
        return out

    trainer_module.scst_iteration, trainer_module.device_prefetch = timed, prefetch
    try:
        yield
    finally:
        trainer_module.scst_iteration, trainer_module.device_prefetch = real, real_prefetch


def metric_rows(tr) -> list:
    """metrics.jsonl's training rows less their clock fields (the bf16
    guard logs once a trainer, so a resumed run logs it again)."""
    with open(os.path.join(tr.checkpoint_path, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in CLOCK_FIELDS}
            for r in rows if not any(k.startswith("decode_dtype_guard/") for k in r)]


def trainer_snapshot(tr) -> dict:
    """Parameters, optimizer moments, generator and loader counters of
    ``tr``, on the CPU."""
    opt = tr.state["optimizer"].state_dict()
    return {"params": {n: p.detach().cpu().clone() for n, p in tr.model.named_parameters()},
            "moments": {(i, k): v.detach().cpu().clone() for i, e in opt["state"].items()
                        for k, v in e.items()},
            "betas": opt["param_groups"][0]["betas"], "step": int(tr.state["step"]),
            "generator": tr.state["generator"].get_state().clone(),
            "loaders": (tr.train_dataloader.epoch, tr.train_dict_dataloader.epoch)}


def snapshot_gaps(got: dict, want: dict) -> list:
    """What differs between two ``trainer_snapshot``s (bit for bit)."""
    gaps = [f"parameter {n}" for n, p in want["params"].items()
            if not torch.equal(got["params"][n], p)]
    if got["moments"].keys() != want["moments"].keys():
        gaps.append("the optimizer's moments' entries")
    else:
        gaps += [f"moment {k}" for k, v in want["moments"].items()
                 if not torch.equal(got["moments"][k], v)]
    gaps += [k for k in ("betas", "step", "loaders") if got[k] != want[k]]
    if not torch.equal(got["generator"], want["generator"]):
        gaps.append("generator")
    return gaps


def trainer_phase(device, s, card: str, loaded):
    """The trainer lifecycle (``BaseTrainer``) on the artifact's data: its
    150 test images (the rehearsal: 4) written in the JAX package's layout
    under a temporary directory (deleted after), split by id order into
    TRAINER_SPLIT train, dev and test images; the artifact's ``vocab.bin``
    copied into each run directory first, as a trainer that resumes finds
    it, and its weights loaded into the trainer's model (the rehearsal:
    random weights at tiny widths, one layer).  The config is
    ``trainer_config``'s.  Under ``torch.use_deterministic_algorithms``
    (on the card ``trainer_phase_apart`` sets the cuBLAS workspace
    ``:4096:8`` before CUDA starts):

    1. U, at LOG_EVERY TRAINER_LOG_EVERY as the tuned twin:
       ``start(max_epochs=TRAINER_EPOCHS)`` (the rehearsal: 2): an XE
       epoch, the switch (PATIENCE 0), at least one SCST epoch, each
       epoch's losses finite; ``last_model``, ``best_model`` and
       ``metrics.jsonl`` written; each epoch's seconds of train, val loss,
       val decode + scoring and checkpoint, XE ms per step, SCST ms per
       iteration (sample / reward / step), the val decode's captions/s,
       checkpoint MiB and save / load seconds; the bf16 guard's token
       disagreement, which must be in metrics.jsonl;
    2. a fresh trainer loads U's last checkpoint (mid-SCST) and holds U's
       parameters, RL Adam moments, generator and loader counters bit for
       bit;
    3. U's ``get_predictions()``: its seconds, ``test_results.json`` with
       CIDEr; head_topk launched once a decode step of every val decode,
       SCST sample and test prediction (the trainer searcher's steps),
       beam_select_attention once a layer and step, no other kernel
       (the card only: the rehearsal runs neither kernel);
    4. R: in a fresh directory, ``start(max_epochs=1)``, then a new trainer
       ``start(max_epochs=TRAINER_EPOCHS - 1)`` (a resume after the
       switch): its parameters, optimizer, generator and loader counters
       equal to U's bit for bit;
    5. U1 and R1, as U and R at LOG_EVERY 1 (a metrics row every step),
       R1 resumed after TRAINER_EPOCHS - 1 epochs (on the card, from a
       mid-SCST checkpoint): R1's state and its metrics rows (less their
       clock fields and the guard's rows) equal to U1's bit for bit;
    6. head_topk (the card only) and beam_select_attention on their inputs
       from U's first val decode, its first test prediction and its
       second SCST iteration, at t = 0, 12 and the last step, against
       their plain versions (``trained_kernel_cases``).

    Prints the peak memory and returns the launch counts, the figures and
    the kernel cases (under "kernels")."""
    import shutil
    import tempfile

    from openviic_tpu_torch import artifact
    from openviic_tpu_torch.builders import build_trainer
    from openviic_tpu_torch.training import checkpoint as ckpt
    from openviic_tpu_torch.utils import setup_logger

    cuda = device.type == "cuda"
    split = TRAINER_SPLIT if cuda else (2, 1, 1)
    epochs = TRAINER_EPOCHS if cuda else 2
    counted = counted_wrappers()
    tmp = tempfile.mkdtemp(prefix="openviic_trainer_phase_")
    failures = []
    # the trainer logs each epoch: this phase prints its own lines (the
    # logger is made once, so the trainer's import keeps this level)
    trainer_logger = setup_logger()
    level = trainer_logger.level
    trainer_logger.setLevel(logging.WARNING)
    try:
        data = os.path.join(tmp, "data")
        counts = trainer_dataset(data, loaded, split)
        log(f"  trainer data: {counts} (images, annotations) as train, dev, test, written "
            f"under a temporary directory")

        def make(run: str, fresh: bool, log_every: int = TRAINER_LOG_EVERY):
            cfg = trainer_config(data, os.path.join(tmp, run), s, cuda, log_every)
            run_dir = os.path.join(cfg.TRAINING.CHECKPOINT_PATH, TRAINER_NAME)
            os.makedirs(run_dir, exist_ok=True)
            if not os.path.exists(os.path.join(run_dir, "vocab.bin")):
                shutil.copyfile(artifact.ARTIFACT_DIR / "vocab.bin",
                                os.path.join(run_dir, "vocab.bin"))
            tr = build_trainer(cfg, device=device)
            if fresh and cuda:
                tr.model.load_state_dict(loaded["state_dict"])
            return tr

        def resumed(run: str, first: int, log_every: int = TRAINER_LOG_EVERY):
            """``start(max_epochs=first)``, then a new trainer the rest."""
            tr = make(run, fresh=True, log_every=log_every)
            tr.start(max_epochs=first)
            del tr
            tr = make(run, fresh=False, log_every=log_every)
            tr.start(max_epochs=epochs - first)
            return tr

        captured = {}
        if cuda:
            gc.collect()
            sync(device)
            torch.cuda.reset_peak_memory_stats(device)
        with deterministic_algorithms():
            # 1. U, uninterrupted
            u = make("U", fresh=True)
            n_layers = len(u.model.decoder.layers)
            capture = trainer_captures(cuda, n_layers, captured)
            rec, iterations = {"epochs": {}}, []
            clock_trainer(u, device, rec, capture)
            for fn in counted:
                fn.launches = 0
            steps0 = u.beam_searcher.steps
            with clocked_trainer_module(device, u, rec, iterations, capture):
                u.start(max_epochs=epochs)
            u_snap = trainer_snapshot(u)
            last = os.path.join(u.checkpoint_path, ckpt.LAST_NAME)
            ckpt_mib = os.path.getsize(last) / 2**20
            for e, r in sorted(rec["epochs"].items()):
                log(f"  trainer U epoch {e} ({r.get('phase')}, {r.get('steps')} steps): loss "
                    f"{r.get('loss', float('nan')):.5f}; seconds: train {r.get('train', 0):.3f} "
                    f"(waiting for the loader {r.get('loader_wait', 0):.3f}), "
                    f"val loss {r.get('val_loss', 0):.3f}, val decode + scoring "
                    f"{r.get('val_metrics', 0):.3f} (decode {r.get('decode', 0):.3f}, "
                    f"{r.get('decode_images', 0) / max(r.get('decode', 0), 1e-9):.1f} "
                    f"captions/s), checkpoint save {r.get('save', 0):.3f}, load "
                    f"{r.get('load', 0):.3f}")
            epochs_rec = {str(e): dict(r) for e, r in rec["epochs"].items()}  # before predictions
            phases = [r.get("phase") for _, r in sorted(rec["epochs"].items())]
            losses = [r.get("loss") for _, r in sorted(rec["epochs"].items())]
            xe = [r for r in rec["epochs"].values() if r.get("phase") == "xe"]
            xe_ms = 1e3 * sum(r["train"] for r in xe) / max(sum(r["steps"] for r in xe), 1)
            spans = {k: [it[b] - it[a] for it in iterations] for k, (a, b) in
                     {"sample": ("start", "sample"), "reward": ("sample", "reward"),
                      "step": ("reward", "step"), "iteration": ("start", "step")}.items()}
            scst_ms = {k: 1e3 * float(np.mean(v)) if v else float("nan")
                       for k, v in spans.items()}
            guard = u.last_decode_dtype_guard
            g = guard or dict(token_disagreement=float("nan"), seq_agreement=float("nan"),
                              flagged=None)
            with open(os.path.join(u.checkpoint_path, "metrics.jsonl")) as f:
                guard_rows = [r for r in map(json.loads, f) if "decode_dtype_guard/flagged" in r]
            log(f"  trainer U: phases by epoch {phases}; XE {xe_ms:.2f} ms a step (the epoch's "
                f"seconds over its steps, the loader included); SCST {len(iterations)} "
                f"iterations, {scst_ms['iteration']:.2f} ms each (sample "
                f"{scst_ms['sample']:.2f}, reward {scst_ms['reward']:.2f}, step "
                f"{scst_ms['step']:.2f}); checkpoint {ckpt_mib:.1f} MiB; bf16 guard: token "
                f"disagreement {g['token_disagreement']:.4f}, sequences identical "
                f"{g['seq_agreement']:.4f} (flagged {g['flagged']}; in metrics.jsonl: "
                f"{len(guard_rows)} row)")
            if (not phases or phases[0] != "xe" or "scst" not in phases
                    or not np.all(np.isfinite(losses))):
                failures.append(f"trainer U: phases {phases}, losses {losses}")
            if guard is None or not guard_rows:
                failures.append("trainer U: the bf16 guard did not run or log")
            for name in (ckpt.LAST_NAME, ckpt.BEST_NAME, "metrics.jsonl"):
                if not os.path.isfile(os.path.join(u.checkpoint_path, name)):
                    failures.append(f"trainer U: no {name}")

            # 2. the mid-SCST checkpoint into a fresh trainer
            m = make("U", fresh=False)
            sync(device)
            t0 = time.perf_counter()
            loaded_ckpt = m.load_checkpoint(last)
            m._restore_loader_epochs(loaded_ckpt, loaded_ckpt["use_rl"])
            m._ensure_scst(reset_opt=False)
            sync(device)
            load_s = time.perf_counter() - t0
            mid_gaps = snapshot_gaps(trainer_snapshot(m), u_snap)
            log(f"  trainer mid-SCST checkpoint (epoch {loaded_ckpt['epoch']}, use_rl "
                f"{loaded_ckpt['use_rl']}) loaded into a fresh trainer in {load_s:.3f} s: "
                f"parameters, RL Adam moments ({len(u_snap['moments'])} tensors, betas "
                f"{u_snap['betas']}), generator and loader counters {u_snap['loaders']} equal "
                f"bit for bit: {not mid_gaps}")
            if mid_gaps or not loaded_ckpt["use_rl"]:
                failures.append(f"trainer mid-SCST checkpoint: differs in {mid_gaps[:5]}")
            del m

            # 3. the test predictions, and the launches of the whole run
            sync(device)
            t0 = time.perf_counter()
            u.get_predictions()
            sync(device)
            pred_s = time.perf_counter() - t0
            steps = u.beam_searcher.steps - steps0
            launches = {fn.__name__: fn.launches for fn in counted if fn.launches}
            with open(os.path.join(u.checkpoint_path, "test_results.json")) as f:
                results = json.load(f)
            log(f"  trainer U get_predictions: {pred_s:.3f} s for {split[2]} images (one a "
                f"decode), test CIDEr {results.get('CIDEr', float('nan')):.4f}; decode steps "
                f"of the run (val decodes, SCST samples, predictions) {steps}; launches "
                f"{launches}")
            want = {"head_topk": steps, "beam_select_attention": n_layers * steps} if cuda else {}
            if "CIDEr" not in results or len(results["results"]) != split[2]:
                failures.append("trainer U: test_results.json lacks CIDEr or images")
            if launches != want or steps <= 0:
                failures.append(f"trainer launches {launches}, expected {want}")
            del u

            # 4. R, resumed after the switch, against U
            r = resumed("R", 1)
            r_gaps = snapshot_gaps(trainer_snapshot(r), u_snap)
            log(f"  trainer R (start(max_epochs=1), then a new trainer start(max_epochs="
                f"{epochs - 1})) against U: parameters, optimizer, generator and loader "
                f"counters equal bit for bit: {not r_gaps}; deterministic algorithms on, "
                f"cuBLAS workspace {os.environ.get('CUBLAS_WORKSPACE_CONFIG')}")
            if r_gaps:
                failures.append(f"trainer R against U: differs in {r_gaps[:5]}")
            del r

            # 5. U1 and R1 at LOG_EVERY 1: the metrics rows of every step
            u1 = make("U1", fresh=True, log_every=1)
            u1.start(max_epochs=epochs)
            u1_snap, u1_rows = trainer_snapshot(u1), metric_rows(u1)
            del u1
            r1 = resumed("R1", epochs - 1, log_every=1)
            r1_gaps = snapshot_gaps(trainer_snapshot(r1), u1_snap)
            rows_equal = metric_rows(r1) == u1_rows
            log(f"  trainer R1 (start(max_epochs={epochs - 1}), then a new trainer "
                f"start(max_epochs=1)) against U1, both at LOG_EVERY 1: state equal bit for bit: "
                f"{not r1_gaps}; metrics rows equal: {rows_equal} ({len(u1_rows)} rows)")
            if r1_gaps or not rows_equal or not u1_rows:
                failures.append(f"trainer R1 against U1: differs in {r1_gaps[:5]}, rows equal "
                                f"{rows_equal} ({len(u1_rows)} rows)")
            del r1
        peak = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else float("nan")
        log(f"  trainer peak memory {peak:.3f} GiB on {card}")

        # 6. the kernels on U's inputs, against their plain versions
        cases = {}
        for what, kept in captured.items():
            try:
                found = trained_kernel_cases(device, kept, what)
            except AssertionError as exc:
                failures.append(f"{what}: {exc}")
                continue
            for kernel, rows in found.items():
                cases.setdefault(kernel, []).extend(
                    dict(r, case=f"{what} {r['case']}") for r in rows)
        want_captured = {"trainer val decode", "trainer test prediction"}
        if cuda:  # the rehearsal's 4 train images make one SCST iteration an epoch
            want_captured.add("trainer SCST iteration 2")
        if set(captured) != want_captured:
            failures.append(f"trainer kernel inputs captured from {sorted(captured)}, expected "
                            f"{sorted(want_captured)}")
    finally:
        trainer_logger.setLevel(level)
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return {"head_topk": dict(launches=launches.get("head_topk", 0), decode_steps=steps,
                              xe_ms_per_step=xe_ms, scst_ms=scst_ms, predictions_s=pred_s,
                              checkpoint_mib=ckpt_mib, checkpoint_load_s=load_s,
                              peak_gib=peak, epochs=epochs_rec, guard=guard),
            "beam_select_attention": dict(launches=launches.get("beam_select_attention", 0),
                                          decode_steps=steps, layers=n_layers),
            "kernels": cases}


def trainer_and_orbax(device, s, card: str, loaded):
    """``trainer_phase``, then phase 20 (a) (``orbax_trainer_part``) in the
    same process, under the result's "orbax" key."""
    result = trainer_phase(device, s, card, loaded)
    result["orbax"] = timed("backends (a): the DCP checkpoint backend's trainer and serving",
                            lambda: orbax_trainer_part(device, s, card, loaded,
                                                       result["head_topk"]["epochs"]))
    return result


def trainer_phase_apart(device, s, card: str, loaded):
    """``trainer_and_orbax``; on the card in a child process whose CUDA
    starts with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which deterministic
    cuBLAS needs and which slows the XE step
    (``scripts/torch_trainer_costs.py``), so that the other phases run
    without it.  The child's lines are printed here; its result is its
    last line."""
    if device.type != "cuda":
        return trainer_and_orbax(device, s, card, loaded)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--trainer-phase", card],
                          env=env, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    if proc.returncode != 0:
        raise AssertionError(f"the trainer phase failed (exit {proc.returncode}): "
                             f"{lines[-1:] + proc.stderr.strip().splitlines()[-30:]}")
    return json.loads(lines[-1])


# ---------------------------------------------------------------- phase 14
# the single-stream region families: name -> configs/<yaml>.yaml (its tuned
# twin is configs/tpu/<yaml>.yaml, with the same MODEL tree but NAME)
FAMILIES = {
    "aoa": "attention_on_attention",
    "augmented_memory": "augmented_memory_transformer",
    "meshed_memory": "meshed_memory_transformer",
    "camo": "camo_transformer",
}
FAMILY_BEAM = 3  # the yamls' EVALUATING_BEAM_SIZE
FAMILY_LAYERS = 3  # the yamls' 3 + 3 (CAMO's encoder unpacks exactly three)
FAMILY_XE_STEPS = 10  # the rehearsal: 4
# the rehearsal's cuts: 2 images, captions of 6 words (the CPU rehearsal
# runs inside a test's time limit)
FAMILY_REHEARSAL = dict(batch=2, max_len=6)
FAMILY_XE_BATCH = 60  # the yamls' FEATURE_BATCH_SIZE
FAMILY_XE_WARMUP = 10_000  # their WARMUP
FAMILY_F32_IMAGES = 16
FAMILY_F32_AGREEMENT_MIN = 0.99
# the families whose decoder layers the whole-layer kernels run (plain SDPA
# and no AoA gate); AoA's layers bypass them, M²'s raise under resident_kernel
LAYER_KERNEL_FAMILIES = ("augmented_memory", "camo")


# the yamls' run names (NAME), by family
FAMILY_RUN_NAMES = {"aoa": "aoa_region_x152++", "augmented_memory": "aug_mem_region_x152++",
                    "meshed_memory": "m2_region_x152++",
                    "camo": "camo_transformer_region_x152_faster_rcnn",
                    "dlct": "dlct_region_grid_x152++", "rstnet": "rstnet_region_x152++"}


def family_model(name: str, s) -> dict:
    """The MODEL tree of ``configs/<FAMILIES[name]>.yaml`` (DLCT's
    dlct_fixed, RSTNet's rstnet_fixed, the frozen language model at
    ``s["lm_hidden"]`` over ``s["lm_vocab"]`` ids) at the widths of ``s``:
    ``parallel/layouts_dryrun.py``'s ``family_model`` at dropout 0.1 under
    the yaml's NAME.  At FLAGSHIP's widths that is the yaml's own tree
    (``tests/test_torch_port_families_configs.py`` holds it to that), since
    the card's machine has no PyYAML to read it."""
    from openviic_tpu_torch.parallel import layouts_dryrun

    widths = argparse.Namespace(d_model=s["d_model"], heads=s["heads"], d_ff=s["d_ff"],
                                layers=FAMILY_LAYERS, d_feature=s["d_feature"],
                                lm_hidden=s["lm_hidden"], lm_vocab=s["lm_vocab"])
    return dict(layouts_dryrun.family_model(widths, name, dropout=0.1),
                NAME=FAMILY_RUN_NAMES[name])


def family_config(name: str, s, kernels: bool = True):
    """The family's MODEL and the pipeline's decode switches: the yamls'
    beam; with ``kernels`` the head kernel forced and the beam-select
    kernel on (both take bf16 only), else neither."""
    from openviic_tpu_torch.config import ConfigNode

    return ConfigNode({"MODEL": family_model(name, s),
                       "TRAINING": {"EVALUATING_BEAM_SIZE": FAMILY_BEAM,
                                    "DECODE_HEAD_KERNEL": 1 if kernels else False,
                                    "DECODE_ATTN_KERNEL": kernels}})


def family_xe_batch(gen, s, vocab, n: int, device, name: str = ""):
    """``n`` random images (DLCT's four streams, ``two_stream_inputs``) and
    ragged random captions (<bos> words <eos>, then <pad>) as a
    teacher-forcing batch on ``device``."""
    L = vocab.max_caption_length
    if name == "dlct":
        streams = two_stream_inputs(gen, s, n)
    else:
        streams = {"region_features": torch.randn((n, s["n_regions"], s["d_feature"]),
                                                  generator=gen)}
    lengths = torch.randint(3, L - 1, (n, 1), generator=gen)
    words = torch.randint(4, len(vocab), (n, L), generator=gen)
    words[:, 0] = vocab.bos_idx
    pos = torch.arange(L)[None, :]
    pad = torch.tensor(vocab.padding_idx)
    tokens = torch.where(pos <= lengths, words, pad)
    following = torch.cat([words[:, 1:], torch.full((n, 1), vocab.padding_idx)], dim=1)
    targets = torch.where(pos < lengths, following,
                          torch.where(pos == lengths, torch.tensor(vocab.eos_idx), pad))
    batch = dict(streams, caption_tokens=tokens, shifted_right_caption_tokens=targets)
    return {k: v.to(device) for k, v in batch.items()}


def family_xe(device, s, name: str, vocab, card: str, model_cfg=None):
    """FAMILY_XE_STEPS XE steps of the family at bf16 mixed precision,
    dropout 0.1, on one batch of FAMILY_XE_BATCH random images and
    captions (the rehearsal: 4 steps at batch 4), with Adam at the Noam
    schedule's peak (fast-forwarded to step FAMILY_XE_WARMUP: at its start
    the yamls' lr, about 4e-8, moves nothing in 10 steps) over
    ``mask_frozen``'s parameters: the losses must be finite and fall (the
    mean of the last 3 below the first), and a frozen backbone (RSTNet's
    language model) stay bit-unchanged and out of Adam's state; ms per
    step (CUDA events) and peak memory on the card."""
    from openviic_tpu_torch.builders import build_model
    from openviic_tpu_torch.training import optim, steps

    cuda = device.type == "cuda"
    batch = family_xe_batch(torch.Generator().manual_seed(21), s, vocab,
                            FAMILY_XE_BATCH if cuda else 4, device, name)
    n_steps = FAMILY_XE_STEPS if cuda else 4
    if cuda:
        gc.collect()
        sync(device)
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    model = build_model(model_cfg or family_config(name, s).MODEL, vocab, device=device, seed=5)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    opt, sched = optim.make_optimizer(optim.mask_frozen(model), s["d_model"], FAMILY_XE_WARMUP)
    optim.fast_forward_schedule(opt, sched, FAMILY_XE_WARMUP)
    state = steps.init_xe_state(model, opt, sched, seed=1)
    step = steps.make_xe_step(model, mixed_precision=True)
    losses, ms = [], []
    for _ in range(n_steps):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        state, loss = step(state, batch)
        if cuda:
            end.record()
            sync(device)
            ms.append(start.elapsed_time(end))
        losses.append(loss.item())
    peak = (torch.cuda.max_memory_allocated(device) - held) / 2**30 if cuda else None
    named = dict(model.named_parameters())
    aux = [float(m.aux_loss) for m in model.modules() if getattr(m, "aux_loss", None) is not None]
    moved = [n for n, b in frozen.items() if not torch.equal(named[n], b)]
    in_adam = [n for n in frozen if named[n] in opt.state]
    del model, state, step, opt, named
    if not np.isfinite(losses).all() or not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"{name} XE: losses {losses} not finite or not falling")
    if moved or in_adam:
        raise AssertionError(f"{name} XE: frozen tensors moved {moved[:3]} or hold Adam state "
                             f"{in_adam[:3]}")
    out = dict(losses=losses, frozen_tensors=len(frozen))
    if aux:
        out["moe_aux_loss"] = aux
        log(f"  {name} XE: the MoE layers' aux losses after the last step "
            f"{[round(x, 4) for x in aux]} (not trained on)")
    if frozen:
        log(f"  {name} XE: the {len(frozen)} frozen tensors bit-unchanged, none in Adam's state")
    line = (f"  {name} XE, {n_steps} bf16 steps at batch {len(batch['caption_tokens'])}: "
            f"losses {[round(x, 4) for x in losses]}")
    if cuda:
        out.update(step_ms=float(np.median(ms[1:])), first_ms=ms[0], peak_gib=peak)
        line += (f"; {out['step_ms']:.3f} ms a step (median of steps 2-{FAMILY_XE_STEPS}; first "
                 f"{ms[0]:.3f}), peak memory {peak:.3f} GiB on {card}")
    log(line)
    return out


def families_phase(device, s, card: str):
    """The four single-stream region families (``FAMILIES``: AoA,
    augmented memory, Meshed-Memory, CAMO) at the widths of ``s`` with the
    yamls' 3 + 3 layers, 40 memory slots and beam 3, random weights from a
    seed, bf16, each served one request of ``s["batch"]`` images of
    ``s["n_regions"]`` regions through ``CaptioningPipeline`` (its tuned
    path: the head kernel forced, the beam-select kernel on):

    - the tuned path against its eager twin (fast select, no kernel): one
      head_topk a step and one beam_select_attention a layer and step;
    - (b) ``resident_kernel`` and (c) the non-resident path with
      ``OPENVIIC_FUSED_STEP=1`` against the same without the flag: one
      layer kernel a layer and step for augmented memory and CAMO, none
      for AoA (the gate bypasses them); on M² ``resident_kernel`` raises
      (the JAX package fails there);
    - ``OPENVIIC_PALLAS=1`` on the tuned path: fused_attention once an
      encoder layer and request (CAMO: also its two ``self_attn`` calls),
      against the tuned path without the flag;

    (the rehearsal: FAMILY_REHEARSAL's 2 images and 6 steps), each with
    its launches, valid ids, the mean best-beam log-prob within
    SCORE_RTOL of its twin's, captions/s, and the forced decode of the
    tuned path's captions through each kernel path against the eager step
    (within FORCED_ATOL on FORCED_SHARE of the steps).  Then head_topk,
    beam_select_attention and fused_attention (nk = padded regions + 40
    slots; CAMO's single head) on their inputs captured from the decodes,
    and CAMO's resident_layer_step, against their plain versions and timed
    beside their bounds; an f32 decode of FAMILY_F32_IMAGES images on the
    card against its host's CPU (>= FAMILY_F32_AGREEMENT_MIN identical
    captions; the card only); and ``family_xe``.  Returns {"launches":
    {kernel: {family: {path: n}}}, "kernels": cases, "families": figures}."""
    import importlib

    from openviic_tpu_torch.decoding import BeamSearcher
    from openviic_tpu_torch.models import attention as attention_module
    from openviic_tpu_torch.models import decoders as decoders_module
    from openviic_tpu_torch.serving import CaptioningPipeline

    beam_search_module = importlib.import_module("openviic_tpu_torch.decoding.beam_search")
    cuda = device.type == "cuda"
    if not cuda:
        s = dict(s, **FAMILY_REHEARSAL)
    vocab = make_vocab(s)
    rng = np.random.default_rng(14)
    feats = rng.standard_normal((s["batch"], s["n_regions"], s["d_feature"]), dtype=np.float32)
    request = [{"region_features": f} for f in feats]
    requests = [request]  # drive warms each path up on it: its shapes' first use
    launches, figures, captured = {}, {}, {}

    for i, name in enumerate(FAMILIES):
        t0 = time.perf_counter()
        pipe = CaptioningPipeline.from_state_dict(family_config(name, s), vocab,
                                                  batch_size=s["batch"], device=device,
                                                  seed=30 + i)
        model = pipe.model
        n_dec = len(model.decoder.layers)
        n_enc = len(model.encoder.layers) + (2 if name == "camo" else 0)
        per_path, f32_same = {}, None

        def run(path, searcher, decode, **expect):
            results, counts = drive(f"{name} {path}", device, s, vocab, requests, searcher,
                                    decode, card, **expect)
            per_path[path] = {k: v for k, v in counts.items() if v}
            return results

        def searched(searcher):
            return searcher_decode(pipe, searcher, vocab, FAMILY_BEAM)

        served = lambda r: pipe.caption_features(r, return_ids=True)  # noqa: E731
        tuned = run("tuned", pipe.searcher, served,
                    per_step={"head_topk": 1, "beam_select_attention": n_dec})
        tuned = rescore(device, requests, searched(pipe.searcher), tuned, f"{name} tuned")
        eager_searcher = BeamSearcher(model, torch.bfloat16)
        eager = run("eager", eager_searcher, searched(eager_searcher))
        score_parity(f"{name} tuned", tuned, eager, "its eager twin")

        kernel_family = name in LAYER_KERNEL_FAMILIES
        resident = BeamSearcher(model, torch.bfloat16, head_kernel=1, resident_kernel=True)
        if name == "meshed_memory":
            try:
                resident(pipe._batch(request), FAMILY_BEAM)
            except ValueError as exc:
                if "resident_kernel does not run MeshedDecoder" not in str(exc):
                    raise
                log(f"  {name} (b) resident_kernel raises, as the JAX package fails: {exc}")
            else:
                raise AssertionError("resident_kernel ran on MeshedDecoder")
        else:
            res_b = run("(b) resident_kernel", resident, searched(resident),
                        per_step={"head_topk": 1,
                                  "resident_layer_step": n_dec if kernel_family else 0})
            score_parity(f"{name} (b)", res_b, eager, "its eager twin")
            non_resident = BeamSearcher(model, torch.bfloat16, beam_resident=False)
            res_nr = run("(c) non-resident", non_resident, searched(non_resident))
            with env_flag("OPENVIIC_FUSED_STEP"):
                res_c = run("(c) non-resident, OPENVIIC_FUSED_STEP=1", non_resident,
                            searched(non_resident),
                            per_step={"fused_layer_step": n_dec if kernel_family else 0})
            score_parity(f"{name} (c)", res_c, res_nr, "the non-resident path without the flag")
        with env_flag("OPENVIIC_PALLAS"):
            res_d = run("OPENVIIC_PALLAS=1", pipe.searcher, served,
                        per_step={"head_topk": 1, "beam_select_attention": n_dec},
                        per_request={"fused_attention": n_enc})
            res_d = rescore(device, requests, searched(pipe.searcher), res_d, f"{name} pallas")
        score_parity(f"{name} OPENVIIC_PALLAS=1", res_d, tuned, "its tuned path")

        # the forced decode of the tuned path's captions through each path
        ids = torch.from_numpy(tuned[0][1]).to(device)
        batch = pipe._batch(request)

        def forced(resident_, **flags):
            return forced_scores(model, batch, ids, vocab, resident_, **flags)

        eager_step = forced(True)
        check_forced(f"{name} attention kernel against the eager step", ids, vocab,
                     forced(True, attn_kernel=True), eager_step)
        if kernel_family:
            check_forced(f"{name} resident kernel against the eager step", ids, vocab,
                         forced(True, resident_kernel=True), eager_step)
            eager_nr = forced(False)
            with env_flag("OPENVIIC_FUSED_STEP"):
                check_forced(f"{name} fused step against the eager non-resident step", ids,
                             vocab, forced(False), eager_nr)
        with env_flag("OPENVIIC_PALLAS"):
            check_forced(f"{name} OPENVIIC_PALLAS=1 against the eager step", ids, vocab,
                         forced(True), eager_step)

        # kernel inputs from this family's decodes (on the card)
        # (the rehearsal captures CAMO's, whose decodes give every kind)
        if name == "camo" or (cuda and name != "aoa"):
            captures = [("head_topk", beam_search_module, "head_topk", 1, 0),
                        ("beam_select_attention", attention_module, "beam_select_attention",
                         n_dec, 0)]
            with contextlib.ExitStack() as stack:
                kept = {key: stack.enter_context(capture_calls(mod, attr, every, first))
                        for key, mod, attr, every, first in captures}
                served(request)
            if name == "camo":
                with capture_calls(decoders_module, "resident_layer_step", n_dec, 0) as res_kept:
                    resident(pipe._batch(request), FAMILY_BEAM)
                kept["resident_layer_step"] = res_kept
            with env_flag("OPENVIIC_PALLAS"), capture_calls(
                    attention_module, "fused_attention", 10 ** 9, 0) as enc_kept:
                served(request)
            kept["fused_attention_encoder"] = enc_kept
            captured[name] = kept

        # f32: the card against its host's CPU
        if cuda:
            few = request[:FAMILY_F32_IMAGES]

            def f32_captions(dev):
                return CaptioningPipeline.from_state_dict(
                    family_config(name, s, kernels=False), vocab, batch_size=len(few),
                    use_bf16=False, device=dev, seed=30 + i).caption_features(few)
            card_caps, cpu_caps = f32_captions(device), f32_captions("cpu")
            f32_same = float(np.mean([a == b for a, b in zip(card_caps, cpu_caps)]))
            log(f"  {name} f32 decode of {len(few)} images: captions identical on the card and "
                f"its host's CPU {f32_same:.4f}")
            if f32_same < FAMILY_F32_AGREEMENT_MIN:
                raise AssertionError(f"{name} f32 card against CPU: {f32_same:.4f} identical < "
                                     f"{FAMILY_F32_AGREEMENT_MIN}")
        del pipe, model, resident
        xe = family_xe(device, s, name, vocab, card)
        figures[name] = dict(launches=per_path, f32_card_cpu_agreement=f32_same, xe=xe,
                             seconds=time.perf_counter() - t0)
        for path, counts in per_path.items():
            for kernel, n in counts.items():
                launches.setdefault(kernel, {}).setdefault(name, {})[path] = n
        log(f"  {name}: {figures[name]['seconds']:.3f} s")

    cases = {}
    for name, kept in captured.items():
        for kernel, rows in trained_kernel_cases(device, kept, what=f"{name} decode").items():
            cases.setdefault(kernel, []).extend(dict(r, family=name) for r in rows)
    return dict(launches=launches, kernels=cases, families=figures)


# ---------------------------------------------------------------- phase 15
# the two-stream families: name -> configs/<yaml>.yaml (its tuned twin the
# same MODEL tree but NAME)
TWO_STREAM_FAMILIES = {"dlct": "dlct_fixed"}
GRID_SIDE = 7  # the grid of grid features (a 7 x 7 feature map)
TWO_STREAM_MS = (99, 112, 200)  # the layer steps' encoder lengths: 50 + 49, bucket-padded, long
MMA_CHECK_NQ, MMA_CHECK_NK = (49, 50, 56), (99, 112)


def two_stream_inputs(gen, s, n: int) -> dict:
    """DLCT's four streams for ``n`` random images, f32 on the CPU:
    ``s["n_regions"]`` regions of ``d_feature`` with random normalized
    boxes, and a 7 x 7 grid of ``2 * d_feature`` features whose boxes are
    its cells' (``get_grids_position``)."""
    from openviic_tpu_torch.models.geometry import get_grids_position

    lo = torch.rand((n, s["n_regions"], 2), generator=gen) * 0.7
    hi = torch.clamp(lo + 0.05 + torch.rand((n, s["n_regions"], 2), generator=gen) * 0.45,
                     max=1.0)
    cells = GRID_SIDE * GRID_SIDE
    return {
        "region_features": torch.randn((n, s["n_regions"], s["d_feature"]), generator=gen),
        "region_boxes": torch.cat([lo, hi], dim=-1),
        "grid_features": torch.randn((n, cells, 2 * s["d_feature"]), generator=gen),
        "grid_boxes": torch.from_numpy(get_grids_position(n, cells, (GRID_SIDE, GRID_SIDE))),
    }


def as_request(streams: dict) -> list:
    """Per-image feature dicts (numpy) of a batch of streams."""
    n = next(iter(streams.values())).shape[0]
    return [{k: v[i].numpy() for k, v in streams.items()} for i in range(n)]


def long_memory_steps(device, s, layer):
    """Both layer steps at the encoder lengths TWO_STREAM_MS (99: DLCT's 50
    regions and 49 grid cells; 112: both bucket-padded to 56; 200: past the
    kernels' old shared-memory ceiling), the main shape at a mid-decode
    step, against their plain versions (``check_resident_step``,
    ``check_fused_step``), each timed beside its bound on the card.
    Returns {kernel: [rows]}."""
    from openviic_tpu_torch.ops.fused_decoder_step import (
        fused_layer_step, fused_layer_step_reference)
    from openviic_tpu_torch.ops.layer_step import occupancy
    from openviic_tpu_torch.ops.resident_layer_step import (
        resident_layer_step, resident_layer_step_reference)

    weights = layer.fused_weights(torch.bfloat16)
    beam, L, D, h = s["beam"], s["max_len"], s["d_model"], s["heads"]
    F = weights["w1"].shape[1]
    cuda = device.type == "cuda"
    rows = {}
    for M in TWO_STREAM_MS:
        gen = torch.Generator().manual_seed(M)
        img, t = s["batch"], L // 2
        c = step_case(gen, img, dict(s, n_regions=M), t, device)
        N = img * beam
        for resident in (True, False):
            name = "resident_layer_step" if resident else "fused_layer_step"
            if resident:
                args = (c["x"][:, None], c["k"], c["v"], c["ck"], c["cv"], c["anc"],
                        c["smask"].reshape(N, 1, 1, L), c["cmask"].reshape(img, 1, 1, M),
                        c["is_pad"])
                err, detail = check_resident_step(f"{name} M={M}", args, t, weights, h, device)
                kernel = lambda: resident_layer_step(*args, t, weights, h)  # noqa: E731
                plain = lambda: resident_layer_step_reference(*args, t, weights, h)  # noqa: E731
                bound_ms, bound_by, _, _ = layer_step_bound(True, t, weights, N, c["smask"],
                                                            c["cmask"], anc=c["anc"])
            else:
                expand = lambda a: a.reshape(img, M, D).repeat_interleave(beam, dim=0)  # noqa
                k0, v0 = c["k"].reshape(N, L, D), c["v"].reshape(N, L, D)
                ins = (c["x"], expand(c["ck"]), expand(c["cv"]), c["smask"],
                       c["cmask"].repeat_interleave(beam, dim=0))
                err, detail = check_fused_step(f"{name} M={M}", ins, k0, v0, t, weights, h,
                                               device)
                kk, vk = k0.clone(), v0.clone()
                kernel = lambda: fused_layer_step(ins[0], kk, vk, *ins[1:], t, weights, h)  # noqa
                plain = lambda: fused_layer_step_reference(  # noqa: E731
                    ins[0], kk, vk, *ins[1:], t, weights, h)
                bound_ms, bound_by, _, _ = layer_step_bound(False, t, weights, N, c["smask"],
                                                            ins[4])
            r = dict(case=f"M={M} N={N} t={t}", max_abs_err=err)
            line = f"  {name} at M={M} (N={N}, t={t}): {detail}"
            if cuda:
                smem = occupancy(resident, N, D, F, L, M, h)["smem_bytes"]
                r.update(ms=time_cuda(kernel, 20, graph=True),
                         plain_ms=time_cuda(plain, 5, graph=True), bound_ms=bound_ms,
                         bound_by=bound_by, smem_bytes=smem)
                line += (f"; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                         f"{bound_ms:.4f} ms ({bound_by}), {smem} B shared")
            log(line)
            rows.setdefault(name, []).append(r)
        del c
    return rows


def mma_tile_checks(device, s):
    """fused_attention's MMA tile (bf16 q/k/v, tensor cores) at DLCT's
    cross-attention shapes: nq MMA_CHECK_NQ (49 grid cells, 50 regions,
    either bucket-padded to 56) against nk MMA_CHECK_NK (99, 112 keys),
    with a full (B, h, nq, nk) f32 bias whose key padding is -1e30, against
    the plain version.  Returns the worst |error|."""
    from openviic_tpu_torch.ops.fused_attention import MMA

    gen = torch.Generator().manual_seed(15)
    h, d = s["heads"], s["d_model"] // s["heads"]
    worst = 0.0
    for nq in MMA_CHECK_NQ:
        for nk in MMA_CHECK_NK:
            B = 16
            q, k, v = (torch.randn((B, n, h, d), generator=gen).to(device, torch.bfloat16)
                       for n in (nq, nk, nk))
            bias = torch.randn((B, h, nq, nk), generator=gen) * 2.0
            bias[..., nk - 5:] = -1e30  # the padded keys
            err, _ = check_fused_attention(f"MMA tile nq={nq} nk={nk}", q, k, v,
                                           bias.to(device), device,
                                           tile=MMA if device.type == "cuda" else None)
            worst = max(worst, err)
    log(f"  fused_attention MMA tile at nq {MMA_CHECK_NQ} x nk {MMA_CHECK_NK} with the full "
        f"bias: max |err| {worst:.3g} (bar {FUSED_ATOL})")
    return worst


def unified_request(device, s, card: str):
    """``UnifiedTransformer`` at d_model 512 on its one shape, every stream
    4 wide (the vision embedding's D_FEATURE 4): one request of
    ``s["batch"]`` images through ``CaptioningPipeline``'s tuned path, ids
    valid and captions of vocab words."""
    from openviic_tpu_torch.serving import CaptioningPipeline

    config = model_config(s, attn_kernel=True)
    model = config.MODEL.to_dict()
    model["ARCHITECTURE"] = "UnifiedTransformer"
    model["VISION_EMBEDDING"]["D_FEATURE"] = 4
    config = type(config)({"MODEL": model, "TRAINING": config.TRAINING.to_dict()})
    vocab = make_vocab(s)
    streams = two_stream_inputs(torch.Generator().manual_seed(16), dict(s, d_feature=4), s["batch"])
    streams["grid_features"] = streams["grid_features"][..., :4]
    request = as_request(streams)
    pipe = CaptioningPipeline.from_state_dict(config, vocab, batch_size=s["batch"], device=device,
                                              seed=40)
    results, seconds = run_requests(device, [request],
                                    lambda r: pipe.caption_features(r, return_ids=True))
    check_outputs("UnifiedTransformer", s, vocab, [request], results)
    rows = " + ".join(str(v.shape[0]) for v in request[0].values())
    log(f"  UnifiedTransformer (4-wide streams, {len(request)} images of {rows} rows): one "
        f"request {seconds[0]:.3f} s on {card}, ids valid")
    return seconds[0]


def two_stream_phase(device, s, card: str):
    """DLCT (``configs/dlct_fixed.yaml``'s MODEL at the widths of ``s``:
    d_model 512, 8 heads, 3 encoder levels of 4 geometric attentions, 3
    decoder layers, d_ff 2048; random weights from a seed; bf16; beam 3)
    serving one request of ``s["batch"]`` images of ``s["n_regions"]``
    1024-d regions with boxes and a 7 x 7 grid of 2048-d features with its
    cells' boxes (the pipeline bucket-pads both to 56 rows: M = 112),
    through ``CaptioningPipeline`` (its tuned path: the head kernel forced,
    the beam-select kernel on):

    - the tuned path against eager fast select: one head_topk a step and
      one beam_select_attention a layer and step;
    - (b) ``resident_kernel`` and (c) the non-resident path with and without
      ``OPENVIIC_FUSED_STEP=1``: one layer kernel a layer and step;
    - ``OPENVIIC_PALLAS=1`` on the tuned path: fused_attention 12 times a
      request (region self, grid self, region to all, grid to all, at each
      of the three levels);

    (the rehearsal: FAMILY_REHEARSAL's 2 images and 6 steps), each with its
    launches, valid ids, the mean best-beam log-prob within SCORE_RTOL of
    its reference path's, captions/s, and the forced decode of the tuned
    path's captions through each kernel path against the eager step.
    Then head_topk and beam_select_attention on their inputs captured from
    the tuned decode, resident_layer_step and fused_layer_step on theirs
    from paths (b) and (c) (M = 112), fused_attention on the region-to-all
    call of an unpadded request ((320, 50, 8, 64) against 99 keys, the full
    bias), each against its plain version and timed beside its bound; the
    MMA tile at DLCT's cross shapes (``mma_tile_checks``); both layer
    steps at M = 99, 112 and 200 (``long_memory_steps``); an f32 decode of
    FAMILY_F32_IMAGES images on the card against its host's CPU (>=
    FAMILY_F32_AGREEMENT_MIN identical; the card only); ``family_xe`` on
    the four streams; and ``UnifiedTransformer`` at d_model 512 with 4-wide
    streams (``unified_request``).  Returns {"launches": {kernel: {path:
    n}}, "kernels": cases, "figures": ...}."""
    import importlib

    from openviic_tpu_torch.decoding import BeamSearcher
    from openviic_tpu_torch.models import attention as attention_module
    from openviic_tpu_torch.models import decoders as decoders_module
    from openviic_tpu_torch.serving import CaptioningPipeline

    beam_search_module = importlib.import_module("openviic_tpu_torch.decoding.beam_search")
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    if not cuda:
        s = dict(s, **FAMILY_REHEARSAL)
    vocab = make_vocab(s)
    name = "dlct"
    streams = two_stream_inputs(torch.Generator().manual_seed(15), s, s["batch"])
    request = as_request(streams)
    requests = [request]
    pipe = CaptioningPipeline.from_state_dict(family_config(name, s), vocab,
                                              batch_size=s["batch"], device=device, seed=35)
    model = pipe.model
    n_dec = len(model.decoder.layers)
    n_enc = 4 * len(model.encoder.region)  # four attentions a level
    per_path = {}

    def run(path, searcher, decode, **expect):
        results, counts = drive(f"{name} {path}", device, s, vocab, requests, searcher, decode,
                                card, **expect)
        per_path[path] = {k: v for k, v in counts.items() if v}
        return results

    def searched(searcher):
        return searcher_decode(pipe, searcher, vocab, FAMILY_BEAM)

    served = lambda r: pipe.caption_features(r, return_ids=True)  # noqa: E731
    tuned = run("tuned", pipe.searcher, served,
                      per_step={"head_topk": 1, "beam_select_attention": n_dec})
    tuned = rescore(device, requests, searched(pipe.searcher), tuned, f"{name} tuned")
    eager_searcher = BeamSearcher(model, torch.bfloat16)
    eager = run("eager", eager_searcher, searched(eager_searcher))
    agree = {"tuned": score_parity(f"{name} tuned", tuned, eager, "its eager twin")}
    resident = BeamSearcher(model, torch.bfloat16, head_kernel=1, resident_kernel=True)
    res_b = run("(b) resident_kernel", resident, searched(resident),
                      per_step={"head_topk": 1, "resident_layer_step": n_dec})
    agree["(b)"] = score_parity(f"{name} (b)", res_b, eager, "its eager twin")
    non_resident = BeamSearcher(model, torch.bfloat16, beam_resident=False)
    res_nr = run("(c) non-resident", non_resident, searched(non_resident))
    with env_flag("OPENVIIC_FUSED_STEP"):
        res_c = run("(c) non-resident, OPENVIIC_FUSED_STEP=1", non_resident,
                          searched(non_resident), per_step={"fused_layer_step": n_dec})
    agree["(c)"] = score_parity(f"{name} (c)", res_c, res_nr,
                                "the non-resident path without the flag")
    with env_flag("OPENVIIC_PALLAS"):
        res_d = run("OPENVIIC_PALLAS=1", pipe.searcher, served,
                          per_step={"head_topk": 1, "beam_select_attention": n_dec},
                          per_request={"fused_attention": n_enc})
        res_d = rescore(device, requests, searched(pipe.searcher), res_d, f"{name} pallas")
    agree["OPENVIIC_PALLAS=1"] = score_parity(f"{name} OPENVIIC_PALLAS=1", res_d, tuned,
                                              "its tuned path")

    # the forced decode of the tuned path's captions through each path
    ids = torch.from_numpy(tuned[0][1]).to(device)
    batch = pipe._batch(request)

    def forced(resident_, **flags):
        return forced_scores(model, batch, ids, vocab, resident_, **flags)

    eager_step = forced(True)
    check_forced(f"{name} attention kernel against the eager step", ids, vocab,
                 forced(True, attn_kernel=True), eager_step)
    check_forced(f"{name} resident kernel against the eager step", ids, vocab,
                 forced(True, resident_kernel=True), eager_step)
    eager_nr = forced(False)
    with env_flag("OPENVIIC_FUSED_STEP"):
        check_forced(f"{name} fused step against the eager non-resident step", ids, vocab,
                     forced(False), eager_nr)
    with env_flag("OPENVIIC_PALLAS"):
        check_forced(f"{name} OPENVIIC_PALLAS=1 against the eager step", ids, vocab,
                     forced(True), eager_step)

    # the kernels' inputs from these decodes (the cross memory at M = 112)
    captures = [("head_topk", beam_search_module, "head_topk", 1, 0),
                ("beam_select_attention", attention_module, "beam_select_attention", n_dec, 0)]
    with contextlib.ExitStack() as stack:
        kept = {key: stack.enter_context(capture_calls(mod, attr, every, first))
                for key, mod, attr, every, first in captures}
        served(request)
    with capture_calls(decoders_module, "resident_layer_step", n_dec, 0) as res_kept:
        resident(batch, FAMILY_BEAM)
    kept["resident_layer_step"] = res_kept
    with env_flag("OPENVIIC_FUSED_STEP"), capture_calls(decoders_module, "fused_layer_step",
                                                        n_dec, 0) as fused_kept:
        non_resident(batch, FAMILY_BEAM)
    kept["fused_layer_step"] = fused_kept
    # fused_attention on the first region-to-all call (the encoder's third)
    # of the request unpadded: 50 region queries against 50 + 49 keys
    unpadded = {k: v.to(device, torch.bfloat16) for k, v in streams.items()}
    with env_flag("OPENVIIC_PALLAS"), torch.no_grad(), capture_calls(
            attention_module, "fused_attention", 10 ** 9, 2) as r2g_kept:
        model.encoder_forward(unpadded)
    kept["fused_attention_encoder"] = r2g_kept
    cases = trained_kernel_cases(device, kept, what=f"{name} decode")
    cases.setdefault("fused_attention", []).append(
        dict(case="MMA tile at DLCT's cross shapes", max_abs_err=mma_tile_checks(device, s)))
    for kernel, rows in long_memory_steps(device, s, model.decoder.layers[0]).items():
        cases.setdefault(kernel, []).extend(rows)

    # f32: the card against its host's CPU
    f32_same = None
    if cuda:
        few = request[:FAMILY_F32_IMAGES]

        def f32_captions(dev):
            return CaptioningPipeline.from_state_dict(
                family_config(name, s, kernels=False), vocab, batch_size=len(few),
                use_bf16=False, device=dev, seed=35).caption_features(few)
        card_caps, cpu_caps = f32_captions(device), f32_captions("cpu")
        f32_same = float(np.mean([a == b for a, b in zip(card_caps, cpu_caps)]))
        log(f"  {name} f32 decode of {len(few)} images: captions identical on the card and its "
            f"host's CPU {f32_same:.4f}")
        if f32_same < FAMILY_F32_AGREEMENT_MIN:
            raise AssertionError(f"{name} f32 card against CPU: {f32_same:.4f} identical < "
                                 f"{FAMILY_F32_AGREEMENT_MIN}")
    del pipe, model, resident, non_resident, kept
    xe = family_xe(device, s, name, vocab, card)
    unified_s = unified_request(device, s, card)
    launches = {}
    for path, counts in per_path.items():
        for kernel, n in counts.items():
            launches.setdefault(kernel, {})[path] = n
    figures = dict(launches=per_path, agreement=agree, f32_card_cpu_agreement=f32_same, xe=xe,
                   unified_request_s=unified_s, seconds=time.perf_counter() - t0)
    log(f"  {name}: {figures['seconds']:.3f} s")
    return dict(launches=launches, kernels=cases, figures=figures)


# ---------------------------------------------------------------- phase 16
# RSTNet: name -> configs/<yaml>.yaml (its tuned twin the same MODEL tree but NAME)
RSTNET_FAMILIES = {"rstnet": "rstnet_fixed"}
RSTNET_TABLE_ATOL = 1e-5  # a table row against the language model run on its id, f32
RSTNET_TABLE_CHUNK = 500  # ids per language-model call of that check
RSTNET_SCST_ITERATIONS = 3  # the rehearsal: 1
RSTNET_SCST_BATCH = 60  # the yaml's DICT_BATCH_SIZE
RSTNET_TRAINER_SPLIT = (60, 12, 6)  # phase 13's artifact images: train, dev, test by id
RSTNET_TRAINER_NAME = "rstnet_trainer_phase"


def events_ms(device, fn):
    """(fn's result, its time in ms by CUDA events; nan off the card)."""
    if device.type != "cuda":
        return fn(), float("nan")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_table(device, model, table):
    """The (vocab, d) signal table against the language model run on every
    id alone, RSTNET_TABLE_CHUNK ids a call (each a 1-token sequence, as a
    decode step runs it), within RSTNET_TABLE_ATOL; the <pad> row zero.
    Returns the worst |error|."""
    lm, V, pad = model.decoder.language_model, table.shape[0], model.vocab.padding_idx
    worst = 0.0
    with torch.no_grad():
        for start in range(0, V, RSTNET_TABLE_CHUNK):
            ids = torch.arange(start, min(V, start + RSTNET_TABLE_CHUNK), device=device)
            rows = lm.signals(ids[:, None])[:, 0]
            worst = max(worst, (rows - table[start:start + len(ids)]).abs().max().item())
    if not torch.isfinite(table).all() or worst > RSTNET_TABLE_ATOL or table[pad].any():
        raise AssertionError(f"rstnet table: finite {bool(torch.isfinite(table).all())}, max "
                             f"|err| {worst:.3g} > {RSTNET_TABLE_ATOL}?, pad row "
                             f"{table[pad].abs().max().item():.3g}")
    return worst


def rstnet_scst(device, s, vocab, request, first, card: str):
    """RSTNET_SCST_ITERATIONS of ``scst_iteration`` on RSTNet at
    RSTNET_SCST_BATCH images x beam 5 (bf16 sampling through the table,
    rebuilt each iteration from the weights of the moment; device reward;
    f32 step with dropout 0.1), each image's references its first bf16
    caption and four of random words; ms for the table, the sample, the
    reward and the step; then one iteration sampled with dropout through
    the per-step language model (no table).  ``first``: the bf16 captions
    of ``request``'s images."""
    from openviic_tpu_torch.builders import build_model
    from openviic_tpu_torch.config import ConfigNode
    from openviic_tpu_torch.training import steps
    from openviic_tpu_torch.training.trainer import ScstSetup, scst_iteration

    cuda = device.type == "cuda"
    n = RSTNET_SCST_BATCH if cuda else 2
    iterations = RSTNET_SCST_ITERATIONS if cuda else 1
    order = [i % len(request) for i in range(n)]
    feats = torch.from_numpy(np.stack([request[i]["region_features"] for i in order]))
    first = [first[i] for i in order]
    rng = np.random.default_rng(16)
    words = [w for w in vocab.itos if w not in vocab.specials]
    refs = [[cap or words[0]] + [" ".join(rng.choice(words, 8)) for _ in range(4)]
            for cap in first]
    corpus = [r.split() for image in refs for r in image]
    counted = counted_wrappers()
    figures = {}
    # the weights that gave ``first`` (the pipeline's seed), so that beam 0
    # of each image earns a reward and the advantage is not zero
    model = build_model(family_config("rstnet", s).MODEL, vocab, device=device, seed=45)
    for dropout_sampling in (False, True):
        training = ConfigNode({"RL_LEARNING_RATE": SCST_RL_LR, "TRAINING_BEAM_SIZE": SCST_BEAM,
                               "DECODE_DTYPE": "bfloat16", "DECODE_HEAD_KERNEL": 1,
                               "DEVICE_REWARD": True, "SCST_SAMPLE_DROPOUT": dropout_sampling})
        setup = ScstSetup(model, steps.init_xe_state(model, None, seed=0), corpus, training,
                          language_table=model.compute_language_table)
        stamps, tables = [], [0]

        def marks(stage):
            tables[0] += stage == "table"
            sync(device)
            stamps[-1][stage] = time.perf_counter()

        losses = []
        for fn in counted:
            fn.launches = 0
        for _ in range(1 if dropout_sampling else iterations):
            sync(device)
            stamps.append({"start": time.perf_counter()})
            loss, _ = scst_iteration(setup, {"region_features": feats}, refs, marks=marks)
            losses.append(loss.item())
        launches = {fn.__name__: fn.launches for fn in counted}
        stages = ("table", "sample", "reward", "step")
        ms = {}
        for st in stamps:
            prev = st["start"]
            for stage in stages:
                if stage in st:
                    ms.setdefault(stage, []).append((st[stage] - prev) * 1e3)
                    prev = st[stage]
        want_tables = 0 if dropout_sampling else len(stamps)
        if tables[0] != want_tables or any(launches.values()) or not np.isfinite(losses).all():
            raise AssertionError(f"rstnet SCST (dropout sampling {dropout_sampling}): "
                                 f"{tables[0]} tables for {len(stamps)} iterations (expected "
                                 f"{want_tables}), launches {launches}, losses {losses}")
        key = "dropout" if dropout_sampling else "table"
        figures[key] = dict(losses=losses, ms={k: float(np.median(v)) for k, v in ms.items()})
        how = ("dropout sampling through the per-step language model" if dropout_sampling
               else "the table rebuilt each iteration")
        log(f"  rstnet SCST, {len(stamps)} iteration(s) of {n} images x {SCST_BEAM} beams, "
            f"{how}: losses {[round(x, 5) for x in losses]}; ms (host clock after a synchronize, "
            f"median) {({k: round(v, 3) for k, v in figures[key]['ms'].items()})} on {card}; "
            f"no kernel launched")
        del setup
    return figures


def rstnet_trainer(device, s, card: str, loaded):
    """``BaseTrainer`` on RSTNet over phase 13's artifact dataset
    (RSTNET_TRAINER_SPLIT of its images, its references), the tuned twin's
    TRAINING keys at PATIENCE 0: XE (epoch 0), the switch, SCST (epoch 1),
    then the test predictions.  ``frozen_params.ckpt`` is written once and
    the per-epoch file holds only the trainable tensors (its MiB beside an
    unsplit save of the same state); the best checkpoint reloads with the backbone
    stitched back; ``CaptioningPipeline(config, checkpoint_dir=...)`` gives
    the trainer's f32 captions of the dev images from the split files; no
    kernel launches.  The rehearsal: tiny widths on 4 images, references cut
    to their first FAMILY_REHEARSAL["max_len"] words."""
    import tempfile

    from openviic_tpu_torch.builders import build_trainer
    from openviic_tpu_torch.config import ConfigNode
    from openviic_tpu_torch.decoding import beam_search
    from openviic_tpu_torch.serving import CaptioningPipeline
    from openviic_tpu_torch.training import checkpoint as ckpt

    cuda = device.type == "cuda"
    split = RSTNET_TRAINER_SPLIT if cuda else (2, 1, 1)
    counted = counted_wrappers()
    saved = []
    real_save = ckpt.torch.save

    def save(obj, path, *args, **kwargs):
        saved.append(os.path.basename(str(path)).replace(".tmp", ""))
        return real_save(obj, path, *args, **kwargs)

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        trainer_dataset(data, loaded, split,
                        max_words=None if cuda else FAMILY_REHEARSAL["max_len"])
        config = trainer_config(data, os.path.join(tmp, "runs"), s, cuda, TRAINER_LOG_EVERY)
        config = config.to_dict()
        model = family_model("rstnet", s)
        model["NAME"] = RSTNET_TRAINER_NAME
        model["VISION_EMBEDDING"]["D_FEATURE"] = int(loaded["feats"].shape[-1])
        config["MODEL"] = model
        # three SCST iterations of 20 images on the card (one of 2 in the
        # rehearsal); the bf16 decode guard is phase 13's, not run here
        config["DATASET"]["DICT_BATCH_SIZE"] = SCST_BEAM * (20 if cuda else 2)
        config["TRAINING"]["DECODE_DTYPE_GUARD"] = False
        config = ConfigNode(config)
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        ckpt.torch.save = save
        unsplit = os.path.join(tmp, "unsplit.ckpt")
        try:
            tr = build_trainer(config, device=device)
            tr.start(max_epochs=2)  # XE, then SCST: PATIENCE 0 switches after epoch 0
            # the last epoch's state saved whole, beside its split file (uncounted)
            ckpt.torch.save = real_save
            t_unsplit = time.perf_counter()
            ckpt.save_checkpoint(unsplit, tr.model, tr.state, {"use_rl": tr.use_rl})
            t_unsplit = time.perf_counter() - t_unsplit
            ckpt.torch.save = save
            tr.get_predictions()
        finally:
            ckpt.torch.save = real_save
        sync(device)
        seconds = time.perf_counter() - t0 - t_unsplit
        launches = {fn.__name__: fn.launches for fn in counted}
        run = tr.checkpoint_path
        last = os.path.join(run, ckpt.LAST_NAME)
        mib = {name: os.path.getsize(p) / 2**20 for name, p in
               (("per_epoch", last), ("frozen", os.path.join(run, ckpt.FROZEN_NAME)),
                ("unsplit", unsplit))}
        best = ckpt.load_checkpoint(os.path.join(run, ckpt.BEST_NAME))["model"]
        live = tr.model.state_dict()
        stitched = set(best) == set(live) and all(torch.equal(best[k].to(live[k].device), v)
                                                  for k, v in live.items())
        raw = torch.load(last, map_location="cpu", weights_only=True)["model"]
        frozen_in_epoch_file = [k for k in raw if "backbone" in k]
        dev_items = next(iter(tr.val_dict_dataloader))
        images = [{"region_features": f} for f in dev_items["region_features"]]
        serving = ConfigNode({"MODEL": config.MODEL.to_dict(),
                              "TRAINING": config.TRAINING.to_dict()})
        pipe = CaptioningPipeline(serving, checkpoint_dir=run, use_bf16=False,
                                  batch_size=len(images), device=device)
        _, served = pipe.caption_features(images, return_ids=True)
        want, _ = beam_search(tr.model, pipe._batch(images), beam_size=pipe.beam_size,
                              language_table=tr.model.compute_language_table())
        same = bool(np.array_equal(served, want.cpu().numpy()[:len(images)]))
        use_rl, epochs = tr.use_rl, saved.count(ckpt.LAST_NAME)
    log(f"  rstnet trainer on {split} artifact images: {epochs} epochs (XE, the switch, SCST: "
        f"{use_rl}) "
        f"and the test predictions in {seconds:.3f} s on {card}; files written "
        f"{ {n: saved.count(n) for n in sorted(set(saved))} }; per-epoch file "
        f"{mib['per_epoch']:.1f} MiB beside {mib['frozen']:.1f} MiB frozen, an unsplit save "
        f"{mib['unsplit']:.1f} MiB; best checkpoint stitched equal to the live weights "
        f"{stitched}; the pipeline's captions from the split files equal the trainer model's "
        f"{same}; launches {({k: v for k, v in launches.items() if v})}")
    if (saved.count(ckpt.FROZEN_NAME) != 1 or frozen_in_epoch_file or not stitched or not same
            or any(launches.values()) or epochs != 2 or not use_rl):
        raise AssertionError(f"rstnet trainer: frozen file written {saved.count(ckpt.FROZEN_NAME)}"
                             f" times, backbone tensors in the per-epoch file "
                             f"{frozen_in_epoch_file[:3]}, stitched {stitched}, pipeline equal "
                             f"{same}, launches {launches}, epochs {epochs}, SCST {use_rl}")
    return dict(seconds=seconds, mib=mib, epochs=epochs)


def rstnet_phase(device, s, card: str, loaded):
    """RSTNet (``configs/rstnet_fixed.yaml``'s MODEL at the widths of ``s``:
    the flagship's encoder, 3 decoder layers and the adaptive one, the
    frozen PhoBERT-architecture language model of hidden 768 over 64 001
    ids; random weights from a seed; bf16; beam 3) serving one request of
    ``s["batch"]`` images of ``s["n_regions"]`` regions through
    ``CaptioningPipeline``, which builds the signal table once:

    - the table (f32, from the weights as loaded): its build time (CUDA
      events), every row against the language model run on its id on the
      card (within RSTNET_TABLE_ATOL), and its build under
      ``OPENVIIC_PALLAS=1`` (one fused_attention launch);
    - the tuned path (the yaml twin's head kernel forced and beam-select
      kernel on, both turning off for this decoder) and the eager path with
      the table, the eager path through the per-step language model (score
      parity, captions/s each); ``resident_kernel`` with ``head_kernel=1``,
      ``attn_kernel`` and ``OPENVIIC_FUSED_STEP=1`` on the non-resident
      path: no launch of any kernel and ids equal to the eager path's;
    - ``OPENVIIC_PALLAS=1`` with the table and with the per-step language
      model: fused_attention once an encoder layer and request, twice a
      standard layer and step, once more a step for the language model's
      encoder layer without the table; score parity with the flag-off twin
      and the forced decode of the tuned captions against it;
    - fused_attention on its captured RSTNet inputs (the table build's 1 x 1
      call over the vocab, the <pad> row's fully masked; one standard
      layer's step cross call) against its plain version, timed beside its
      bound and SDPA's;
    - f32: the table path against the per-step language model on
      FAMILY_F32_IMAGES images (ids identical), and the card against its
      host's CPU (>= FAMILY_F32_AGREEMENT_MIN identical; the card only);
    - ``family_xe`` (which holds the backbone bit-unchanged and out of
      Adam's state), ``rstnet_scst`` and ``rstnet_trainer``.

    The rehearsal: FAMILY_REHEARSAL's 2 images and 6 steps at tiny widths.
    Returns {"launches": {kernel: {path: n}}, "kernels": cases,
    "figures": ...}."""
    from openviic_tpu_torch.decoding import BeamSearcher
    from openviic_tpu_torch.models import attention as attention_module
    from openviic_tpu_torch.serving import CaptioningPipeline

    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    if not cuda:
        s = dict(s, **FAMILY_REHEARSAL)
    vocab = make_vocab(s)
    name = "rstnet"
    feats = np.random.default_rng(16).standard_normal(
        (s["batch"], s["n_regions"], s["d_feature"]), dtype=np.float32)
    request = [{"region_features": f} for f in feats]
    requests = [request]
    figures = {}

    # the table at f32, and the f32 decodes
    few = request[:FAMILY_F32_IMAGES]
    f32_pipe = CaptioningPipeline.from_state_dict(
        family_config(name, s, kernels=False), vocab, batch_size=len(few), use_bf16=False,
        device=device, seed=45)
    f32_model = f32_pipe.model
    table, table_ms = events_ms(device, f32_model.compute_language_table)
    _, table_ms = events_ms(device, f32_model.compute_language_table)  # after a warm-up
    table_err = check_table(device, f32_model, table)
    counted = counted_wrappers()
    for fn in counted:
        fn.launches = 0
    with env_flag("OPENVIIC_PALLAS"), capture_calls(attention_module, "fused_attention",
                                                    10 ** 9, 0) as table_kept:
        pallas_table = f32_model.compute_language_table()
    table_launches = {fn.__name__: fn.launches for fn in counted if fn.launches}
    if table_launches != ({"fused_attention": 1} if cuda else {}):
        raise AssertionError(f"rstnet table under OPENVIIC_PALLAS=1: launches {table_launches}")
    pallas_gap = (pallas_table - table).abs().max().item()
    lm = f32_model.decoder.language_model
    n_lm = sum(p.numel() for p in lm.parameters())
    log(f"  rstnet table: ({table.shape[0]}, {table.shape[1]}) f32 in {table_ms:.3f} ms on "
        f"{card} (the language model: {n_lm / 1e6:.1f} M parameters, "
        f"{sum(p.numel() for p in lm.backbone.parameters()) / 1e6:.1f} M of them frozen); rows "
        f"against the language model on each id: max |err| {table_err:.3g} (bar "
        f"{RSTNET_TABLE_ATOL}); under OPENVIIC_PALLAS=1 one fused_attention launch, max "
        f"|diff| {pallas_gap:.3g}")
    figures["table"] = dict(ms=table_ms, max_abs_err=table_err, pallas_max_diff=pallas_gap,
                            lm_params=n_lm)

    _, f32_table_ids = f32_pipe.caption_features(few, return_ids=True)
    per_step = BeamSearcher(f32_model)
    out, _ = per_step(f32_pipe._batch(few), FAMILY_BEAM)
    f32_step_ids = out[: len(few)].cpu().numpy()
    if not np.array_equal(f32_table_ids, f32_step_ids):
        raise AssertionError("rstnet f32: the table path's ids differ from the per-step "
                             "language model's")
    f32_same = None
    if cuda:
        cpu_caps = CaptioningPipeline.from_state_dict(
            family_config(name, s, kernels=False), vocab, batch_size=len(few), use_bf16=False,
            device="cpu", state_dict=f32_model.state_dict()).caption_features(few)
        card_caps = vocab.decode_caption(f32_table_ids)
        f32_same = float(np.mean([a == b for a, b in zip(card_caps, cpu_caps)]))
        if f32_same < FAMILY_F32_AGREEMENT_MIN:
            raise AssertionError(f"rstnet f32 card against CPU: {f32_same:.4f} identical < "
                                 f"{FAMILY_F32_AGREEMENT_MIN}")
    log(f"  rstnet f32 decode of {len(few)} images: the table path and the per-step language "
        f"model give identical ids; captions identical on the card and its host's CPU "
        f"{f32_same}")
    figures["f32_card_cpu_agreement"] = f32_same

    # bf16: the pipeline (its table built once, from the f32 weights)
    pipe = CaptioningPipeline.from_state_dict(family_config(name, s), vocab,
                                              state_dict=f32_model.state_dict(),
                                              batch_size=s["batch"], device=device)
    del f32_pipe, f32_model, per_step
    model, table16 = pipe.model, pipe.language_table
    n_dec = len(model.decoder.layers) - 1  # the standard layers
    n_enc = len(model.encoder.layers)
    per_path = {}

    def run(path, searcher, decode, **expect):
        results, counts = drive(f"{name} {path}", device, s, vocab, requests, searcher, decode,
                                card, **expect)
        per_path[path] = counts
        return results

    def searched(searcher, with_table=True):
        return searcher_decode(pipe, searcher, vocab, FAMILY_BEAM,
                               language_table=table16 if with_table else None)

    served = lambda r: pipe.caption_features(r, return_ids=True)  # noqa: E731
    tuned = run("tuned (table)", pipe.searcher, served)
    tuned = rescore(device, requests, searched(pipe.searcher), tuned, f"{name} tuned")
    eager_searcher = BeamSearcher(model, torch.bfloat16)
    eager = run("eager (table)", eager_searcher, searched(eager_searcher))
    step_lm = run("eager (per-step language model)", eager_searcher,
                  searched(eager_searcher, with_table=False))
    agree = {"per-step language model": score_parity(
        f"{name} per-step language model", step_lm, eager, "the table path")}

    def same_ids(label, results, ref):
        for (_, got, *_), (_, want, *_) in zip(results, ref):
            if not np.array_equal(got, want):
                raise AssertionError(f"rstnet {label}: ids differ from the eager path's")

    same_ids("tuned", tuned, eager)
    flagged = [("(b) resident_kernel, head_kernel=1",
                BeamSearcher(model, torch.bfloat16, head_kernel=1, resident_kernel=True), None),
               ("attn_kernel", BeamSearcher(model, torch.bfloat16, attn_kernel=True), None),
               ("(c) non-resident, OPENVIIC_FUSED_STEP=1",
                BeamSearcher(model, torch.bfloat16, beam_resident=False),
                "OPENVIIC_FUSED_STEP")]
    for label, searcher, flag in flagged:
        with env_flag(flag) if flag else contextlib.nullcontext():
            same_ids(label, run(label, searcher, searched(searcher)), eager)
    log(f"  rstnet: the tuned path and the three flag paths launch no kernel and give the "
        f"eager path's ids")

    with env_flag("OPENVIIC_PALLAS"):
        res_d = run("OPENVIIC_PALLAS=1 (table)", pipe.searcher, served,
                    per_step={"fused_attention": 2 * n_dec},
                    per_request={"fused_attention": n_enc})
        res_d = rescore(device, requests, searched(pipe.searcher), res_d, f"{name} pallas")
        res_lm = run("OPENVIIC_PALLAS=1 (per-step language model)", eager_searcher,
                     searched(eager_searcher, with_table=False),
                     per_step={"fused_attention": 2 * n_dec + 1},
                     per_request={"fused_attention": n_enc})
    agree["OPENVIIC_PALLAS=1"] = score_parity(f"{name} OPENVIIC_PALLAS=1", res_d, tuned,
                                              "its tuned path")
    agree["OPENVIIC_PALLAS=1 per-step"] = score_parity(
        f"{name} OPENVIIC_PALLAS=1, per-step language model", res_lm, step_lm,
        "the flag-off per-step path")

    # the forced decode of the tuned captions, the flag on against off
    ids = torch.from_numpy(tuned[0][1]).to(device)
    batch = pipe._batch(request)
    eager_forced = forced_scores(model, batch, ids, vocab, False, language_table=table16)
    with env_flag("OPENVIIC_PALLAS"):
        check_forced(f"{name} OPENVIIC_PALLAS=1 against the flag-off step", ids, vocab,
                     forced_scores(model, batch, ids, vocab, False, language_table=table16),
                     eager_forced)

    # fused_attention on its RSTNet inputs: the table's 1 x 1 call, one
    # standard layer's step cross call (layer 0's, at t = 0, 12 and the last)
    with env_flag("OPENVIIC_PALLAS"), capture_calls(
            attention_module, "fused_attention", 2 * n_dec, n_enc + 1) as cross_kept:
        served(request)
    cases = trained_kernel_cases(device, {"fused_attention_table": table_kept,
                                          "fused_attention_cross": cross_kept},
                                 what=f"{name}")
    first = tuned[0][0]
    del pipe, model, eager_searcher, flagged, batch, ids

    figures["xe"] = family_xe(device, s, name, vocab, card)
    figures["scst"] = rstnet_scst(device, s, vocab, request, first, card)
    figures["trainer"] = rstnet_trainer(device, s, card, loaded)
    kernels = [fn.__name__ for fn in counted_wrappers()]
    launches = {k: {path: counts.get(k, 0) for path, counts in per_path.items()}
                for k in kernels}
    for k in kernels:
        launches[k]["table build, OPENVIIC_PALLAS=1"] = table_launches.get(k, 0)
        launches[k]["trainer"] = 0
        launches[k]["scst"] = 0
    figures.update(agreement=agree, seconds=time.perf_counter() - t0)
    log(f"  {name}: {figures['seconds']:.3f} s")
    return dict(launches=launches, kernels=cases, figures=figures)


# ---------------------------------------------------------------- phase 17
REMAINDER_NAME = "remainder"
REMAINDER_EXPERTS = 4  # MOE_EXPERTS on every FFN; the capacity factor unset (1.25)
REMAINDER_SMALL = 7  # the return_probs request and beam_search_multi's second batch
# the RDR segmenter's strings with a lexicon, JOIN / SPLIT rules and an
# SCRDR tree written by the phase, and their expected segmentations (those
# of tests/test_rdr_segmenter.py, which holds the JAX package's binding)
RDR_LEXICON = "học sinh\nsinh học\nđàn ông\nđi bộ\nbóng đá\nkhoa học máy tính\n"
RDR_RULES = "JOIN * con mèo\nSPLIT những sinh_học\n"
RDR_SCRDR = ('True : object.conclusion = "NN"\n'
             '\tobject.tag == "B" : object.conclusion = "B"\n'
             '\t\tobject.word == "mèo" and object.prevWord1 == "con" : '
             'object.conclusion = "I"\n'
             '\t\t\tobject.nextWord1 == "hoang" : object.conclusion = "B"\n'
             '\t\tobject.word == "bộ" and object.prevTag1 == "B" and '
             'object.prevWord1 == "đi" : object.conclusion = "I"\n'
             '\tobject.tag == "I" : object.conclusion = "I"\n'
             '\t\tobject.word == "học" and object.prevWord2 == "những" : '
             'object.conclusion = "B"\n')
RDR_EXPECTED = {
    "rules": {"học sinh đi bộ": "học_sinh đi_bộ",
              "khoa học máy tính và bóng đá": "khoa_học_máy_tính và bóng_đá",
              "xin chào thế giới": "xin chào thế giới", "một con mèo": "một con_mèo",
              "những sinh học": "những sinh học", "ngành sinh học": "ngành sinh_học"},
    "scrdr": {"một con mèo": "một con_mèo", "một con mèo hoang": "một con mèo hoang",
              "đang đi bộ": "đang đi_bộ", "ngành sinh học": "ngành sinh_học",
              "những sinh học": "những sinh học"},
}


def remainder_config(s, kernels: bool = True):
    """The flagship (``model_config``) with a Switch MoE of
    REMAINDER_EXPERTS experts as every encoder and decoder FFN and
    ``LSTMTextEmbedding`` (D_EMBEDDING = d_model) as the decoder's word
    embedding; the families' beam and decode switches (``family_config``)."""
    from openviic_tpu_torch.config import ConfigNode

    model = model_config(s).to_dict()["MODEL"]
    model["ENCODER"]["SELF_ATTENTION"]["MOE_EXPERTS"] = REMAINDER_EXPERTS
    model["DECODER"]["ATTENTION"]["ENC_ATTENTION"]["MOE_EXPERTS"] = REMAINDER_EXPERTS
    model["DECODER"]["TEXT_EMBEDDING"].update(ARCHITECTURE="LSTMTextEmbedding",
                                              D_EMBEDDING=s["d_model"])
    return ConfigNode({"MODEL": model,
                       "TRAINING": {"EVALUATING_BEAM_SIZE": FAMILY_BEAM,
                                    "DECODE_HEAD_KERNEL": 1 if kernels else False,
                                    "DECODE_ATTN_KERNEL": kernels}})


def remainder_probs_and_multi(model, requests):
    """On ``model`` (the pipeline's bf16 copy), each request's images
    unpadded: ``return_probs`` on the small request, the kept
    distributions' shape, finite, and the best beam's word log-prob at
    each step found at its word in some slot's distribution of that step
    (exactly: the stored rows are the ones selected from; slots are not
    re-gathered on later reorders); ``beam_search_multi`` over both
    requests against ``beam_search`` of each (tokens equal)."""
    from openviic_tpu_torch.decoding.beam_search import beam_search, beam_search_multi

    batches = [{"region_features": torch.from_numpy(np.stack(
        [image["region_features"] for image in r]))} for r in requests]
    outputs, log_probs, probs = beam_search(model, batches[1], FAMILY_BEAM, out_size=FAMILY_BEAM,
                                            return_probs=True)
    b_s, L = outputs.shape[0], outputs.shape[-1]
    if probs.shape != (b_s, FAMILY_BEAM, L, len(model.vocab)) or not torch.isfinite(probs).all():
        raise AssertionError(f"return_probs: distributions {tuple(probs.shape)} or not finite")
    words = outputs[:, 0]
    at_words = torch.gather(probs, 3, words[:, None, :, None].expand(-1, FAMILY_BEAM, -1, 1))
    found = (at_words[..., 0] == log_probs[:, 0][:, None, :]).any(dim=1)
    if not bool(found.all()):
        raise AssertionError(f"return_probs: {int((~found).sum())} of {found.numel()} best-beam "
                             "steps not in the kept distributions")
    multi = beam_search_multi(model, batches, FAMILY_BEAM)
    gaps = []
    for batch, (got_o, got_l) in zip(batches, multi):
        want_o, want_l = beam_search(model, batch, FAMILY_BEAM)
        if not torch.equal(got_o, want_o):
            raise AssertionError("beam_search_multi: tokens differ from beam_search's")
        gaps.append(float((got_l - want_l).abs().max()))
    log(f"  return_probs on {b_s} images: kept distributions {tuple(probs.shape)}, every "
        f"best-beam step found at its word; beam_search_multi over "
        f"{[len(b['region_features']) for b in batches]} images: tokens equal to beam_search, "
        f"max |d log-prob| "
        f"{max(gaps):.3g}")
    return dict(return_probs_images=b_s,
                multi_images=[len(b["region_features"]) for b in batches],
                multi_max_logprob_gap=max(gaps))


def remainder_rdr():
    """The RDR segmenter on this host, from whichever library loads, on
    RDR_EXPECTED's strings with the lexicon, rules and SCRDR tree written
    to a temporary directory."""
    import tempfile

    from openviic_tpu_torch.data import rdr_segmenter

    with tempfile.TemporaryDirectory(prefix="chip_smoke_rdr_") as tmp:
        paths = {}
        for key, name, text in (("lexicon_path", "lexicon.txt", RDR_LEXICON),
                                ("rules_path", "rules.txt", RDR_RULES),
                                ("model_path", "model.rdr", RDR_SCRDR)):
            paths[key] = os.path.join(tmp, name)
            with open(paths[key], "w") as f:
                f.write(text)
        segmenters = {
            "rules": rdr_segmenter.RDRSegmenter(paths["lexicon_path"], paths["rules_path"]),
            "scrdr": rdr_segmenter.RDRSegmenter(model_path=paths["model_path"]),
        }
        segmenters["scrdr"].add_word("sinh học")
        for case, expected in RDR_EXPECTED.items():
            got = {k: segmenters[case].tokenize(k) for k in expected}
            if got != expected:
                raise AssertionError(f"rdr segmenter ({case}): {got} != {expected}")
    path = str(rdr_segmenter.library_path())
    log(f"  rdr segmenter: {sum(map(len, RDR_EXPECTED.values()))} strings as expected, "
        f"library {path}")
    return dict(library=path)


def remainder_import(device, s, vocab, request, card: str):
    """A synthetic run of the original code at the flagship's width (its
    ``state_dict`` under the original's names, with its decode buffers,
    and a torch Adam state after one update) imported by
    ``import_reference_checkpoint`` into a temporary directory, then
    ``CaptioningPipeline(config, checkpoint_dir=...)`` from there at beam
    3, bf16, the tuned path: captions equal to the same weights loaded
    directly; the Adam state's moments in the written ``last_model.ckpt``.
    The original names come from the port's own mapping
    (``torch_import.reference_name``), which the CPU tests hold to the JAX
    package's importer."""
    import pickle
    import tempfile

    from openviic_tpu_torch.builders import build_model
    from openviic_tpu_torch.compat.migrate import import_reference_checkpoint
    from openviic_tpu_torch.compat.torch_import import reference_name
    from openviic_tpu_torch.config import ConfigNode
    from openviic_tpu_torch.serving import CaptioningPipeline
    from openviic_tpu_torch.training import checkpoint as ckpt

    config = ConfigNode({
        "MODEL": dict(model_config(s).to_dict()["MODEL"], NAME="imported"),
        "TRAINING": {"EVALUATING_BEAM_SIZE": FAMILY_BEAM, "DECODE_HEAD_KERNEL": 1,
                     "DECODE_ATTN_KERNEL": True}})
    weights = build_model(config.MODEL, vocab, device="cpu", seed=41).state_dict()
    params = {reference_name(k): torch.nn.Parameter(v.clone()) for k, v in weights.items()}
    adam = torch.optim.Adam(params.values(), lr=1e-4, betas=(0.9, 0.98))
    gen = torch.Generator().manual_seed(42)
    for p in params.values():
        p.grad = torch.randn(p.shape, generator=gen) * 1e-3
    adam.step()
    state_dict = {k: p.detach() for k, p in params.items()}
    state_dict["decoder.running_seq"] = torch.zeros(1)  # a buffer the import skips
    payload = {"state_dict": state_dict, "optimizer": adam.state_dict(),
               "scheduler": {"_step_count": 2}, "epoch": 4, "use_rl": False, "patience": 0,
               "best_val_score": 0.5}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_import_") as tmp:
        run = os.path.join(tmp, "run")
        os.makedirs(run)
        with open(os.path.join(run, "vocab.bin"), "wb") as f:
            pickle.dump(vocab, f)
        torch.save(payload, os.path.join(run, "last_model.pth"))
        out = os.path.join(tmp, "imported")
        with quiet_port_logger():
            report = import_reference_checkpoint(config, os.path.join(run, "last_model.pth"),
                                                 out_dir=out, write_last=True, device=device)
            imported = CaptioningPipeline(config, checkpoint_dir=out, batch_size=s["batch"],
                                          device=device)
        import_s = time.perf_counter() - t0
        saved = ckpt.load_checkpoint(os.path.join(out, ckpt.LAST_NAME))
        mib = os.path.getsize(os.path.join(out, ckpt.BEST_NAME)) / 2**20
    n_moments = len(saved["optimizer"]["state"])
    if report["missing"] or report["unused"] or report["step"] != 1 or saved["epoch"] != 4:
        raise AssertionError(f"import: {report}")
    if n_moments != len(weights):
        raise AssertionError(f"import: {n_moments} Adam states for {len(weights)} parameters")
    # the same numbers loaded by name, the import's mapping aside
    direct = CaptioningPipeline.from_state_dict(
        config, vocab, state_dict={k: state_dict[reference_name(k)] for k in weights},
        batch_size=s["batch"], device=device)
    got, want = imported.caption_features(request), direct.caption_features(request)
    if got != want:
        raise AssertionError(f"import: {np.mean([a == b for a, b in zip(got, want)]):.4f} of "
                             "the captions equal to the directly loaded weights'")
    log(f"  import of an original-code run at full width: {len(weights)} tensors and their "
        f"Adam moments, {mib:.1f} MiB, {import_s:.3f} s to the loaded pipeline on {card}; "
        f"{len(request)} captions equal to the directly loaded weights'")
    return dict(tensors=len(weights), checkpoint_mib=mib, seconds=import_s)


def remainder_phase(device, s, card: str):
    """The modules of the single-card remainder (``remainder_config``: the
    flagship with the Switch MoE on every FFN and ``LSTMTextEmbedding``;
    random weights from a seed; beam 3; bf16), one request of
    ``s["batch"]`` images of ``s["n_regions"]`` regions through
    ``CaptioningPipeline`` (the rehearsal: FAMILY_REHEARSAL's 2 images and
    6 steps):

    - the tuned path (head kernel forced, beam-select kernel on) against
      eager fast select: launches per step, valid ids, score parity,
      captions/s; ``OPENVIIC_PALLAS=1``: fused_attention once an encoder
      layer and request; the forced decode of the tuned captions through
      the attention kernel and under ``OPENVIIC_PALLAS=1`` against the
      eager step;
    - ``resident_kernel`` and ``OPENVIIC_FUSED_STEP=1`` raise the MoE
      ``ValueError`` (where the JAX package's weight pack fails), no kernel
      launched;
    - head_topk, beam_select_attention and fused_attention on their inputs
      captured from these decodes against their plain versions, timed
      beside their bounds;
    - f32 on the card against its host's CPU on FAMILY_F32_IMAGES images
      (>= FAMILY_F32_AGREEMENT_MIN identical; the card only);
    - ``family_xe``'s bf16 XE steps, with the MoE layers' aux losses;
    - ``return_probs`` and ``beam_search_multi``
      (``remainder_probs_and_multi``), the RDR segmenter
      (``remainder_rdr``) and the import of an original-code run
      (``remainder_import``).

    Returns {"launches": {kernel: {path: n}}, "kernels": cases,
    "figures": ...}."""
    import importlib

    from openviic_tpu_torch.decoding import BeamSearcher
    from openviic_tpu_torch.models import attention as attention_module
    from openviic_tpu_torch.models.decoders import MOE_LAYER_KERNEL
    from openviic_tpu_torch.serving import CaptioningPipeline

    beam_search_module = importlib.import_module("openviic_tpu_torch.decoding.beam_search")
    t0 = time.perf_counter()
    name, cuda = REMAINDER_NAME, device.type == "cuda"
    if not cuda:
        s = dict(s, **FAMILY_REHEARSAL)
    vocab = make_vocab(s)
    rng = np.random.default_rng(17)
    feats = rng.standard_normal((s["batch"] + REMAINDER_SMALL, s["n_regions"], s["d_feature"]),
                                dtype=np.float32)
    request = [{"region_features": f} for f in feats[:s["batch"]]]
    small = [{"region_features": f} for f in feats[s["batch"]:]]
    requests = [request]
    pipe = CaptioningPipeline.from_state_dict(remainder_config(s), vocab, batch_size=s["batch"],
                                              device=device, seed=40)
    model = pipe.model
    n_dec, n_enc = len(model.decoder.layers), len(model.encoder.layers)
    per_path = {}

    def run(path, searcher, decode, **expect):
        results, counts = drive(f"{name} {path}", device, s, vocab, requests, searcher, decode,
                                card, **expect)
        per_path[path] = {k: v for k, v in counts.items() if v}
        return results

    def searched(searcher):
        return searcher_decode(pipe, searcher, vocab, FAMILY_BEAM)

    served = lambda r: pipe.caption_features(r, return_ids=True)  # noqa: E731
    # the kernels' inputs are captured while the rescoring decodes run
    captures = [("head_topk", beam_search_module, "head_topk", 1, 0),
                ("beam_select_attention", attention_module, "beam_select_attention", n_dec, 0)]
    tuned = run("tuned", pipe.searcher, served,
                per_step={"head_topk": 1, "beam_select_attention": n_dec})
    with contextlib.ExitStack() as stack:
        kept = {key: stack.enter_context(capture_calls(mod, attr, every, first))
                for key, mod, attr, every, first in captures}
        tuned = rescore(device, requests, searched(pipe.searcher), tuned, f"{name} tuned")
    eager_searcher = BeamSearcher(model, torch.bfloat16)
    eager = run("eager", eager_searcher, searched(eager_searcher))
    score_parity(f"{name} tuned", tuned, eager, "its eager twin")
    with env_flag("OPENVIIC_PALLAS"):
        res_d = run("OPENVIIC_PALLAS=1", pipe.searcher, served,
                    per_step={"head_topk": 1, "beam_select_attention": n_dec},
                    per_request={"fused_attention": n_enc})
        with capture_calls(attention_module, "fused_attention", 10 ** 9, 0) as enc_kept:
            res_d = rescore(device, requests, searched(pipe.searcher), res_d, f"{name} pallas")
    kept["fused_attention_encoder"] = enc_kept
    score_parity(f"{name} OPENVIIC_PALLAS=1", res_d, tuned, "its tuned path")

    ids = torch.from_numpy(tuned[0][1]).to(device)
    batch = pipe._batch(request)
    eager_step = forced_scores(model, batch, ids, vocab, True)
    check_forced(f"{name} attention kernel against the eager step", ids, vocab,
                 forced_scores(model, batch, ids, vocab, True, attn_kernel=True), eager_step)
    with env_flag("OPENVIIC_PALLAS"):
        check_forced(f"{name} OPENVIIC_PALLAS=1 against the eager step", ids, vocab,
                     forced_scores(model, batch, ids, vocab, True), eager_step)

    counted = counted_wrappers()
    for path, flag, searcher in (
            ("(b) resident_kernel", None,
             BeamSearcher(model, torch.bfloat16, head_kernel=1, resident_kernel=True)),
            ("(c) non-resident, OPENVIIC_FUSED_STEP=1", "OPENVIIC_FUSED_STEP",
             BeamSearcher(model, torch.bfloat16, beam_resident=False))):
        for fn in counted:
            fn.launches = 0
        with env_flag(flag) if flag else contextlib.nullcontext():
            try:
                searcher(batch, FAMILY_BEAM)
            except ValueError as exc:
                if str(exc) != MOE_LAYER_KERNEL:
                    raise
            else:
                raise AssertionError(f"{name} {path} ran on the MoE decoder")
        launched = {fn.__name__: fn.launches for fn in counted if fn.launches}
        if launched:
            raise AssertionError(f"{name} {path}: launches {launched} before the refusal")
        per_path[path] = {}
        log(f"  {name} {path} raises, as the JAX package fails there: {MOE_LAYER_KERNEL}")

    cases = trained_kernel_cases(device, kept, what=f"{name} decode")

    f32_same = None
    if cuda:
        few = request[:FAMILY_F32_IMAGES]

        def f32_captions(dev):
            return CaptioningPipeline.from_state_dict(
                remainder_config(s, kernels=False), vocab, batch_size=len(few), use_bf16=False,
                device=dev, seed=40).caption_features(few)
        card_caps, cpu_caps = f32_captions(device), f32_captions("cpu")
        f32_same = float(np.mean([a == b for a, b in zip(card_caps, cpu_caps)]))
        log(f"  {name} f32 decode of {len(few)} images: captions identical on the card and "
            f"its host's CPU {f32_same:.4f}")
        if f32_same < FAMILY_F32_AGREEMENT_MIN:
            raise AssertionError(f"{name} f32 card against CPU: {f32_same:.4f} identical < "
                                 f"{FAMILY_F32_AGREEMENT_MIN}")
    figures = dict(launches=per_path, f32_card_cpu_agreement=f32_same,
                   captions_identical_tuned_eager=agreement(tuned, eager))
    figures.update(remainder_probs_and_multi(pipe.searcher.shadow(model), [request, small]))
    del pipe, model, eager_searcher, batch, ids
    figures["xe"] = family_xe(device, s, name, vocab, card, remainder_config(s).MODEL)
    figures["rdr"] = remainder_rdr()
    figures["import"] = remainder_import(device, s, vocab, small, card)
    launches = {fn.__name__: {path: counts.get(fn.__name__, 0)
                              for path, counts in per_path.items()}
                for fn in counted}
    figures["seconds"] = time.perf_counter() - t0
    log(f"  {name}: {figures['seconds']:.3f} s")
    return dict(launches=launches, kernels=cases, figures=figures)


# ---------------------------------------------------------------- phase 18
DP_DRYRUN = dict(global_batch=XE_BATCH, steps=6, save_at=3)  # 30 rows a rank over two
DP_REHEARSAL = dict(global_batch=2, steps=2, save_at=1)
DP_RANKS = 2  # two ranks on the one card, over gloo (NCCL refuses two ranks a device)
DP_TRAINER_BATCH = 30  # FEATURE_BATCH_SIZE, each rank's share of phase 13's 60
DP_TRAINER_DICT = 75  # DICT_BATCH_SIZE: 15 images a rank an SCST iteration at beam 5
DP_TRAINER_EPOCHS = 2  # XE, the switch (PATIENCE 0), one SCST epoch
DP_TRAINER_REGIONS = 40  # MAX_REGIONS: the artifact's most regions, pinned on every rank
DP_RANK_TIMEOUT = 600


def dryrun_options(s, cuda: bool, nprocs: int, backend: str, exact: bool = False):
    """``parallel/dryrun.py``'s options at ``s``'s widths: over NCCL its
    default device (``cuda:<LOCAL_RANK>``), over gloo every rank on the
    card (the rehearsal: on the CPU, in this process)."""
    from openviic_tpu_torch.parallel import dryrun

    run = DP_DRYRUN if cuda else DP_REHEARSAL
    device = ("cuda" if backend == "nccl" else "cuda:0") if cuda else "cpu"
    argv = ["--nprocs", str(nprocs), "--backend", backend, "--device", device, "--d-model", str(s["d_model"]), "--heads",
            str(s["heads"]), "--layers", str(s["layers"]), "--d-ff", str(s["d_ff"]),
            "--d-feature", str(s["d_feature"]), "--regions", str(s["n_regions"]), "--vocab",
            str(s["vocab"]), "--max-len", str(s["max_len"]), "--global-batch",
            str(run["global_batch"]), "--steps", str(run["steps"]), "--save-at",
            str(run["save_at"]), "--warmup", str(XE_WARMUP), "--timeout", str(DP_RANK_TIMEOUT)]
    if nprocs == 1:
        argv.append("--in-process")
    if exact:
        argv.append("--exact")
    return dryrun.parse(argv)


def dp_dryrun_part(device, s, card: str) -> dict:
    """(a) The dry run at ``s``'s widths, f32, dropout 0, global batch
    DP_DRYRUN's: two ranks over gloo on the card (their losses within 1e-5
    of one process on the same global batches, parameters bit-equal across
    ranks, the rank-0 checkpoint's resume bit-identical on every rank), then
    one rank over NCCL in this process, bit-equal to one process.  The
    rehearsal runs the second over gloo on the CPU.  Each run's ms a step
    (the median past the first) and the all-reduce's ms and MiB a step."""
    from openviic_tpu_torch.parallel import dryrun

    cuda = device.type == "cuda"
    runs = {}
    if cuda:
        runs["gloo_2"] = dryrun.run(dryrun_options(s, True, DP_RANKS, "gloo"))
    runs["nccl_1" if cuda else "gloo_1"] = dryrun.run(
        dryrun_options(s, cuda, 1, "nccl" if cuda else "gloo", exact=True))
    for name, r in runs.items():
        log(f"  dry run {name} ({r['nprocs']} rank(s) over {r['backend']} on {r['device']}, "
            f"global batch {(DP_DRYRUN if cuda else DP_REHEARSAL)['global_batch']}): losses "
            f"{[round(x, 6) for x in r['losses']]}, one process's relative gap "
            f"{r['loss_rel_gap']:.3g}; ms a step: one process {r['single_ms']:.2f}, the ranks "
            f"{[round(x, 2) for x in r['ranks_ms']]}; gradient all-reduce "
            f"{[round(x, 2) for x in r['allreduce_ms']]} ms and "
            f"{r['allreduce_mib_per_step']:.2f} MiB a step on {card}")
    return runs


def dp_trainer_config(data: str, checkpoint_path: str):
    """Phase 13's trainer config with the data-parallel keys: the grain
    loader, pinned regions, each rank's batch."""
    cfg = trainer_config(data, checkpoint_path, FLAGSHIP, True, TRAINER_LOG_EVERY).to_dict()
    cfg["DATASET"].update(LOADER="grain", MAX_REGIONS=DP_TRAINER_REGIONS,
                          FEATURE_BATCH_SIZE=DP_TRAINER_BATCH, DICT_BATCH_SIZE=DP_TRAINER_DICT)
    from openviic_tpu_torch.config import ConfigNode

    return ConfigNode(cfg)


def dp_trainer_rank(device, root: str) -> None:
    """One rank of part (b), in a process of its own (``--dp-trainer-rank``,
    torchrun's variables set by the parent): ``BaseTrainer`` over gloo on
    ``root``'s dataset with the artifact's weights, DP_TRAINER_EPOCHS
    epochs and the test predictions; its result in ``root/rank<r>.json``:
    phases, decisions, whether its scores agreed with rank 0's, each
    epoch's seconds, the files it wrote, the kernels' launches against the
    decode steps, and on rank 0 the kernels on their captured inputs
    against their plain versions."""
    import builtins

    from openviic_tpu_torch.artifact import load_trained_artifact
    from openviic_tpu_torch.builders import build_trainer
    from openviic_tpu_torch.parallel import runtime
    from openviic_tpu_torch.training import checkpoint as ckpt
    from openviic_tpu_torch.training import trainer as trainer_module
    from openviic_tpu_torch.utils import setup_logger

    runtime.initialize_distributed(device, backend="gloo")
    rank = runtime.process_index()
    setup_logger().setLevel(logging.WARNING)
    writes = {"files": {}, "saves": 0, "copies": 0}

    def counted_open(path, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+"):
            name = os.path.basename(path)
            writes["files"][name] = writes["files"].get(name, 0) + 1
        return builtins.open(path, mode, *args, **kwargs)

    save, copy = ckpt.NativeBackend.save_checkpoint, ckpt.NativeBackend.copy

    def counted(key, fn):
        def run(*args, **kwargs):
            writes[key] += 1
            return fn(*args, **kwargs)
        return run

    trainer_module.open = counted_open
    ckpt.NativeBackend.save_checkpoint = counted("saves", save)
    ckpt.NativeBackend.copy = counted("copies", copy)
    try:
        loaded = load_trained_artifact(device="cpu")
        tr = build_trainer(dp_trainer_config(os.path.join(root, "data"),
                                             os.path.join(root, "run")), device=device)
        tr.model.load_state_dict(loaded["state_dict"])
        n_layers = len(tr.model.decoder.layers)
        captured = {}
        capture = (trainer_captures(True, n_layers, captured) if rank == 0
                   else (lambda label: contextlib.nullcontext()))
        rec, iterations, decisions, agreed = {"epochs": {}}, [], [], []
        clock_trainer(tr, device, rec, capture)
        clocked_save = tr.save_checkpoint

        def save_checkpoint(extras):
            decisions.append({"epoch": tr.epoch, **extras})
            agreed.append(tr.scores_agreed)
            return clocked_save(extras)

        tr.save_checkpoint = save_checkpoint
        kernels = counted_wrappers()
        for fn in kernels:
            fn.launches = 0
        steps0 = tr.beam_searcher.steps
        with clocked_trainer_module(device, tr, rec, iterations, capture):
            tr.start(max_epochs=DP_TRAINER_EPOCHS)
        t0 = time.perf_counter()
        tr.get_predictions()
        sync(device)
        predictions_s = time.perf_counter() - t0
        steps = tr.beam_searcher.steps - steps0
        launches = {fn.__name__: fn.launches for fn in kernels}
        runtime.barrier("dp_trainer_done")  # rank 0 times its cases with the card to itself
        cases = {}
        for what, kept in captured.items():
            for kernel, rows in trained_kernel_cases(device, kept, what).items():
                cases.setdefault(kernel, []).extend(
                    dict(r, case=f"{what} {r['case']}") for r in rows)
        result = {"rank": rank, "phases": [r.get("phase") for _, r in
                                           sorted(rec["epochs"].items())],
                  "decisions": decisions, "agreed": agreed, "steps": steps,
                  "n_layers": n_layers, "launches": launches, "writes": writes,
                  "metrics_file": tr.metrics._file.name, "captured": sorted(captured),
                  "epochs": {str(e): r for e, r in rec["epochs"].items()},
                  "scst_iterations": len(iterations), "predictions_s": predictions_s,
                  "test_results": os.path.isfile(os.path.join(tr.checkpoint_path,
                                                              "test_results.json")),
                  "kernels": cases}
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        runtime.shutdown()


def dp_trainer_part(device, s, card: str, loaded) -> dict:
    """(b) ``BaseTrainer`` across DP_RANKS processes on the card over gloo,
    on phase 13's data (the artifact's images 90 / 30 / 30, its vocab
    copied into the run directory and its weights, the tuned twin's
    TRAINING keys, PATIENCE 0) with ``LOADER: grain``, MAX_REGIONS pinned,
    FEATURE_BATCH_SIZE DP_TRAINER_BATCH a rank and DICT_BATCH_SIZE
    DP_TRAINER_DICT: XE, the switch, one SCST epoch and the test
    predictions (``dp_trainer_rank``).  Every rank must exit 0 within
    DP_RANK_TIMEOUT (a rank that hangs is killed and the phase fails),
    take the same phases and decisions with scores that agree with rank
    0's, launch head_topk once a decode step and beam_select_attention once
    a layer and step; rank 0 alone writes the checkpoints,
    ``metrics.jsonl`` and ``test_results.json`` (the vocab is the
    artifact's, written by none); both kernels are held against their
    plain versions on rank 0's captured inputs.  Prints each rank's epoch
    seconds."""
    import shutil
    import tempfile

    from openviic_tpu_torch import artifact
    from openviic_tpu_torch.parallel import dryrun

    tmp = tempfile.mkdtemp(prefix="openviic_dp_trainer_")
    try:
        counts = trainer_dataset(os.path.join(tmp, "data"), loaded, TRAINER_SPLIT)
        run_dir = os.path.join(tmp, "run", TRAINER_NAME)
        os.makedirs(run_dir)
        shutil.copyfile(artifact.ARTIFACT_DIR / "vocab.bin", os.path.join(run_dir, "vocab.bin"))
        dryrun.wait(dryrun.start([os.path.abspath(__file__), "--dp-trainer-rank", tmp],
                                 DP_RANKS, tmp), tmp, DP_RANK_TIMEOUT)
        ranks = []
        for rank in range(DP_RANKS):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  data-parallel trainer data: {counts} (images, annotations) as train, dev, test; "
        f"{DP_RANKS} ranks over gloo on {card}")
    failures = []
    zero = ranks[0]
    for r in ranks:
        for e, rec in sorted(r["epochs"].items(), key=lambda kv: int(kv[0])):
            log(f"  rank {r['rank']} epoch {e} ({rec.get('phase')}, {rec.get('steps')} steps): "
                f"loss {rec.get('loss', float('nan')):.5f}; seconds: train "
                f"{rec.get('train', 0):.3f}, val loss {rec.get('val_loss', 0):.3f}, val decode "
                f"+ scoring {rec.get('val_metrics', 0):.3f}, checkpoint save "
                f"{rec.get('save', 0):.3f}")
        want = {fn.__name__: 0 for fn in counted_wrappers()}
        want.update(head_topk=r["steps"], beam_select_attention=r["n_layers"] * r["steps"])
        log(f"  rank {r['rank']}: phases {r['phases']}, {r['scst_iterations']} SCST iterations, "
            f"test predictions {r['predictions_s']:.3f} s, {r['steps']} decode steps, launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }, scores agreed with rank 0's "
            f"{r['agreed']}, writes {r['writes']}")
        if r["launches"] != want or r["steps"] <= 0:
            failures.append(f"rank {r['rank']}: launches {r['launches']}, expected {want}")
        if r["phases"] != ["xe", "scst"] or r["decisions"] != zero["decisions"]:
            failures.append(f"rank {r['rank']}: phases {r['phases']}, decisions "
                            f"{r['decisions']} against rank 0's {zero['decisions']}")
        if not all(r["agreed"]) or not r["test_results"]:
            failures.append(f"rank {r['rank']}: scores agreed {r['agreed']}, test_results.json "
                            f"{r['test_results']}")
    bests = sum(d["patience"] == 0 for d in zero["decisions"])
    want_zero = {"files": {"test_results.json": 1}, "saves": len(zero["decisions"]),
                 "copies": bests}
    if zero["writes"] != want_zero or any(r["writes"] != {"files": {}, "saves": 0, "copies": 0}
                                          for r in ranks[1:]):
        failures.append(f"writes {[r['writes'] for r in ranks]}: rank 0 must write "
                        f"{want_zero} and the others nothing")
    if (not zero["metrics_file"].endswith("metrics.jsonl")
            or any(r["metrics_file"] != os.devnull for r in ranks[1:])):
        failures.append(f"metrics files {[r['metrics_file'] for r in ranks]}")
    if set(zero["captured"]) != {"trainer val decode", "trainer test prediction",
                                 "trainer SCST iteration 2"} or not all(
            zero["kernels"].get(k) for k in ("head_topk", "beam_select_attention")):
        failures.append(f"rank 0's kernel cases from {zero['captured']}")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"ranks": ranks}


def dp_serving_part(device, s, card: str) -> dict:
    """(c) ``CaptioningPipeline`` over a mesh: ``mesh="auto"`` on the card
    (every visible card: this one) at bf16 with the head kernel forced and
    the attention kernel on, its captions bit-equal to the pipeline without
    a mesh, head_topk once a decode step and beam_select_attention once a
    layer and step; ``mesh=[the card, the card]`` at f32 (the eager path),
    each half of the batch decoded on its own, bit-equal to the unsharded
    f32 pipeline.  The rehearsal serves ``["cpu", "cpu"]`` at f32 only."""
    from openviic_tpu_torch.serving import CaptioningPipeline

    cuda = device.type == "cuda"
    vocab = make_vocab(s)
    rng = np.random.default_rng(18)
    feats = rng.standard_normal((s["batch"], s["n_regions"], s["d_feature"]), dtype=np.float32)
    images = [{"region_features": f} for f in feats]
    launches, out = {}, {}

    def compare(name, config, mesh, **kw):
        plain = CaptioningPipeline.from_state_dict(config, vocab, batch_size=s["batch"],
                                                   device=device, seed=0, **kw)
        meshed = CaptioningPipeline.from_state_dict(config, vocab, batch_size=s["batch"],
                                                    device=device, seed=0, mesh=mesh, **kw)
        want = plain.caption_features(images, return_ids=True)
        if cuda:
            meshed.caption_features(images[:7])  # warm-up: cuBLAS handles, allocator
        sync(device)
        kernels = counted_wrappers()
        for fn in kernels:
            fn.launches = 0
        steps0 = sum(sr.steps for _, sr, _ in meshed._replicas)
        t0 = time.perf_counter()
        got = meshed.caption_features(images, return_ids=True)
        sync(device)
        seconds = time.perf_counter() - t0
        steps = sum(sr.steps for _, sr, _ in meshed._replicas) - steps0
        counts = {fn.__name__: fn.launches for fn in kernels}
        same = got[0] == want[0] and np.array_equal(got[1], want[1])
        log(f"  {name}: mesh {mesh} ({len(meshed._replicas)} slices of "
            f"{s['batch'] // len(meshed._replicas)}): captions and ids equal to the unsharded "
            f"pipeline's: {same}; {steps} decode steps, launches "
            f"{ {k: v for k, v in counts.items() if v} }, {s['batch'] / seconds:.1f} captions/s "
            f"on {card}")
        if not same:
            raise AssertionError(f"{name}: the sharded captions differ from the unsharded ones")
        return counts, steps, seconds

    if cuda:
        counts, steps, seconds = compare("serving mesh auto (bf16, kernels)",
                                         model_config(s, attn_kernel=True), "auto")
        want = {fn.__name__: 0 for fn in counted_wrappers()}
        want.update(head_topk=steps, beam_select_attention=s["layers"] * steps)
        if counts != want:
            raise AssertionError(f"serving mesh auto: launches {counts}, expected {want}")
        launches["serving_auto"] = counts
        out["auto_captions_per_s"] = s["batch"] / seconds
    pair = [str(device)] * 2
    _, _, seconds = compare("serving mesh of the device twice (f32, eager)", model_config(s),
                            pair, use_bf16=False, head_kernel=False)
    out["twice_f32_captions_per_s"] = s["batch"] / seconds
    return {"launches": launches, "figures": out}


def data_parallel_phase(device, s, card: str, loaded) -> dict:
    """Phase 18: data-parallel training across processes and serving over
    a device list (``dp_dryrun_part``, ``dp_trainer_part`` on the card
    only, ``dp_serving_part``).  Returns each kernel's launches in the
    phase, rank 0's kernel cases and the figures."""
    cuda = device.type == "cuda"
    dryruns = timed("data parallel (a): dry run", lambda: dp_dryrun_part(device, s, card))
    trainer = (timed("data parallel (b): trainer across two ranks",
                     lambda: dp_trainer_part(device, s, card, loaded)) if cuda else None)
    serving = timed("data parallel (c): serving over a device list",
                    lambda: dp_serving_part(device, s, card))
    launches = {fn.__name__: {} for fn in counted_wrappers()}
    for name in launches:
        if trainer is not None:
            for r in trainer["ranks"]:
                launches[name][f"trainer_rank{r['rank']}"] = r["launches"][name]
        for path, counts in serving["launches"].items():
            launches[name][path] = counts[name]
    figures = {"dryrun": dryruns, "serving": serving["figures"]}
    kernels = {}
    if trainer is not None:
        figures["trainer"] = [{k: r[k] for k in ("rank", "phases", "epochs", "steps",
                                                 "predictions_s", "writes")}
                              for r in trainer["ranks"]]
        kernels = trainer["ranks"][0]["kernels"]
    return {"launches": launches, "kernels": kernels, "figures": figures}


LAYOUTS = dict(global_batch=XE_BATCH, steps=6, images=64, beam=3, microbatches=4)
LAYOUTS_RANK_TIMEOUT = 600


def layouts_options(s, cuda: bool, backend: str = "gloo", capture=None):
    """``parallel/layouts_dryrun.py``'s options at ``s``'s widths: every rank
    on the card (over gloo: NCCL takes one rank a device), LAYOUTS' sizes,
    the MoE of phase 17 (REMAINDER_EXPERTS experts)."""
    from openviic_tpu_torch.parallel import layouts_dryrun

    argv = ["--device", "cuda:0" if cuda else "cpu", "--backend", backend,
            "--d-model", str(s["d_model"]), "--heads", str(s["heads"]),
            "--layers", str(s["layers"]), "--d-ff", str(s["d_ff"]),
            "--d-feature", str(s["d_feature"]), "--regions", str(s["n_regions"]),
            "--vocab", str(s["vocab"]), "--max-len", str(s["max_len"]),
            "--warmup", str(XE_WARMUP), "--experts", str(REMAINDER_EXPERTS),
            "--timeout", str(LAYOUTS_RANK_TIMEOUT)]
    for key, value in LAYOUTS.items():
        argv += ["--" + key.replace("_", "-"), str(value)]
    if capture is not None:
        argv += ["--capture", capture]
    return layouts_dryrun.parse(argv)


def model_parallel_phase(device, s, card: str) -> dict:
    """Phase 19: the model-parallel layouts across processes
    (``parallel/layouts_dryrun.py``: four gloo ranks on the card, each case
    against one process on the card), then ``head_topk`` on rank 0's vocab
    shard at decode steps 0, 12 and 24 and ``fused_attention`` on rank 0's
    first tensor-parallel encoder call and first pipeline-stage call,
    each against its plain version and timed beside its bound; last, one
    NCCL rank in this process, every axis of size 1, bit-equal to no
    group.  The rehearsal runs that last check only, over gloo on the CPU.
    Returns each kernel's launches in the phase, rank 0's kernel cases and
    the figures."""
    import shutil
    import tempfile

    from openviic_tpu_torch.parallel import layouts_dryrun

    cuda = device.type == "cuda"
    launches = {fn.__name__: {} for fn in counted_wrappers()}
    kernels, figures = {}, {}
    if cuda:
        capture = tempfile.mkdtemp(prefix="openviic_layouts_capture_")
        try:
            figures = timed("model parallel (a)-(f): four gloo ranks on the card",
                            lambda: layouts_dryrun.run(layouts_options(s, True,
                                                                       capture=capture)))
            captured = torch.load(os.path.join(capture, "captured.pt"), map_location=device,
                                  weights_only=False)
        finally:
            shutil.rmtree(capture, ignore_errors=True)
        for key, value in figures.items():
            log(f"  {key}: {json.dumps(value)}")
        head = captured["head_topk"]
        last = max(head)
        head = dict(head, last=(last, head[last]))
        kernels = trained_kernel_cases(device, {"head_topk": head, "fused_attention_encoder":
                                                captured["fused_attention_tp"]},
                                       what="model parallel, rank 0's shard")
        pipe = trained_kernel_cases(device, {"fused_attention_encoder":
                                             captured["fused_attention_pipe"]},
                                    what="model parallel, pipeline stage 0")
        kernels["fused_attention"] += pipe["fused_attention"]
        launches["head_topk"]["tp_decode_per_rank"] = figures["decode"]["head_topk_launches"]
        launches["fused_attention"].update(
            tp_encoder_per_rank=figures["pallas"]["launches"],
            pipeline_per_stage=figures["pipe"]["flag_launches"])
    single = timed(f"model parallel (g): one {'NCCL' if cuda else 'gloo'} rank in this process",
                   lambda: layouts_dryrun.single_rank(
                       layouts_options(s, cuda, "nccl" if cuda else "gloo")))
    log(f"  one {single['backend']} rank, every axis of size 1: bit-equal to no group in "
        f"{single['bit_equal']}")
    figures["single_rank"] = single
    for name in launches:  # 0 where a kernel does not run
        for path in ("tp_decode_per_rank", "tp_encoder_per_rank", "pipeline_per_stage"):
            launches[name].setdefault(path, 0)
    return {"launches": launches, "kernels": kernels, "figures": figures}


# ---------------------------------------------------------------- phase 21
TP_FAMILY_BATCH = 16  # phase 21's f32 XE step
TP_FAMILY_F32_IMAGES = 16


def geo_captured_case(device, call, what: str) -> dict:
    """``geo_fused_attention`` on a call captured from a decode, against its
    plain version under the geo phase's gate, timed beside its bound and
    the materialised path (box embedding + fc_gs + SDPA)."""
    from openviic_tpu_torch.ops.geo_attention import (
        geo_fused_attention, geo_fused_attention_reference, kernel_route)

    args, kwargs = call
    args = tuple(args) + (kwargs["sm_scale"],)
    q, k, v, wg = args[0], args[1], args[2], args[4]
    got, want = geo_fused_attention(*args), geo_fused_attention_reference(*args)
    sync(device)
    err, ulps, _ = ulp_errors(got, want)
    beyond = float(((got.float() - want.float()).abs()
                    > GEO_ULPS * bf16_ulp(want.float().abs().clamp_min(ULP_FLOOR))).float().mean())
    dim_g = wg.shape[0]
    route = kernel_route(*(t.to(torch.bfloat16) for t in (q, k, v)), dim_g // 8)
    log(f"  geo_fused_attention, {what}: q {tuple(q.shape)} {str(q.dtype)[6:]}, fc_g "
        f"{tuple(wg.shape)} at strides {wg.stride()} (route {route}): max |err| {err:.3g} = "
        f"{ulps:.2f} bf16 ulps, {beyond:.2e} beyond {GEO_ULPS}")
    if not torch.isfinite(got).all() or err > GEO_ATOL or beyond > 1 - GEO_SHARE:
        raise AssertionError(f"geo_fused_attention, {what}: max |err| {err:.3g}, {beyond:.4f} "
                             f"of the elements beyond {GEO_ULPS} bf16 ulps")
    work = geo_bound(q, dim_g)
    bound_ms, bound_by = work["bound_ms"], work["bound_by"]
    r = dict(case=f"{what} q {tuple(q.shape)}", max_abs_err=err, route=route,
             ms=time_cuda(lambda: geo_fused_attention(*args), 20, graph=True),
             plain_ms=time_cuda(lambda: geo_fused_attention_reference(*args), 3, graph=True),
             bound_ms=bound_ms, bound_by=bound_by,
             library_ms=time_cuda(geo_library(*args), 20, graph=True))
    log(f"  geo_fused_attention {r['case']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
        f"ms, library {r['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return r


def tensor_parallel_families_phase(device, s, card: str) -> dict:
    """Phase 21: tensor parallelism on every family and the decode's kernels
    under a ``model`` axis (``parallel/layouts_dryrun.py --family all``:
    four gloo ranks on the card, two {model 2} meshes side by side and one
    {model 4}, each case against one process on the card), then rank 0's
    captured inputs of the four kernels that run there anew (the
    beam-select kernel at {model 2}, its fast kernel, and {model 4}, its
    general one; both layer steps from the weights gathered whole; the
    geometry kernel on the rank's heads) against their plain versions,
    timed beside their bounds.  The card only: the rehearsal leaves it to
    the CPU tests (``tests/test_torch_port_tensor_parallel_families.py``).
    Returns each kernel's launches a rank, rank 0's kernel cases and the
    figures."""
    import shutil
    import tempfile

    from openviic_tpu_torch.parallel import layouts_dryrun

    launches = {fn.__name__: {} for fn in counted_wrappers()}
    if device.type != "cuda":
        log("  tensor-parallel families: on the card only (the CPU tests hold them to JAX)")
        return {"launches": launches, "kernels": {}, "figures": {}}
    capture = tempfile.mkdtemp(prefix="openviic_tp_families_capture_")
    try:
        opts = layouts_options(s, True, capture=capture)
        opts.family, opts.family_batch, opts.f32_images = "all", TP_FAMILY_BATCH, \
            TP_FAMILY_F32_IMAGES
        opts.lm_hidden, opts.lm_vocab = s["lm_hidden"], s["lm_vocab"]
        figures = layouts_dryrun.run(opts)
        captured = torch.load(os.path.join(capture, "captured.pt"), map_location=device,
                              weights_only=False)
    finally:
        shutil.rmtree(capture, ignore_errors=True)
    for name, fig in figures["families"].items():
        log(f"  {name}: {json.dumps(fig)}")
    log(f"  paths: {json.dumps(figures['paths'])}")
    log(f"  one process {figures['references_s']:.1f} s, the ranks {figures['ranks_s']:.1f} s")
    t = layouts_dryrun.CAPTURE_STEPS[1]

    def one_step(key, kernel):
        (index, call), = captured[key].items()
        return {kernel: {t: call, "last": (t, call)}}

    kernels = {}
    for key, kernel, what in (
            ("flagship_tuned", "beam_select_attention", "tensor parallel {model 2}, rank 0"),
            ("flagship_tuned_model4", "beam_select_attention",
             "tensor parallel {model 4}, rank 0"),
            ("flagship_resident", "resident_layer_step", "tensor parallel {model 2}, rank 0"),
            ("flagship_fused", "fused_layer_step", "tensor parallel {model 2}, rank 0")):
        for name, rows in trained_kernel_cases(device, one_step(key, kernel), what=what).items():
            kernels.setdefault(name, []).extend(rows)
    (_, geo_call), = captured["ort_trig_geo"].items()
    kernels["geo_fused_attention"] = [geo_captured_case(
        device, geo_call, "tensor parallel {model 2}, rank 0's heads")]
    flagship = figures["families"]["flagship"]["paths"]
    launches["beam_select_attention"].update(
        tp_model2_per_rank=flagship["tuned"]["launches"]["beam_select_attention"],
        tp_model4_per_rank=figures["paths"]["tuned_model4"]["launches"]["beam_select_attention"],
        tp_families_per_rank={n: f["paths"]["tuned"]["launches"]["beam_select_attention"]
                              for n, f in figures["families"].items()})
    launches["head_topk"]["tp_families_per_rank"] = {
        n: f["paths"]["tuned"]["launches"]["head_topk"] for n, f in figures["families"].items()}
    launches["resident_layer_step"]["tp_model2_per_rank"] = \
        flagship["resident"]["launches"]["resident_layer_step"]
    launches["fused_layer_step"]["tp_model2_per_rank"] = \
        flagship["fused"]["launches"]["fused_layer_step"]
    launches["geo_fused_attention"]["tp_model2_per_rank"] = \
        figures["families"]["ort_trig"]["paths"]["geo"]["launches"]["geo_fused_attention"]
    for name, counts in launches.items():
        total = sum(sum(v.values()) if isinstance(v, dict) else v for v in counts.values())
        if name != "fused_attention" and not total:
            raise AssertionError(f"{name} was not launched under the model axis: {counts}")
    return {"launches": launches, "kernels": kernels, "figures": figures}


# ---------------------------------------------------------------- phase 20
BACKENDS_EPOCHS = 2  # XE, the switch (PATIENCE 0), one SCST epoch
BACKENDS_SERVE_IMAGES = 30  # phase 13's test images, served from both checkpoints
VECTORS_NAME = "PhoW2VSyllable300"  # a registered 300-d class: the file's name and width
VECTORS_SEED = 20
LOCAL_RANK_TIMEOUT = 600
LOCAL_LOSS_RTOL = 1e-5
# phase 20 (d)'s SCST images a batch: 90 train images make batches of 43,
# 43 and 4, so two run whole on both ranks (43 is odd) and one is split
LOCAL_SCST_IMAGES = 43


def directory_mib(path: str) -> float:
    return sum(os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(path)
               for f in files) / 2**20


def orbax_trainer_part(device, s, card: str, loaded, native_epochs: dict) -> dict:
    """Phase 20 (a), in phase 13's process (on the card its child, whose
    cuBLAS workspace makes the step deterministic): phase 13's trainer
    config, data and weights with ``CHECKPOINT_BACKEND: orbax``, under
    ``torch.use_deterministic_algorithms``:

    1. U: ``start(max_epochs=BACKENDS_EPOCHS)``: XE, the switch, one SCST
       epoch; head_topk once a decode step and beam_select_attention once
       a layer and step (the card only); each epoch's seconds that the
       save blocks the loop (the host copy; the write goes on behind)
       beside phase 13's native saves (``native_epochs``), and
       ``last_model.orbax``'s MiB;
    2. R: ``start(max_epochs=1)``, then a new trainer resumes from
       ``last_model.orbax`` for the rest: parameters, optimizer, generator
       and loader counters equal to U's bit for bit;
    3. ``CaptioningPipeline`` from U's ``best_model.orbax`` (bf16, head
       kernel forced on the card, attention kernel on) against the native
       ``best_model.ckpt`` of the same weights: captions and ids equal on
       phase 13's test images, the kernels' launches per step.

    The rehearsal runs it at tiny widths (random weights, 4 images)."""
    import shutil
    import tempfile

    from openviic_tpu_torch import artifact
    from openviic_tpu_torch.builders import build_trainer
    from openviic_tpu_torch.config import ConfigNode
    from openviic_tpu_torch.serving import CaptioningPipeline
    from openviic_tpu_torch.training import checkpoint as ckpt
    from openviic_tpu_torch.training.orbax_backend import OrbaxBackend
    from openviic_tpu_torch.utils import setup_logger

    cuda = device.type == "cuda"
    split = TRAINER_SPLIT if cuda else (2, 1, 1)
    tmp = tempfile.mkdtemp(prefix="openviic_orbax_phase_")
    failures = []
    trainer_logger = setup_logger()
    level = trainer_logger.level
    trainer_logger.setLevel(logging.WARNING)
    try:
        data = os.path.join(tmp, "data")
        trainer_dataset(data, loaded, split)

        def config(run, backend="orbax", **training):
            cfg = trainer_config(data, os.path.join(tmp, run), s, cuda, TRAINER_LOG_EVERY)
            cfg = cfg.to_dict()
            cfg["TRAINING"].update(CHECKPOINT_BACKEND=backend, **training)
            return ConfigNode(cfg)

        def make(run, fresh):
            cfg = config(run)
            run_dir = os.path.join(cfg.TRAINING.CHECKPOINT_PATH, TRAINER_NAME)
            os.makedirs(run_dir, exist_ok=True)
            if not os.path.exists(os.path.join(run_dir, "vocab.bin")):
                shutil.copyfile(artifact.ARTIFACT_DIR / "vocab.bin",
                                os.path.join(run_dir, "vocab.bin"))
            tr = build_trainer(cfg, device=device)
            if fresh and cuda:
                tr.model.load_state_dict(loaded["state_dict"])
            return tr

        counted = counted_wrappers()
        with deterministic_algorithms():
            u = make("U", fresh=True)
            n_layers = len(u.model.decoder.layers)
            rec = {"epochs": {}}
            clock_trainer(u, device, rec, lambda label: contextlib.nullcontext())
            for fn in counted:
                fn.launches = 0
            steps0 = u.beam_searcher.steps
            u.start(max_epochs=BACKENDS_EPOCHS)
            steps = u.beam_searcher.steps - steps0
            launches = {fn.__name__: fn.launches for fn in counted if fn.launches}
            u_snap = trainer_snapshot(u)
            epochs = [r for _, r in sorted(rec["epochs"].items())]
            phases = [r.get("phase") for r in epochs]
            save_s = [r.get("save", float("nan")) for r in epochs]
            native_s = [r.get("save", float("nan")) for _, r in
                        sorted(native_epochs.items(), key=lambda kv: int(kv[0]))]
            last = os.path.join(u.checkpoint_path, OrbaxBackend.LAST_NAME)
            mib = directory_mib(last)
            log(f"  orbax trainer U: phases {phases}, losses "
                f"{[round(r.get('loss', float('nan')), 5) for r in epochs]}; the save blocks "
                f"the loop {[round(x, 4) for x in save_s]} s an epoch (native, phase 13: "
                f"{[round(x, 4) for x in native_s]} s); last_model.orbax {mib:.1f} MiB "
                f"({sorted(os.listdir(last))}); {steps} decode steps, launches {launches}")
            want = ({"head_topk": steps, "beam_select_attention": n_layers * steps}
                    if cuda else {})
            if phases != ["xe", "scst"] or not np.all(np.isfinite([r["loss"] for r in epochs])):
                failures.append(f"orbax trainer U: phases {phases}")
            if launches != want or steps <= 0:
                failures.append(f"orbax trainer launches {launches}, expected {want}")
            r = make("R", fresh=True)
            r.start(max_epochs=1)
            del r
            r = make("R", fresh=False)
            r.start(max_epochs=BACKENDS_EPOCHS - 1)
            gaps = snapshot_gaps(trainer_snapshot(r), u_snap)
            del r
            log(f"  orbax trainer R (start(max_epochs=1), then a new trainer from "
                f"last_model.orbax) against U: equal bit for bit: {not gaps}")
            if gaps:
                failures.append(f"orbax trainer R against U: differs in {gaps[:5]}")

        # serving from best_model.orbax against a native checkpoint of its weights
        best = os.path.join(u.checkpoint_path, OrbaxBackend.BEST_NAME)
        u.model.load_state_dict(OrbaxBackend().load_checkpoint(best)["model"])
        native_dir = os.path.join(tmp, "native", TRAINER_NAME)
        write_run(native_dir, u.model, vocab_file=artifact.ARTIFACT_DIR / "vocab.bin")
        model_cfg = u.config.MODEL.to_dict()
        del u
        with open(os.path.join(data, "test.json")) as f:
            test_ids = [im["id"] for im in json.load(f)["images"]][:BACKENDS_SERVE_IMAGES]
        images = [{"region_features": np.load(os.path.join(data, "features", f"{i}.npy"),
                                              allow_pickle=True).item()["region_features"]
                   .astype(np.float32)} for i in test_ids]

        def pipeline(backend, directory):
            cfg = ConfigNode({"MODEL": model_cfg, "TRAINING": {
                "CHECKPOINT_PATH": tmp, "CHECKPOINT_BACKEND": backend,
                "EVALUATING_BEAM_SIZE": 3, "DECODE_HEAD_KERNEL": 1 if cuda else False,
                "DECODE_ATTN_KERNEL": True}})
            return CaptioningPipeline(cfg, checkpoint_dir=directory, batch_size=len(images),
                                      device=device)

        from_orbax = pipeline("orbax", os.path.dirname(best))
        want_caps = pipeline("native", native_dir).caption_features(images, return_ids=True)
        for fn in counted:
            fn.launches = 0
        steps0 = from_orbax.searcher.steps
        got = from_orbax.caption_features(images, return_ids=True)
        serve_steps = from_orbax.searcher.steps - steps0
        serve_launches = {fn.__name__: fn.launches for fn in counted if fn.launches}
        same = got[0] == want_caps[0] and np.array_equal(got[1], want_caps[1])
        log(f"  pipeline from best_model.orbax (bf16, head kernel forced, attention kernel on) "
            f"on {len(images)} test images: captions and ids equal to the native checkpoint's "
            f"{same}; {serve_steps} steps, launches {serve_launches}")
        want = ({"head_topk": serve_steps, "beam_select_attention": n_layers * serve_steps}
                if cuda else {})
        if not same or serve_launches != want:
            failures.append(f"pipeline from best_model.orbax: equal {same}, launches "
                            f"{serve_launches}, expected {want}")
    finally:
        trainer_logger.setLevel(level)
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": {"trainer": launches, "serving": serve_launches},
            "decode_steps": steps, "serve_steps": serve_steps, "layers": n_layers,
            "save_blocks_s": save_s, "native_save_s": native_s, "last_model_mib": mib,
            "phases": phases}


def vectors_part(device, s, card: str) -> dict:
    """Phase 20 (b): the flagship at ``s``'s widths with ``UsualEmbedding``
    over pretrained vectors (``TEXT_EMBEDDING.WORD_EMBEDDING``,
    D_EMBEDDING 300): a seeded 300-d vector file of the vocab's words,
    VECTORS_NAME's file in a temporary cache, read once as text and once
    from the ``.npz`` it leaves (equal); random weights from a seed, bf16,
    beam ``s["beam"]``, one request of ``s["batch"]`` images: the tuned
    path (head kernel forced, beam-select kernel on), ``resident_kernel``
    and ``OPENVIIC_FUSED_STEP=1`` (non-resident), each against eager fast
    select (launches per step, ids in the vocab, score parity); head_topk
    and resident_layer_step on their inputs captured from these decodes
    against their plain versions; f32 on the card against its host's CPU on
    FAMILY_F32_IMAGES images (>= FAMILY_F32_AGREEMENT_MIN identical; the
    card only); a pipeline from a checkpoint and a ``vocab.bin`` that
    carries the vectors gives the in-memory pipeline's captions.  The
    rehearsal: tiny widths, FAMILY_REHEARSAL's 2 images and 6 steps."""
    import importlib
    import shutil
    import tempfile

    from openviic_tpu_torch.builders import META_WORD_EMBEDDING, build_model
    from openviic_tpu_torch.config import ConfigNode
    from openviic_tpu_torch.data import word_embedding  # noqa: F401  (registers the classes)
    from openviic_tpu_torch.data.vocab import load_vocab
    from openviic_tpu_torch.decoding import BeamSearcher
    from openviic_tpu_torch.models import decoders as decoders_module
    from openviic_tpu_torch.serving import CaptioningPipeline

    beam_search_module = importlib.import_module("openviic_tpu_torch.decoding.beam_search")
    cuda = device.type == "cuda"
    if not cuda:
        s = dict(s, **FAMILY_REHEARSAL)
    name, beam = "vectors", s["beam"]
    tmp = tempfile.mkdtemp(prefix="openviic_vectors_phase_")
    try:
        vocab = make_vocab(s)
        cls = META_WORD_EMBEDDING.get(VECTORS_NAME)
        rows = np.random.default_rng(VECTORS_SEED).normal(
            size=(len(vocab) - 4, cls.dim)).astype(np.float32)
        t0 = time.perf_counter()
        with open(os.path.join(tmp, cls.filename), "w", encoding="utf-8") as f:
            for word, row in zip(vocab.itos[4:], rows):
                f.write(word + " " + " ".join(f"{x:.6f}" for x in row) + "\n")
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        text = cls(cache=tmp)
        text_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cached = cls(cache=tmp)
        npz_s = time.perf_counter() - t0
        if not (np.array_equal(text.vectors, cached.vectors) and text.stoi == cached.stoi):
            raise AssertionError(f"{name}: the .npz cache differs from the text it was read from")
        vocab.load_word_embeddings(cached)
        log(f"  {name}: {len(text)} words x {text.dim} read as text in {text_s:.3f} s (written "
            f"in {write_s:.3f} s, {os.path.getsize(os.path.join(tmp, cls.filename)) / 2**20:.1f}"
            f" MiB), from the .npz in {npz_s:.3f} s, equal")

        def config(kernels=True):
            cfg = model_config(s, attn_kernel=kernels).to_dict()
            cfg["MODEL"]["DECODER"]["TEXT_EMBEDDING"].update(
                WORD_EMBEDDING=VECTORS_NAME, WORD_EMBEDDING_CACHE=tmp, D_EMBEDDING=text.dim)
            cfg["TRAINING"].update(EVALUATING_BEAM_SIZE=beam, CHECKPOINT_PATH=tmp,
                                   DECODE_HEAD_KERNEL=1 if kernels else False)
            return ConfigNode(cfg)

        rng = np.random.default_rng(21)
        feats = rng.standard_normal((s["batch"], s["n_regions"], s["d_feature"]),
                                    dtype=np.float32)
        request = [{"region_features": f} for f in feats]
        requests = [request]
        pipe = CaptioningPipeline.from_state_dict(config(), vocab, batch_size=s["batch"],
                                                  device=device, seed=41)
        model = pipe.model
        n_dec = len(model.decoder.layers)
        if tuple(model.decoder.word_emb.vectors.shape) != (len(vocab), text.dim):
            raise AssertionError(f"{name}: the embedding holds no vectors")
        per_path = {}

        def run(path, searcher, decode, **expect):
            results, counts = drive(f"{name} {path}", device, s, vocab, requests, searcher,
                                    decode, card, **expect)
            per_path[path] = {k: v for k, v in counts.items() if v}
            return results

        def searched(searcher):
            return searcher_decode(pipe, searcher, vocab, beam)

        served = lambda r: pipe.caption_features(r, return_ids=True)  # noqa: E731
        tuned = run("tuned", pipe.searcher, served,
                    per_step={"head_topk": 1, "beam_select_attention": n_dec})
        with capture_calls(beam_search_module, "head_topk", 1) as head_kept:
            tuned = rescore(device, requests, searched(pipe.searcher), tuned, f"{name} tuned")
        eager_searcher = BeamSearcher(model, torch.bfloat16)
        eager = run("eager", eager_searcher, searched(eager_searcher))
        agree = {"tuned": score_parity(f"{name} tuned", tuned, eager, "eager fast select")}
        resident = BeamSearcher(model, torch.bfloat16, head_kernel=1, resident_kernel=True)
        with capture_calls(decoders_module, "resident_layer_step", n_dec, 0) as res_kept:
            res_b = run("(b) resident_kernel", resident, searched(resident),
                        per_step={"head_topk": 1, "resident_layer_step": n_dec})
        agree["(b)"] = score_parity(f"{name} (b)", res_b, eager, "eager fast select")
        non_resident = BeamSearcher(model, torch.bfloat16, beam_resident=False)
        with env_flag("OPENVIIC_FUSED_STEP"):
            res_c = run("(c) non-resident, OPENVIIC_FUSED_STEP=1", non_resident,
                        searched(non_resident), per_step={"fused_layer_step": n_dec})
        agree["(c)"] = score_parity(f"{name} (c)", res_c, eager, "eager fast select")
        cases = trained_kernel_cases(device, {"head_topk": head_kept,
                                              "resident_layer_step": res_kept},
                                     what=f"{name} decode")

        f32_same = None
        if cuda:
            few = request[:FAMILY_F32_IMAGES]

            def f32_captions(dev):
                return CaptioningPipeline.from_state_dict(
                    config(kernels=False), vocab, batch_size=len(few), use_bf16=False,
                    device=dev, seed=41).caption_features(few)
            card_caps, cpu_caps = f32_captions(device), f32_captions("cpu")
            f32_same = float(np.mean([a == b for a, b in zip(card_caps, cpu_caps)]))
            log(f"  {name} f32 decode of {len(few)} images: captions identical on the card "
                f"and its host's CPU {f32_same:.4f}")
            if f32_same < FAMILY_F32_AGREEMENT_MIN:
                raise AssertionError(f"{name} f32 card against CPU: {f32_same:.4f} identical "
                                     f"< {FAMILY_F32_AGREEMENT_MIN}")

        # from a checkpoint whose vocab.bin carries the vectors
        run_dir = os.path.join(tmp, "run")
        write_run(run_dir, build_model(config().MODEL, vocab, device="cpu", seed=41), vocab)
        saved = load_vocab(os.path.join(run_dir, "vocab.bin"))
        loaded_pipe = CaptioningPipeline(config(), checkpoint_dir=run_dir,
                                         batch_size=s["batch"], device=device)
        same = (np.array_equal(saved.word_embeddings, vocab.word_embeddings)
                and loaded_pipe.caption_features(request) == tuned[0][0])
        log(f"  {name} pipeline from a checkpoint and a vocab.bin carrying the vectors: "
            f"captions equal to the in-memory pipeline's {same}")
        if not same:
            raise AssertionError(f"{name}: the pipeline from the checkpoint captions otherwise")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    figures = dict(launches=per_path, agreement=agree, f32_card_cpu_agreement=f32_same,
                   text_read_s=text_s, npz_read_s=npz_s, words=len(text), dim=text.dim)
    return {"launches": per_path, "kernels": cases, "figures": figures}


def cache_child(out_file: str) -> None:
    """Phase 20 (c)'s child process (``--cache-child FILE``): the build cache
    from ``OPENVIIC_COMPILE_CACHE``, ``cuda_build.build()`` of every source
    and a load of each library, counting the nvcc processes started; its
    result in ``FILE``."""
    from openviic_tpu_torch.ops import cuda_build
    from openviic_tpu_torch.utils import maybe_enable_compilation_cache

    starts = []
    real = cuda_build.subprocess.Popen

    def counted(cmd, *args, **kwargs):
        starts.append(os.path.basename(cmd[-1]))
        return real(cmd, *args, **kwargs)

    cuda_build.subprocess.Popen = counted
    t0 = time.perf_counter()
    cache = maybe_enable_compilation_cache()
    built = sorted(cuda_build.build())
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    libraries = [str(cuda_build.library_path(n)) for n in cuda_build.sources()]
    for name in cuda_build.sources():
        cuda_build.load(name)
    load_s = time.perf_counter() - t0
    with open(out_file, "w") as f:
        json.dump({"cache": cache, "built": built, "nvcc_starts": starts, "build_s": build_s,
                   "load_s": load_s, "libraries": libraries}, f)


def start_cache_child() -> dict:
    """Phase 20 (c)'s first child (``cache_child``), started beside the
    build phase (its nvcc processes compete with the build's for the
    host's cores): ``OPENVIIC_COMPILE_CACHE`` a new temporary directory."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="openviic_cache_phase_")
    env = dict(os.environ, OPENVIIC_COMPILE_CACHE=os.path.join(tmp, "cache"))
    out_file = os.path.join(tmp, "child0.json")
    with open(os.path.join(tmp, "child0.err"), "w") as err:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--cache-child",
                                 out_file], env=env, stdout=subprocess.DEVNULL, stderr=err)
    return {"tmp": tmp, "env": env, "proc": proc, "out": out_file, "t0": time.perf_counter()}


def stop_cache_child(first: dict) -> None:
    """End ``start_cache_child``'s process if it still runs, and delete its
    directory."""
    import shutil

    if first["proc"].poll() is None:
        first["proc"].kill()
    first["proc"].wait()
    shutil.rmtree(first["tmp"], ignore_errors=True)


def cache_part(device, first=None) -> dict:
    """Phase 20 (c): two child processes in turn with the same
    ``OPENVIIC_COMPILE_CACHE`` (``cache_child``): the first
    (``start_cache_child``'s, started beside the build phase) compiles
    every source there, one nvcc each; the second, started here once the
    first has ended, starts no nvcc and loads every library from there.
    The rehearsal checks in this process that the cache moves the build
    directory there and back (no nvcc on the CPU)."""
    import tempfile
    from pathlib import Path

    from openviic_tpu_torch.ops import cuda_build
    from openviic_tpu_torch.utils import maybe_enable_compilation_cache

    if device.type != "cuda":
        tmp = tempfile.mkdtemp(prefix="openviic_cache_phase_")
        try:
            with env_flag("OPENVIIC_COMPILE_CACHE", tmp):
                moved = (maybe_enable_compilation_cache() == tmp
                         and all(cuda_build.library_path(n).parent == Path(tmp)
                                 for n in cuda_build.sources()))
            with env_flag("OPENVIIC_COMPILE_CACHE", ""):
                maybe_enable_compilation_cache()
        finally:
            os.rmdir(tmp)
        if not moved or cuda_build.build_dir() != cuda_build.BUILD_DIR:
            raise AssertionError("the build cache did not move the build directory there and "
                                 "back")
        log("  build cache: the libraries' paths moved under OPENVIIC_COMPILE_CACHE and back "
            "(no nvcc on the CPU)")
        return {}
    runs = []
    try:
        first["proc"].wait(timeout=900)
        first_s = time.perf_counter() - first["t0"]
        if first["proc"].returncode != 0:
            with open(os.path.join(first["tmp"], "child0.err")) as f:
                raise AssertionError(f"build cache child 0 exited {first['proc'].returncode}: "
                                     f"{f.read().strip().splitlines()[-20:]}")
        with open(first["out"]) as f:
            runs.append(dict(json.load(f), process_s=first_s))
        out_file = os.path.join(first["tmp"], "child1.json")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--cache-child",
                               out_file], env=first["env"], capture_output=True, text=True,
                              timeout=900)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"build cache child 1 exited {proc.returncode}: "
                                 f"{proc.stderr.strip().splitlines()[-20:]}")
        with open(out_file) as f:
            runs.append(dict(json.load(f), process_s=seconds))
    finally:
        stop_cache_child(first)
    first_run, second = runs
    sources = sorted(cuda_build.sources())
    for i, r in enumerate(runs):
        log(f"  build cache child {i}: {len(r['nvcc_starts'])} nvcc started, built "
            f"{r['built']} in {r['build_s']:.3f} s, {len(r['libraries'])} libraries loaded in "
            f"{r['load_s']:.3f} s; the process {r['process_s']:.3f} s"
            + (" (beside the build phase, until this phase)" if i == 0 else ""))
    if (first_run["built"] != sources
            or sorted(first_run["nvcc_starts"]) != [f"{n}.cu" for n in sources]
            or second["built"] or second["nvcc_starts"]
            or not all(p.startswith(first_run["cache"]) for p in first_run["libraries"])
            or second["libraries"] != first_run["libraries"]):
        raise AssertionError(f"build cache: the first child built {first_run['built']}, the "
                             f"second {second['built']} with nvcc {second['nvcc_starts']}")
    return {"runs": runs}


def local_config(data: str, checkpoint_path: str, s, cuda: bool):
    """Phase 13's trainer config for (d): dropout 0, no mixed precision and
    one step a call (the sharded step has neither), the host reward (the
    ranks' own), the global batch XE_BATCH (the rehearsal: 4),
    LOCAL_SCST_IMAGES SCST images a batch (the rehearsal: 1)."""
    from openviic_tpu_torch.config import ConfigNode

    cfg = trainer_config(data, checkpoint_path, s, cuda, TRAINER_LOG_EVERY).to_dict()

    def walk(node):
        if isinstance(node, dict):
            return {k: (0.0 if k == "DROPOUT" else walk(v)) for k, v in node.items()}
        return node

    cfg["MODEL"] = walk(cfg["MODEL"])
    cfg["TRAINING"].update(MIXED_PRECISION=False, STEPS_PER_CALL=1, DEVICE_REWARD=False)
    cfg["DATASET"]["FEATURE_BATCH_SIZE"] = XE_BATCH if cuda else 4
    cfg["DATASET"]["DICT_BATCH_SIZE"] = (LOCAL_SCST_IMAGES if cuda else 1) * SCST_BEAM
    return ConfigNode(cfg)


def params_digest(model) -> str:
    import hashlib

    digest = hashlib.sha256()
    for name, tensor in sorted(model.state_dict().items()):
        digest.update(name.encode())
        digest.update(tensor.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()


def local_epochs(device, root: str, s) -> dict:
    """One XE epoch, then one SCST epoch from the weights the XE epoch
    started from (so that its samples do not hang on the XE epoch's
    rounding), of ``local_config``'s trainer on ``root``'s data (the
    artifact's weights on the card), then its checkpoint: the XE loss,
    step and parameters' digest and seconds; the SCST loss, step and
    digest, and each SCST iteration's images on this process and their
    mean reward; the native saves this process made."""
    from openviic_tpu_torch.artifact import load_trained_artifact
    from openviic_tpu_torch.builders import build_trainer
    from openviic_tpu_torch.parallel import runtime
    from openviic_tpu_torch.training import checkpoint as ckpt
    from openviic_tpu_torch.training import trainer as trainer_module

    cuda = device.type == "cuda"
    saves, iterations = [], []
    real, real_iteration = ckpt.NativeBackend.save_checkpoint, trainer_module.scst_iteration

    def counted(self, *args, **kwargs):
        saves.append(os.path.basename(args[0]))
        return real(self, *args, **kwargs)

    def recorded(setup, batch, captions, marks=None):
        loss, reward = real_iteration(setup, batch, captions, marks)
        iterations.append((len(captions), reward))
        return loss, reward

    ckpt.NativeBackend.save_checkpoint = counted
    trainer_module.scst_iteration = recorded
    try:
        tr = build_trainer(local_config(os.path.join(root, "data"), os.path.join(root, "run"),
                                        s, cuda), device=device)
        tr.train_dataloader.drop_last = True  # one process takes the ranks' batches
        if cuda:
            tr.model.load_state_dict(load_trained_artifact(device="cpu")["state_dict"])
        start = {k: v.clone() for k, v in tr.model.state_dict().items()}
        sync(device)
        t0 = time.perf_counter()
        loss = tr.train()
        sync(device)
        seconds = time.perf_counter() - t0
        step, digest = int(tr.state["step"]), params_digest(tr.model)
        tr.model.load_state_dict(start)
        scst_loss = tr.train_scst()
        tr.save_checkpoint({"val_loss": 0.0, "best_val_score": 0.0, "patience": 0,
                            "use_rl": True})
    finally:
        ckpt.NativeBackend.save_checkpoint = real
        trainer_module.scst_iteration = real_iteration
    return {"rank": runtime.process_index(), "loss": loss, "step": step, "digest": digest,
            "saves": saves, "seconds": seconds,
            "scst": {"loss": scst_loss, "step": int(tr.state["step"]),
                     "digest": params_digest(tr.model),
                     "images": [n for n, _ in iterations],
                     "rewards": [float(r) for _, r in iterations]},
            "mesh": None if tr.mesh is None else tr.mesh.size,
            "host_local": runtime.host_local()}


def local_rank(device, root: str, s) -> None:
    """Phase 20 (d)'s rank (``parallel.launch.spawn``): ``local_epochs``
    with this process's matmul settings those of ``main``'s; its result in
    ``root/rank<r>.json``."""
    from openviic_tpu_torch.utils import setup_logger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_num_threads(1)
    setup_logger().setLevel(logging.WARNING)
    result = local_epochs(device, root, s)
    with open(os.path.join(root, f"rank{result['rank']}.json"), "w") as f:
        json.dump(result, f)


def rewards_close(ranks: list, one: dict) -> bool:
    """Whether each SCST iteration's mean reward over the ranks (which hold
    equal rows) is within LOCAL_LOSS_RTOL of one process's."""
    got = np.mean([r["scst"]["rewards"] for r in ranks], axis=0)
    want = np.asarray(one["scst"]["rewards"])
    return len(got) == len(want) and bool(np.all(np.abs(got - want)
                                                 <= LOCAL_LOSS_RTOL * np.abs(want)))


def local_parallel_part(device, s, card: str, loaded) -> dict:
    """Phase 20 (d): the launcher (``parallel.launch.spawn``) on [the card,
    the card] over gloo (NCCL refuses two ranks on one device): each rank
    reads its half of each global batch of XE_BATCH of phase 13's data,
    one XE epoch, then one SCST epoch of LOCAL_SCST_IMAGES images a batch
    (a batch the ranks do not divide runs whole on both), then the
    checkpoint (``local_epochs``); against one process of the same
    config: the XE losses within LOCAL_LOSS_RTOL, each SCST iteration's
    mean reward (the ranks' mean) within LOCAL_LOSS_RTOL, the same steps
    and SCST images, parameters bit-equal across the ranks after each
    epoch, and rank 0 alone writes the checkpoint.  The SCST loss, whose
    terms nearly cancel, is printed beside one process's (the CPU tests
    hold it against JAX).  Both ranks must end within LOCAL_RANK_TIMEOUT.
    The rehearsal runs one host-local gloo rank in this process at a
    global batch of 4 (the spawn itself is the CPU tests'), its XE loss
    and SCST rewards within LOCAL_LOSS_RTOL of one process's (the sharded
    steps sum otherwise)."""
    import shutil
    import tempfile

    from openviic_tpu_torch import artifact
    from openviic_tpu_torch.parallel import launch
    from openviic_tpu_torch.utils import setup_logger

    import chip_smoke as importable  # the ranks find their function by this module's name

    cuda = device.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="openviic_local_dp_")
    logger = setup_logger()
    level = logger.level
    logger.setLevel(logging.WARNING)
    try:
        counts = trainer_dataset(os.path.join(tmp, "data"), loaded,
                                 TRAINER_SPLIT if cuda else (2, 1, 1))
        run_dir = os.path.join(tmp, "run", TRAINER_NAME)
        os.makedirs(run_dir)
        shutil.copyfile(artifact.ARTIFACT_DIR / "vocab.bin", os.path.join(run_dir, "vocab.bin"))
        one = local_epochs(device, tmp, s)
        shutil.rmtree(os.path.join(tmp, "run"))
        os.makedirs(run_dir)
        shutil.copyfile(artifact.ARTIFACT_DIR / "vocab.bin", os.path.join(run_dir, "vocab.bin"))
        if not cuda:
            from openviic_tpu_torch.parallel import runtime

            runtime.initialize_distributed(device, backend="gloo",
                                           init_method="file://" + os.path.join(tmp, "group"),
                                           world_size=1, rank=0, host_local=True)
            try:
                rank = local_epochs(device, tmp, s)
            finally:
                runtime.shutdown()
            log(f"  launcher rehearsal: one host-local gloo rank in this process, loss "
                f"{rank['loss']} against one process's {one['loss']}; SCST rewards "
                f"{rank['scst']['rewards']} against {one['scst']['rewards']}; saves "
                f"{rank['saves']}")
            if (abs(rank["loss"] - one["loss"]) > LOCAL_LOSS_RTOL * abs(one["loss"])
                    or not rewards_close([rank], one)
                    or rank["scst"]["images"] != one["scst"]["images"]
                    or rank["saves"] != ["last_model.ckpt"]
                    or not rank["host_local"] or rank["mesh"] != 1):
                raise AssertionError(f"launcher rehearsal: {rank} against {one}")
            return {"ranks": [rank], "one_process": one}
        t0 = time.perf_counter()
        context = launch.spawn(importable.local_rank, [str(device)] * 2, args=(tmp, s),
                               backend="gloo", join=False)
        deadline = time.monotonic() + LOCAL_RANK_TIMEOUT
        try:
            while not context.join(timeout=1):
                if time.monotonic() > deadline:
                    raise AssertionError(f"the launched ranks ran past {LOCAL_RANK_TIMEOUT} s")
        finally:
            for p in context.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        launch_s = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        files = sorted(os.listdir(run_dir))
    finally:
        logger.setLevel(level)
        shutil.rmtree(tmp, ignore_errors=True)
    gaps = [abs(r["loss"] - one["loss"]) / abs(one["loss"]) for r in ranks]
    scst = [r["scst"] for r in ranks]
    log(f"  launcher on {[str(device)] * 2} over gloo: phase 13's data {counts}, global batch "
        f"{XE_BATCH if cuda else 4}: losses {[r['loss'] for r in ranks]} against one "
        f"process's {one['loss']} (relative {max(gaps):.3g}); steps "
        f"{[r['step'] for r in ranks]} against {one['step']}; parameters equal across the "
        f"ranks {ranks[0]['digest'] == ranks[1]['digest']}; the epoch "
        f"{[round(r['seconds'], 3) for r in ranks]} s against {one['seconds']:.3f} s; saves "
        f"{[r['saves'] for r in ranks]}; the launch {launch_s:.3f} s on {card}")
    log(f"  SCST epoch: images a rank {scst[0]['images']} against one process's "
        f"{one['scst']['images']}; rewards (the ranks' mean) "
        f"{[(a + b) / 2 for a, b in zip(scst[0]['rewards'], scst[1]['rewards'])]} against "
        f"{one['scst']['rewards']}; loss {[r['loss'] for r in scst]} against "
        f"{one['scst']['loss']}; steps {[r['step'] for r in scst]} against "
        f"{one['scst']['step']}; parameters equal across the ranks "
        f"{scst[0]['digest'] == scst[1]['digest']}")
    split = [n if n % 2 else n // 2 for n in one["scst"]["images"]]
    if (max(gaps) > LOCAL_LOSS_RTOL or any(r["step"] != one["step"] for r in ranks)
            or ranks[0]["digest"] != ranks[1]["digest"]
            or not rewards_close(ranks, one)
            or any(r["images"] != split or r["step"] != one["scst"]["step"] for r in scst)
            or scst[0]["digest"] != scst[1]["digest"]
            or [r["saves"] for r in ranks] != [["last_model.ckpt"], []]
            or not all(r["host_local"] and r["mesh"] == 2 for r in ranks)
            or "last_model.ckpt" not in files):
        raise AssertionError(f"launcher: losses {[r['loss'] for r in ranks]} against "
                             f"{one['loss']}, ranks {ranks}")
    return {"ranks": ranks, "one_process": one, "launch_s": launch_s}


def backends_phase(device, s, card: str, loaded, orbax: dict, cache_first=None) -> dict:
    """Phase 20: (a) the DCP checkpoint backend's trainer and serving
    (``orbax_trainer_part``, run in phase 13's process: ``orbax``), (b)
    the flagship with pretrained vectors (``vectors_part``), (c) the build
    cache (``cache_part``; on the card ``cache_first`` is its first child),
    (d) the launcher (``local_parallel_part``).
    Returns each kernel's launches on each path (0 where it does not run),
    the kernels' cases and the figures."""
    vectors = timed("backends (b): the flagship with pretrained vectors",
                    lambda: vectors_part(device, s, card))
    cache = timed("backends (c): the kernels' build cache",
                  lambda: cache_part(device, cache_first))
    local = timed("backends (d): the launcher over two ranks",
                  lambda: local_parallel_part(device, s, card, loaded))
    launches = {fn.__name__: {} for fn in counted_wrappers()}
    for name in launches:
        for path, counts in orbax["launches"].items():
            launches[name][f"orbax {path}"] = counts.get(name, 0)
        for path, counts in vectors["launches"].items():
            launches[name][f"vectors {path}"] = counts.get(name, 0)
    figures = {"orbax": {k: v for k, v in orbax.items() if k != "launches"},
               "vectors": vectors["figures"], "cache": cache, "local": local}
    return {"launches": launches, "kernels": vectors["kernels"], "figures": figures}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(logs) -> str:
    keep = []
    for name, text in logs.items():
        for line in text.splitlines():
            line = line.replace("ptxas info    :", "").strip()
            if line.startswith(("Compiling entry", "Used")) or "spill" in line:
                keep.append(f"{name}: {line}")
    return " | ".join(keep)


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "LDL", "STL")  # wgmma, mma.sync, TMA loads, local memory


def sass_table(name: str) -> dict:
    """Per kernel of csrc/<name>.cu's library (mangled name), how many of
    SASS_OPS its machine code holds (``cuobjdump -sass``)."""
    import re

    from openviic_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(cuda_build.library_path(name))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            func = found.group(1)
            counts[func] = dict.fromkeys(SASS_OPS, 0)
        elif func:
            op = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if op and op.group(1) in counts[func]:
                counts[func][op.group(1)] += 1
    return counts


def sass_counts(name: str) -> str:
    """sass_table as a line: the evidence that a kernel is built on wgmma,
    mma.sync and TMA, and spills nothing."""
    import re

    table = sass_table(name)
    if not table:
        return f"{name}: cuobjdump not found"
    out = []
    for func, c in table.items():
        # the kernel's own name and its template arguments, out of the mangled name
        found = re.search(r"\d+([a-z_]*(?:kernel|partial|merge|fast|general|mma|simt)\w*)", func)
        label = found.group(1) if found else f"...{func[-44:]}"
        out.append(f"{name}: {label[:60]}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    return " | ".join(out)


def occupancy_lines(s):
    """How the layer-step kernels, the head kernel, the beam-select kernels
    and the geo MMA kernel run at the main shape on this card (the ptxas
    report gives the same registers and spills)."""
    from openviic_tpu_torch.ops.beam_select_attention import kernel_route as beam_route
    from openviic_tpu_torch.ops.beam_select_attention import occupancy as beam_occupancy
    from openviic_tpu_torch.ops.geo_attention import occupancy as geo_occupancy
    from openviic_tpu_torch.ops.head_topk import occupancy as head_occupancy
    from openviic_tpu_torch.ops.layer_step import occupancy

    from openviic_tpu_torch.ops.layer_step import library

    N = s["batch"] * s["beam"]
    lines = []
    for resident in (True, False):
        occ = occupancy(resident, N, s["d_model"], s["d_ff"], s["max_len"],
                        -(-s["n_regions"] // 8) * 8, s["heads"])  # the regions as padded
        name = "resident_layer_step" if resident else "fused_layer_step"
        lines.append(f"{name} occupancy at N = {N}: "
                     + ", ".join(f"{k} {v}" for k, v in occ.items()))
        smem = {M: library().openviic_layer_step_smem(int(resident), s["d_model"], s["d_ff"],
                                                      s["max_len"], M)
                for M in (s["n_regions"], *TWO_STREAM_MS, 1000)}
        if len(set(smem.values())) != 1:
            raise AssertionError(f"{name}: shared memory grows with M: {smem}")
        lines.append(f"{name} shared memory per block at M = {', '.join(map(str, smem))}: "
                     f"{next(iter(smem.values()))} B at every one")
    for k in (s["beam"], 16, 128):
        occ = head_occupancy(s["d_model"], k)
        lines.append(f"head_topk partial kernel at D = {s['d_model']}, k = {k}: "
                     + ", ".join(f"{key} {v}" for key, v in occ.items()))
    h, d = s["heads"], s["d_model"] // s["heads"]
    meta = torch.empty((N, 1, h, d), dtype=torch.bfloat16, device="meta")
    route = beam_route(meta, meta, meta)
    for r in sorted({route, 0}):
        occ = beam_occupancy(r, s["beam"], h, s["max_len"])
        lines.append(f"beam_select_attention {'fast' if r else 'general'} kernel (route {r}) "
                     f"at beam {s['beam']}, {h} heads of {d}: "
                     + ", ".join(f"{key} {v}" for key, v in occ.items()))
    n = -(-s["n_regions"] // 8) * 8
    for nn_ in (n, n + 16):
        occ = geo_occupancy(s["batch"], nn_, h, d // 8)
        lines.append(f"geo_fused_attention MMA kernel at bs {s['batch']}, n {nn_}, {h} heads: "
                     + ", ".join(f"{key} {v}" for key, v in occ.items()))
    return lines


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="rehearse phases 3-20 at tiny widths on the CPU")
    parser.add_argument("--trainer-phase", metavar="CARD",
                        help="run the trainer phase alone on the card (its child process)")
    parser.add_argument("--dp-trainer-rank", metavar="DIR",
                        help="run one rank of the data-parallel trainer on the card (a child "
                             "process of phase 18)")
    parser.add_argument("--cache-child", metavar="FILE",
                        help="build and load every kernel through the build cache (a child "
                             "process of phase 20)")
    args = parser.parse_args()
    t_start = time.perf_counter()

    if args.cpu:
        import openviic_tpu_torch  # noqa: F401  (fails outside a checkout)

        device = torch.device("cpu")
        # tiny widths: one thread is fastest, and keeps the rehearsal's cost
        # steady when other processes share the cores
        torch.set_num_threads(1)
        all_phases(device, TINY, "the CPU")
        log(f"total: {time.perf_counter() - t_start:.3f} s")
        log("cpu rehearsal ok")
        return 0

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import openviic_tpu_torch  # noqa: F401  (fails outside a checkout)
    from openviic_tpu_torch.ops import cuda_build

    # f32 products in the plain versions run in full f32, and bf16 GEMMs
    # accumulate in f32, as in the JAX reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    device = torch.device("cuda:0")
    if args.cache_child:
        cache_child(args.cache_child)
        return 0
    if args.dp_trainer_rank:
        dp_trainer_rank(device, args.dp_trainer_rank)
        return 0
    if args.trainer_phase:
        from openviic_tpu_torch.artifact import load_trained_artifact

        result = trainer_and_orbax(device, FLAGSHIP, args.trainer_phase,
                                   load_trained_artifact(device="cpu"))
        print(json.dumps(result), flush=True)
        return 0
    smi = timed("device", nvidia_smi_line)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"  nvidia-smi: {smi}; torch: {kind}, {count} device(s), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    cache_first = start_cache_child()
    try:
        logs = timed("build", lambda: cuda_build.build(force=True))
        log(f"  ptxas: {ptxas_summary(logs)}")
        for line in occupancy_lines(FLAGSHIP):
            log(f"  {line}")
        for name in ("head_topk", "layer_step", "beam_select_attention", "geo_attention"):
            log(f"  sass: {sass_counts(name)}")
        if not any(c["HMMA"] and "geo_attention_mma" in f
                   for f, c in sass_table("geo_attention").items()):
            raise AssertionError("the geo MMA kernels hold no HMMA (mma.sync) instruction")
        entries = all_phases(device, FLAGSHIP, smi, cache_first)
    finally:
        stop_cache_child(cache_first)
    log(f"total: {time.perf_counter() - t_start:.3f} s on {smi}")
    log(smi)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


def all_phases(device, s, card: str, cache_first=None):
    """Phases 3-20 (``cache_first``: phase 20 (c)'s first child on the
    card).  Returns the per-kernel entries (none on the CPU), each
    with its launches on its decode path."""
    head = timed("kernel vs plain", lambda: kernel_phase(device, s))
    timed("head_topk k = 32, 128 vs plain", lambda: head_large_k_phase(device, s))
    timed("head-kernel gate sweep", lambda: head_gate_phase(device, s))
    served = timed("serve", lambda: serve_phase(device, s, card))
    layer = served["pipe"].model.decoder.layers[0]
    found = [
        head,
        timed("beam_select_attention vs plain", lambda: beam_select_phase(device, s)),
        timed("resident_layer_step vs plain", lambda: layer_step_phase(device, s, layer, True)),
        timed("fused_layer_step vs plain", lambda: layer_step_phase(device, s, layer, False)),
        timed("fused_attention vs plain", lambda: fused_attention_phase(device, s)),
        timed("geo_fused_attention vs plain", lambda: geo_attention_phase(device, s)),
    ]
    paths = timed("decode paths (a)-(c)", lambda: decode_paths_phase(device, s, served, card))
    paths["forced"] = timed("forced decode (a)-(c)", lambda: forced_phase(device, s, served))
    launches = timed("attention decode paths (d)-(g), forced (d), (e), (g)",
                     lambda: attention_paths_phase(device, s, served, paths, card))
    launches.update(paths, head_topk=served["launches"])
    with quiet_port_logger():
        serving = timed("serving cell: HTTP server and batcher",
                        lambda: http_phase(device, s, card))
        images = timed("serving cell: caption_images on arrays",
                       lambda: images_phase(device, s, card, serving))
    from openviic_tpu_torch.artifact import load_trained_artifact

    loaded = timed("load the trained artifact", lambda: load_trained_artifact(device="cpu"))
    shown = loaded if device.type == "cuda" else rehearsal_artifact(loaded)
    try:
        trained = timed("trained artifact decode", lambda: trained_phase(device, s, card, shown))
        with quiet_port_logger():
            directory = timed("caption_directory of the trained artifact",
                              lambda: directory_phase(device, s, card, shown, trained))
    finally:  # XE and SCST run whatever the decode gave; a failure of any raises
        try:
            xe = timed("XE training", lambda: xe_phase(device, s, card, loaded))
        finally:
            try:
                scst = timed("SCST", lambda: scst_phase(device, s, card, loaded))
            finally:
                trainer = timed("trainer", lambda: trainer_phase_apart(device, s, card, loaded))
    families = timed("region families", lambda: families_phase(device, s, card))
    two_stream = timed("two-stream families", lambda: two_stream_phase(device, s, card))
    rstnet = timed("RSTNet", lambda: rstnet_phase(device, s, card, loaded))
    remainder = timed("single-card remainder", lambda: remainder_phase(device, s, card))
    data_parallel = timed("data parallel", lambda: data_parallel_phase(device, s, card, loaded))
    model_parallel = timed("model parallel", lambda: model_parallel_phase(device, s, card))
    backends = timed("backends", lambda: backends_phase(device, s, card, loaded,
                                                        trainer.pop("orbax"), cache_first))
    tp_families = timed("tensor-parallel families",
                        lambda: tensor_parallel_families_phase(device, s, card))
    if device.type != "cuda":
        return []
    scst_cases = scst.pop("kernels")
    for e in found:
        e["trained"] = trained["kernels"].get(e["name"], [])
        e["scst_cases"] = scst_cases.get(e["name"], [])
    found[0]["xe"] = xe
    found[0]["scst"] = scst
    found[0]["trained_paths"] = trained["paths"]
    found[1].update(paths["beam_select_captured"])
    found[1]["scst"] = dict(dropout_launches=scst["dropout_launches"]["beam_select_attention"],
                            dropout_steps=scst["dropout_steps"])
    found[0]["trainer"] = trainer["head_topk"]
    found[1]["trainer"] = trainer["beam_select_attention"]
    trainer_cases = trainer.pop("kernels")
    served_cases = serving.pop("kernels")
    for e in found:
        e["trainer_cases"] = trainer_cases.get(e["name"], [])
        e["served_cases"] = served_cases.get(e["name"], [])
    found[0]["serving"] = dict(http=serving["http"], batcher=serving["batcher"],
                               checkpoint_mib=serving["checkpoint_mib"], load_s=serving["load_s"],
                               images=images, directory=directory)
    found[1]["serving"] = {run: dict(launches=serving[run]["launches"]["beam_select_attention"])
                           for run in ("http", "batcher")}
    for e in found:
        e["families"] = families["launches"].get(e["name"], {})
        e["families_cases"] = families["kernels"].get(e["name"], [])
    found[0]["families_xe"] = {name: f["xe"] for name, f in families["families"].items()}
    found[0]["families_f32_card_cpu_agreement"] = {
        name: f["f32_card_cpu_agreement"] for name, f in families["families"].items()}
    for e in found:
        e["two_stream"] = two_stream["launches"].get(e["name"], {})
        e["two_stream_cases"] = two_stream["kernels"].get(e["name"], [])
    found[0]["two_stream_figures"] = two_stream["figures"]
    for e in found:  # every kernel's launches on each RSTNet path, 0 where it does not run
        e["rstnet"] = rstnet["launches"][e["name"]]
        e["rstnet_cases"] = rstnet["kernels"].get(e["name"], [])
    found[0]["rstnet_figures"] = rstnet["figures"]
    for e in found:  # every kernel's launches on each remainder path, 0 where it does not run
        e["remainder"] = remainder["launches"][e["name"]]
        e["remainder_cases"] = remainder["kernels"].get(e["name"], [])
    found[0]["remainder_figures"] = remainder["figures"]
    for e in found:  # every kernel's launches on each data-parallel path, 0 where it does not run
        e["data_parallel"] = data_parallel["launches"][e["name"]]
        e["data_parallel_cases"] = data_parallel["kernels"].get(e["name"], [])
    found[0]["data_parallel_figures"] = data_parallel["figures"]
    for e in found:  # every kernel's launches on each model-parallel path, 0 where it does not run
        e["model_parallel"] = model_parallel["launches"][e["name"]]
        e["model_parallel_cases"] = model_parallel["kernels"].get(e["name"], [])
    found[0]["model_parallel_figures"] = model_parallel["figures"]
    for e in found:  # phase 21's launches a rank and cases join phase 19's
        e["model_parallel"].update(tp_families["launches"][e["name"]])
        e["model_parallel_cases"] += tp_families["kernels"].get(e["name"], [])
    found[0]["tp_families_figures"] = tp_families["figures"]
    for e in found:  # every kernel's launches on each phase-20 path, 0 where it does not run
        e["backends"] = backends["launches"][e["name"]]
        e["backends_cases"] = backends["kernels"].get(e["name"], [])
    found[0]["backends_figures"] = backends["figures"]
    for e in found:
        e["launches"] = launches[e["name"]]
        if not e["launches"]:
            raise AssertionError(f"{e['name']} was not launched on its decode path")
    return found


if __name__ == "__main__":
    sys.exit(main())
