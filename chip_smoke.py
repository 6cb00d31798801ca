#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives ``repro_torch``'s paths — serving (``python -m
repro_torch.launch.serve``), quantized training (``python -m
repro_torch.launch.train``, and the paper's LeNet app with its Fig. 4
arms; the dense, MoE and VLM transformers, and MLA (deepseek-v2-236b's
prefill and absorbed decode); at sequence 4,096 through the blockwise
attention and under ``remat="dots"``; the SSM, hybrid and
encoder-decoder families, trained and served through their contiguous
prefill and decode; the MoE layer's expert-parallel all-to-all over a
stacked (data × model) mesh; every family's sharded train step, its
state placed over a stacked (data × model) mesh, and every family's
placed prefill and decode), data-parallel
training over the int8 wire (``launch.train --grad-allreduce-bits 8
--data-ranks 4``, with ZeRO-1 and the overlapped bucketed wire:
``--zero-opt --wire-overlap on``), and that trainer's checkpoint, resume,
health guards and fault drills (``--ckpt-dir``, ``--resume``,
``--sigterm-at``, ``--guards``, ``--inject-nan-at``, ``--rollback-ring``;
the guards and the NaN drill on ZeRO-1 and the overlap too)
— and holds every CUDA kernel on them
against its plain PyTorch version.  Phases, each printing one
JSON line; any failure raises and the process exits non-zero:

1. device  — the card's name, and its power limit as ``nvidia-smi`` gives it.
2. build   — ``nvcc`` builds the kernel library from ``src/repro_torch/
             kernels/csrc`` into ``build/`` and ``ctypes`` loads it.
3. checks  — the grouped wire encoder (K3) and paged decode attention (K5)
             against their plain versions, at small shapes (odd quanta,
             stochastic rounding, statistics, bf16 input, fp32 pools, empty
             rows; for K5's splits rows of exactly P·ps tokens, lengths at a
             split boundary and one either side, more than 132 split blocks)
             and at the shapes the serving path gives them, K5 also at a long
             context (8 rows of 4,096 tokens), int8 and fp32 pools, to
             ``ATTN_TOL``, rows of length 0 exactly 0, two launches
             bit-equal.  The same at the head geometries and page quanta of
             the other configs: K5 at G=12 with Dh=192 (int8 and fp32
             pools) and Dh=128, G=1 with Dh=256, and G=8 with Dh=128 (int8
             and fp32), each at its own split edges; K3 at quanta of 24,576
             and 65,536, and at the shapes of K3's persistent grid
             (``group_plan``: one tile, fewer tiles than SMs, tiles cut
             into pieces over many blocks, one group's run over every
             block, a map that repeats groups and ends in row 0, bf16
             pieces, buffers off 16 bytes; each with statistics on and
             off); then K3 and K5 at each config's serving shape
             (qwen3-moe's: G=8, page quantum 8,192), K3 as the admission
             calls it (no mask: the prompt's padding is zero) and as the
             reference does (masked).  Then each kernel's median time over repeated
             launches (CUDA events, after warm-up, the L2 cache flushed
             before every launch; K5 replayed from a CUDA graph, so that its
             tens of microseconds are not timed behind the Python wrapper;
             K3 also replayed from a graph with the L2 flushed by a read,
             ``ms_graph_clean``, and its device kernels a call held to 1 by
             ``torch.profiler``, as every K3/K3b row's are)
             beside its plain version's and the least time the card could
             take, K5 at both shapes.
4. quantize — the training quantizer, K1 (bits operand) and K1b (Philox bits
             made in the kernel), the same way: small shapes (fp32 and bf16,
             ragged tails, aligned and unaligned, nearest and stochastic,
             statistics on and off) and the shapes the training paths give
             them: K1b the stacked ``w_in`` leaf (704,643,072 fp32 values, one
             launch) and a residual tap (2x512x3072 bf16); K1 one layer of
             ``w_in`` (3072x8192 fp32: with a bits operand the leaf is
             quantized layer by layer) and LeNet's ``fc1_w`` and first tap.
             K1's row is timed at the layer, K1b's at the leaf; K1b also on
             gemma-7b's w_in leaf at 8 layers (8x3072x24576),
             mistral-large-123b's untied ``unembed`` (12288x32768),
             qwen3-moe-30b-a3b's stacked expert w_in at 4 layers
             (4x128x2048x768 = 805,306,368, 64-bit indices) and
             internvl2-26b's w_in at 3 layers (3x6144x16384), the leaves of
             phase 7's other configs; K1b also on LeNet's fc1 (400,000
             values: the small-leaf row, launches paper_fig4's) and the TMA
             body's edges (``tma_edge_checks``: K1b just past
             ``Q_TMA_MIN`` with a short last item, fp32 and bf16, K1b/K2b
             blocks whose items are spans, ragged spans, whole rows, ragged
             slabs and bf16 rows, a grid wider than 2^22; each on the body
             ``quant_plan`` gives it).  q bit-equal
             to the plain version; count,
             nonzero, overflow and max_abs exact; float sums to ``SUM_RTOL``;
             K1b bit-equal to K1 fed the plain Philox stream; two launches
             equal; the mean of K1b over 64 seeds unbiased to 4 sigma.  Each
             row is timed between CUDA events (``ms``), replayed from a CUDA
             graph (``ms_graph``) and replayed with the L2 flushed by a read
             (``ms_graph_clean``), and its device kernels a call counted by
             ``torch.profiler`` (held to 1: the statistics fold in the
             launch).
5. serve   — llama3.2-3b at full width and depth (28 layers, d=3072, 24 heads
             / 8 KV heads, Dh=128, d_ff=8192, vocab 128256; bf16 weights
             drawn from seed 0 on the card) behind the continuous-batching
             engine: page size 16, 8 slots, prompts up to 512 tokens, int8
             pages; a seeded trace of 16 requests.  Every request must get
             exactly its ``max_new`` tokens, the launch counters must show
             both kernels on the path, a second run must repeat the first,
             and the engine built on the plain versions must give the same
             prompt pages and first-step logits within ``LOGIT_TOL``.  Then
             the same for the other dense configs at full width (random
             weights from seed 0): gemma-7b whole (28 layers, G=1, Dh=256),
             mistral-large-123b at 8 of its 88 layers and nemotron-4-340b at
             2 of its 96 (G=12, Dh=128 and 192; untied ``unembed``), and
             qwen3-moe-30b-a3b (MoE: 128 experts, top-8, the einsum dispatch
             reading every expert each step; G=8) at 32 of its 48, the
             unembedding timed with its fp32 table cast per call and against
             the one the engine holds (logits bit-equal).
6. lenet   — the paper's app: 20 steps of ``train_mnist`` under the paper's
             controller with stochastic rounding from a bits operand (K1 on
             every quantization event); then 3 steps under nearest and 3
             under stochastic rounding (the same operand bits on both sides)
             with the kernel and with the plain quantizer: <IL, FL> equal
             step by step, loss to ``LENET_LOSS_RTOL``; then 3 steps under
             ``master_weights`` on K1b (no re-snap: K1b on every event but
             the 8 re-snaps, the losses finite, the parameters off the
             weight grid; the ``lenet`` line's ``master_weights``).  Then
             ``paper_fig4``, the paper's Fig. 4 as
             ``benchmarks/bench_convergence.py`` runs it: ``train_mnist``
             for 2,000 steps in each of three arms on ``MNISTLike(batch=64,
             seed=0)`` — fp32, DPS (``paper_quant_config()``) and fixed
             13-bit (``paper_quant_config(static_bits=13)``) — from seed
             0's initialization (drawn by the CPU generator),
             every quantization event on K1b (33 a step, asserted), the
             fp32 arm's first 3 losses within ``FIG4_LOSS_RTOL`` of a CPU
             run's from the same parameters; each arm's test accuracy,
             average widths, divergence, first non-finite loss, wall time
             and launches, and the bench's three claims,
             printed and not asserted (they are measurements: the paper's
             recipe diverges from some initializations, fp32 included).
7. train   — ``repro_torch.launch.train --arch llama3_2_3b --steps 4 --batch 2
             --seq 512 --optimizer sgd`` at full width and depth (fp32 master
             weights, bf16 compute, full remat), every quantization event on
             K1b: finite losses, <IL, FL> chosen on the device, 80 quantizer
             launches a step.  Then 3 steps with ``--rounding-bits operand``,
             every event on K1: 647 launches a step.  Then gemma-7b (8 of 28
             layers, ``--batch 2``, accumulation 2) and mistral-large-123b (1
             of 88 layers, ``--batch 4``, accumulation 4), qwen3-moe-30b-a3b
             (4 of 48 layers, ``--batch 2``; the load-balance loss finite and
             reported) and internvl2-26b (3 of 48 layers, ``--batch 2``,
             accumulation 2, 256 zero patch embeddings before the 512
             tokens) at full width, 4 steps each on K1b, through
             ``launch.train.main(cfg=...)``; every count a step derived from
             ``model_defs``: 3 x the quantized leaves + 2 taps a layer for
             each microbatch.  Then ``flash``: the blockwise attention
             against the materialized one at llama's shape at sequence
             4,096 (B=1, 4,095 positions, 24 heads, Dh=128), fp32 and bf16,
             outputs and gradients within ``FLASH_TOL``, each path's time
             and peak; ``train_long``: llama3.2-3b at full width and depth
             with ``--seq 4096 --batch 1``, 3 steps, attention blockwise in
             all 28 layers; ``train_dots``: the llama run of this phase with
             ``remat="dots"`` (the matrix products' outputs kept), 4 steps,
             its launches equal to full remat's and its ms a step and peak
             printed beside full remat's (``dots_vs_full``).  After
             ``flash``: ``serve_deepseek``, deepseek-v2-236b at full width
             (MLA, 160 experts top-6 and 2 shared; bf16 from seed 0) cut to
             4 of its 60 layers, through the contiguous ``prefill`` (8
             prompts of 512 tokens) and 32 absorbed ``decode_step``s with
             the latent caches in bf16 and in int8: finite logits, the first
             step's within ``LOGIT_TOL`` of the expanded-form decode's on
             the same cache, no kernel launched; prefill s, p50/p95 ms a
             step, tokens/s, peaks and the latent cache's bytes against a
             GQA cache of 128 x 128; and ``mla_check``, one MLA layer at
             deepseek-v2's full geometry: train mode forward + backward at
             B=1, S=4,096, blockwise against materialized within
             ``FLASH_TOL`` (output and input gradient, fp32 and bf16, each
             path's ms and peak), and the absorbed decode at position S
             against the expanded form's last row within
             ``MLA_DECODE_TOL``.
8. wire    — the int8 wire of data-parallel training.  The wire quantizer
             K2/K2b (sizes, bf16, unaligned pointers and Philox offsets,
             saturating formats, statistics on and off, a slot of a larger
             buffer, NaN), the fused decode-reduce K4 (1-300 ranks, several
             formats, ragged chunks, strided rows; for its TMA body a chunk
             shorter than a span, quanta below and above the span, a ragged
             last tile, rows at the int8 extremes; a 16-byte row stride from
             a base off 16 bytes on the grid-stride body; each launch on the
             body ``reduce_plan`` gives, by the TMA counter) and the grouped
             encoder's
             Philox source K3b (every owner's chunk of several layouts)
             against their plain versions, wire bytes and means bit-equal;
             K3's counts exact on a group of 16,781,312 elements.  At the
             path's shapes: K2 (bits operand, and nearest) and K2b on the
             w_in gradient leaf, K4 on one owner's [4, c] strided view of the
             full tree's layout (on the TMA body; ``torch.sum`` of the same
             int8 rows into fp32 timed beside it, the same bytes but not the
             same function), K3b and K3 with a bits operand on that
             owner's chunk, each timed beside its plain version and bound;
             then K2b, K4 and K3b the same way at mamba2-1.3b's shapes
             (``wire_kernels_mamba2``).
             Then ``dps_allreduce_mean_tree`` on a ragged tree over 4 ranks
             (scalar and per-leaf formats, nearest rounding, and stochastic
             with Philox and with a bits operand), kernels vs plain versions:
             means bit-equal; ``ProcessGroupTransport`` over NCCL with one
             rank equals ``StackedTransport(1)``.  Then ``repro_torch.launch.
             train --arch llama3_2_3b --steps 4 --batch 4 --seq 512
             --optimizer sgd --grad-allreduce-bits 8 --data-ranks 4``: 4
             data-parallel ranks on the card at full width, finite losses,
             the wire formats chosen on the device, and per step 4 x 11 K2b
             launches, 4 K4 (every one on the TMA body), 4 K3b and 280 K1b,
             as the CPU rehearsal of the step counts them.  Last, the same
             for 2 steps with
             ``--rounding-bits operand``: per step 4 x 11 K2, 4 K4, 4 K3 and
             1,603 K1 (stacked leaves one layer at a time).
9. zero    — ZeRO-1 and the overlapped bucketed wire.  On the ragged tree
             over 4 ranks (scalar and per-leaf formats; nearest, Philox and
             a bits operand), kernels vs plain versions: the bucketed
             all-reduce (bit-equal to the monolithic one too), the ZeRO
             reduce-scatter over one bucket and over a bucket a leaf (each
             owner's shard bit-equal to its chunk of the all-reduce's mean),
             the ZeRO params all-gather (K3/K3b with statistics and each
             owner's chunk of the mask), ``dps_reduce_scatter_mean`` and
             ``dps_allgather_params``; results bit-equal, statistics exact and
             to ``SUM_RTOL``.  At full width, the overlap run's largest
             bucket (the w_in leaf's, keyed by global leaf 7): 4 ranks
             encoded into it, then ``TreeAllReduce(layout=...)``'s K4 and
             leg-2 K3b on every owner's [4, 176,160,768] and the local
             decode, kernels vs plain, bytes and shards bit-equal; K4 and
             K3b timed there (and ``torch.sum`` beside K4).  K4 at every one
             of the overlap run's 11 buckets (owner 1's view, the bucket's
             tiles and formats): bit-equal on the TMA body, timed from a CUDA
             graph beside its bound, the sum x 4 owners printed as K4 a
             step.  LeNet over 4 ranks with ``zero_opt_shards=4``
             (every leaf quantized, so the params all-gather is int8): 3 steps
             kernel vs plain under nearest rounding, formats equal, loss to
             ``LENET_LOSS_RTOL``, per step 88 K1, 32 K2, 4 K4, 8 K3.  Then
             ``launch.train ... --data-ranks 4 --zero-opt`` and ``--zero-opt
             --wire-overlap on`` at full width, 4 steps each: ZeRO (and the
             overlap, 11 buckets) engaged, the first loss bit-equal to the
             wire run's and the later ones to ``ZERO_LOSS_RTOL``, per step
             4 x 11 K2b, 272 K1b and 4 K4 and 4 K3b (4 x 11 of each with the
             overlap), as the CPU rehearsal counts them, every K4 on the TMA
             body; every metric of
             every step of the overlap run bit-equal to the run without it.
             Then the health guards and the NaN drill on those two runs:
             guards_zero_idle (``--zero-opt --wire-overlap on --guards``, 4
             steps: every metric and launch of the overlap run bit-equal,
             health 0; its ms a step and peak beside that run's),
             guards_zero_nan (``--zero-opt --guards --inject-nan-at 1
             --guard-cooldown 1``) and guards_overlap_nan (the same with
             ``--wire-overlap on``): step 1 skipped with the flat
             parameters, the sharded momenta and the DPS state held exactly
             (device fingerprints, but for the trip's +1 IL on the compute
             gradients), step 2 on the fp32 reduce-scatter with no K2b, K4
             or K3b launch (the overlap's hooks issue no bucket collective)
             at a peak no higher than the int8 step 3's, step 3 with the
             unguarded run's launches; each step's synchronized wall time
             and peak printed.
Phases 10-14 run right after phase 8's counted wire run, before its
``--rounding-bits operand`` run.
10. ckpt_resume — checkpoint and resume at full width, cut in depth to
             ``CKPT_LAYERS`` of llama's 28 layers: run A, phase 8's wire
             argv on the cut config, writes its step-4 checkpoint
             (``--ckpt-dir``, the reference's format: 6.4 GB of fp32
             parameters and momenta) under a fresh directory in ``build/``,
             after a check that the disk there holds one such state (one
             exists at a time: A's arrays go once its digests are read,
             B's once B′ has restored them); run B
             takes ``--sigterm-at 2`` (a real SIGTERM: ``PREEMPTED``, a
             checkpoint at step 2, a clean return), run B′ ``--resume``s to
             step 4.  Held with no tolerance: B's steps 0-1 and B′'s steps
             2-3 equal A's in every metric, and B′'s step-4 manifest digests
             equal A's for every array (the whole state).  Printed: the free
             space, bytes on disk, and seconds and GB/s of each save's
             device → host copy (the stall the step loop sees) and background
             write plus hash, of ``verify_step`` and of ``restore``.
11. ckpt_corrupt — smoke size on the card: a bit flip and a truncation of
             the newest checkpoint are walked past by ``latest_step``,
             refused by ``restore``, and ``--resume`` lands on the good step;
             a ``--zero-opt`` run preempted and resumed equals its
             uninterrupted run (every metric, every digest).
12. guards_idle — the full-width wire run with ``--guards`` and no fault:
             every metric of phase 8's counted run (run A of phases 12-13)
             bit-equal, health 0; its ms a step and peak memory beside A's.
13. guards_nan — the same with ``--inject-nan-at 1 --guard-cooldown 1``:
             step 1 flags its NaN gradients, degrades and is skipped, the
             parameters, momenta and DPS state held exactly (device
             fingerprints: the int64 sum and the max of each leaf's 32-bit
             patterns, but for the trip's +1 IL on the compute gradients);
             step 2 runs the fp32 fallback with no K2b, K4 or K3b launch and
             the rest as run A; step 3 is back on int8 with A's launches.
14. rollback — smoke size on the card, the reference test's drill
             (``--inject-nan-at 5 --rollback-ring 2``, no guards): 1-8
             rollbacks, a finite replayed loss after each, the run completes.
15. families — the SSM, hybrid and encoder-decoder families at full width,
             inside phases 7 and 8.  After phase 7's other configs:
             ``train_mamba2`` (mamba2-1.3b, all 48 layers), ``train_zamba2``
             (zamba2-7b, 15 of 81 blocks: two shared invocations and a
             remainder of 3) and ``train_whisper`` (whisper-medium, 24 + 24
             layers, 1,500 zero frames), ``--batch 2 --seq 512``, SGD, each
             config's accumulation, 4 steps on K1b: finite losses, K1b a
             step equal to 3 x the quantized leaves + 2 taps a block a
             microbatch (each family's ``residual_taps``: the hybrid's
             shared block once an invocation, the encoder's blocks too);
             K1b timed on a leaf of each (mamba's ``layers/ssm/w_in``,
             836,763,648 fp32).
             After ``mla_check``: ``ssd_check`` (one Mamba2 layer at full
             geometry in fp32, S = 512, chunk 256: ``ssd_scan`` against the
             O(1) recurrence token by token within ``SSD_TOL``, its
             gradient finite; the largest chunk span of the decays, which
             past log(FLT_MAX) overflows the reference's unmasked
             ``exp``), then ``serve_mamba2``, ``serve_zamba2`` (27 of its
             81 blocks, for the call's time) and ``serve_whisper`` (bf16
             from seed 0; contiguous
             ``prefill`` of 8 prompts of 512 tokens, whisper's after seeded
             frames, then 32 greedy ``decode_step``s: finite logits, the
             first step's within ``FAMILY_FIRST_STEP_RTOL`` of ``forward``
             over the prompt and its token, in bf16 and with the same
             weights in fp32, and the bf16 step's within it of the fp32
             step's, at the served weights and at a second seed's; no
             kernel launched; prefill s, p50/p95 ms a step, peaks, cache
             bytes).  After phase 8's operand run:
             ``train_wire_mamba2`` (``--grad-allreduce-bits 8 --data-ranks
             4 --batch 8``, mamba2 at full depth, 2 microbatches a rank, 3
             steps: K2b, K3b and K4 at mamba's leaves, every K4 on the TMA
             body, the counts as the CPU rehearsal gives them); K2b on
             mamba's ``layers/ssm/w_in`` gradient and K4 and K3b on owner
             1's chunk of its tree under 4 ranks are held bit-equal to
             their plain versions and timed beside phase 8's path-shape
             checks (``wire_kernels_mamba2``).

16. moe_a2a — right after phase 7's other configs: ``moe_a2a_check`` (one
             MoE layer at qwen3-moe's full geometry, D 2,048, 128 experts,
             top-8, F 768, and deepseek-v2's, D 5,120, 160 experts, top-6,
             F 1,536, 2 shared; x (2, 512, D); on stacked (1, 4) and (2, 4)
             meshes in fp32 and bf16: the all-to-all dispatch against the
             einsum dispatch at capacity factor 8 and against a plain loop
             over the ranks with explicit concatenation
             (``moe_a2a_plain``) at 1.25, out, aux, dx and the router and
             expert gradients within ``A2A_TOL``; dropped choices under
             each; the int8 payload, every buffer element within
             ``A2A_SNAP`` of its 16-bit value unless saturated, its output
             against the 16-bit one, its expert gradient 0 as the
             reference's; forward + backward ms and peak of both
             dispatches), then ``train_qwen_ep`` (``launch.train.main``
             on qwen3-moe at 4 of 48 layers, ``--batch 2 --seq 512``, SGD,
             4 steps on K1b, inside ``axis_rules`` of a stacked (1, 4)
             mesh: every MoE call on the all-to-all dispatch, K1b a step
             equal to the einsum run's, finite losses; one step at
             capacity factor 8 against the einsum step from the same
             seed within ``EP_LOSS_RTOL``; line ``ep_vs_einsum``).

17. tp — after phase 14's dots run (``k1b_block`` runs right after
             phase 4: K1b in block mode at one rank's block of one layer of
             llama's w_in as ``place_tensor`` cuts it, at (1, 4) 3,072 ×
             2,048 of 8,192 columns and at (2, 4) 1,536 × 2,048: bit-equal
             to its plain version and to the unsharded launch on the same
             elements, timed three ways, one kernel a call, beside the
             contiguous launch on as many elements; rows
             ``dps_quantize_onchip_prng_block`` and ``..._block_2x4``, the
             launches of ``train_llama_tp`` at each mesh): ``tp_check`` (one llama
             layer at full geometry, x (2, 512, 3,072), fp32 and bf16, on
             stacked (1, 4) and (2, 4) meshes against the unsharded layer:
             output and every gradient within ``TP_TOL``; K1b's blocks of
             ``w_in``, ``wk`` and ``tok`` bit-equal to the unsharded launch,
             merged statistics exact or within ``SUM_RTOL``; ms and peak),
             ``train_llama_tp`` (``launch.train.main`` on llama3.2-3b at
             full width and depth, ``--batch 4 --seq 512``, SGD, 3 steps:
             unsharded, then ``mesh=`` stacked (1, 4) and (2, 4) — the
             placed step; formats equal every step, the first loss
             within ``TP_LOSS_RTOL``, K1b a step as the placement counts it, bytes
             a rank holds; the same three runs with fp32 compute: the
             first loss within ``TP_LOSS_RTOL_F32``, the parameters after
             one update apart on a share ≤ ``TP_FLIP_SHARE``, by at most
             ``TP_FLIP_STEPS`` grid steps)
             then ``guards_tp`` (the (1, 4) run again with ``--guards
             --inject-nan-at 1``: step 0 bit-equal to the unarmed run's,
             step 1 skipped with every held block's and the DPS state's
             fingerprint unchanged, step 2 updating; K1b a step as the
             placement counts it, the skipped step's too; ms a step armed
             against the unarmed run's)
             and ``train_tp_pg`` (a one-rank NCCL group: each
             block collective of the process-group transport bit-equal to
             the stacked one on CUDA tensors, then smoke llama's placed step
             over its (1, 1) ``DeviceMesh``).

18. tp_families — after phase 17: ``tp_families_check`` (each placed form
             the other families train through, at its config's full
             geometry, fp32 and bf16, on stacked (1, 4) and (2, 4) meshes
             against the whole layer within ``TP_TOL``, or twice the whole
             layer's own reordering noise where that is larger: deepseek-v2's
             MLA layer, the Mamba2 blocks of mamba2-1.3b and zamba2-7b,
             zamba2's shared block, whisper's encoder and decoder layers
             with random biases, internvl2's embedding with its 256-patch
             prefix; K1b's blocks of deepseek's stacked ``w_uk``, mamba2's
             stacked ``conv_w``, zamba2's shared ``wq`` and ``w_in`` and
             whisper's stacked ``bq`` bit-equal to the unsharded launch),
             then ``train_internvl2_tp``, ``train_mamba2_tp``,
             ``train_zamba2_tp`` and ``train_whisper_tp`` (each config at
             the depth phases 8–9 train it, ``launch.train.main`` placed on
             a stacked (1, 4) mesh against that unsharded run's first 3
             steps: formats equal every step, the first loss within
             ``TP_LOSS_RTOL`` or twice bf16's own size on the model, K1b a
             step as the placement counts it; one fp32 step unsharded and
             placed, their first losses within ``TP_FAMILY_LOSS_RTOL_F32``;
             ms a step, peak, bytes a rank).  deepseek-v2-236b's placed
             step needs several cards and runs on the CPU only.
19. serve_tp — after phase 18: ``serve_llama_tp`` (llama3.2-3b, 14 of
             28 layers since PR 28, served through ``launch.specs.build_prefill_step``/
             ``build_decode_step`` with a mesh: unsharded, then placed on
             stacked (1, 4) and (2, 4) meshes by ``place_serve_state``,
             its cache bf16 and int8, bf16 weights and the same cast up to
             fp32; batch 8 × 512, 16 decode steps teacher-forced from the
             unsharded bf16 run's greedy tokens: the logits, the greedy
             tokens past the top-2 margin, the gathered caches and ``pos``
             against the unsharded run's — fp32 within
             ``SERVE_TP_F32_RTOL`` (int8 caches one grid step at most and
             at a rounding boundary), bf16 within ``SERVE_TP_BF16_GAPS``
             times bf16's own gap from fp32 — the bytes each rank holds of
             the cache equal to ``spec_bytes`` of ``decode_shardings``',
             prefill s, p50/p95 ms a decode step, peak, no kernel
             launched), then ``serve_families_tp`` (deepseek-v2 2 of 60,
             qwen3-moe 4 of 48, internvl2 3 of 48 with its 256-patch
             prefix, mamba2, zamba2 13 of 81, whisper with seeded frames,
             each at full width on a stacked (1, 4) mesh, batch 8 × 256,
             4 decode steps, held the same way; the MoE models' prefill on
             the all-to-all, the unsharded run under the mesh's binding;
             their decode on the einsum dispatch split as the reference's
             compiled step splits it — key
             ``expert_gather_bytes_a_decode_step``: the expert bytes one
             rank gathers a step, counted from a trace of one MoE layer,
             and held to 0).
20. analysis — after phase 19: the port's precision-flow verifier on the
             card, through the kernels (``repro_torch.analysis.lint`` on a
             stacked data mesh of 8 ranks): LeNet ``tree`` (K1b, K2b, K4)
             and ``zero-overlap`` (K2b, K3b, K4), ``tree`` with the health
             guards (the clean step, then the NaN drill's degraded step on
             its own claims) and ``serve-decode`` at smoke size (K3, K5),
             each step recorded by a ``Trace``: every flow, trace-audit and
             geometry report clean, every recorded launch held to the loaded
             library's signatures and the card's shared memory
             (``torch.cuda.get_device_properties``), K2b, K3b, K4, K3 and K5
             each launched under the trace; then one dry-run cell on meta
             tensors (llama3.2-3b ``decode_32k`` on the (16, 16) mesh).  One
             line ``analysis`` with each report's checked and fired rules,
             the phase's seconds and its launches.

The line before the last two carries the kernels (launches on their path —
K1's from the LM run with a bits operand, LeNet's beside them; K1b's row
adds ``launches_train_long``, ``launches_train_dots``,
``launches_paper_fig4`` (the DPS and fixed 13-bit arms) and
``launches_train_qwen_ep``, ``launches_train_llama_tp_1x4``/``_2x4``,
``launches_guards_tp``
and ``launches_train_<config>_tp`` of phase 18 (the placed runs; their
block-mode launches are the ``dps_quantize_onchip_prng_block`` row's,
llama's (1, 4) as its ``launches``);
K2b's, K3b's
and K4's from the wire run; K2's from the wire run with a bits operand; K5's
from the serving run, on its serving-shape row (a row of another config's
shape, ``<kernel>_<config>``, names the run it counts, ``serve_<config>`` or
``train_<config>`` or ``train_wire_mamba2``), and 0 on the row that times
the same kernel at 8 x 4,096 tokens, a shape no path here runs (that row says
``"on_path": false``); a row launched by the zero phase adds
``launches_lenet_zero`` and ``launches_zero`` (and ``launches_zero_overlap``
where the overlap launches it at the row's shape); K4 and K3b have a second
row each at the overlap's w_in bucket, whose launches are every per-bucket
launch of the overlap run (``"run"`` and ``"counter"`` name them), and
K4's rows add ``body``, ``torch_sum_ms`` and, at the bucket, every bucket's
time and K4 a step —
error against the plain
version, time, plain time, bound; K2b's row adds its time at nearest
rounding without statistics, the bare pipe); the line before
the last is ``nvidia-smi``'s name and power limit; the last line of standard
output is ``{"ok": true, "device": {"platform": "gpu", "kind": <name>,
"count": <n>}}``.  There is no CPU path here: without a CUDA device the
script exits non-zero.
"""

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this script "
             "runs the CUDA kernels and has no CPU path")

from kernel_ab import device_kernels, time_graph_ms, time_ms         # noqa: E402
from repro_torch.configs.base import get_config                      # noqa: E402
from repro_torch.kernels import _build, dps_quant, paged_attn        # noqa: E402
from repro_torch.models import registry                              # noqa: E402
from repro_torch.models.common import init_params, unembed           # noqa: E402
from repro_torch.serve import (Engine, EngineConfig, PagedLayout,    # noqa: E402
                               cache as kvc, synthetic_trace)

DEV = torch.device("cuda", 0)

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# fp32 rate outside the tensor cores, which is what both kernels use
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12

ATTN_TOL = 1e-5      # fp32 attention output; the sums run in another order
SUM_RTOL = 2e-6      # float statistics; thousands of fp32 terms, other order
# First-step logits, kernel engine vs plain engine, bf16 model.  The two
# attention outputs differ by <= 1e-5 in fp32, but each layer casts them to
# bf16 (8 bits of mantissa): a difference that small can still tip a
# rounding by one bf16 step (2^-8 relative), and 28 layers carry it on to
# logits of magnitude ~1.  Measured on an H100: 0.062.  The other configs
# are held to the same tolerance, their logits of the same magnitude
# (|max| 4-5): gemma-7b 0.059, mistral-large-123b (8 layers) 0.038,
# nemotron-4-340b (2 layers) 0.021, qwen3-moe-30b-a3b (32 layers) 0.131 (a
# bf16 tip in a router's input can also reorder a token's top-8 experts).
LOGIT_TOL = 0.25
# LeNet under nearest rounding, kernel quantizer vs plain: the grid values are
# bit-equal, so the two runs differ only where the statistics' float sums
# (another summation order) could move a controller decision; they do not.
LENET_LOSS_RTOL = 1e-5

TORCH_SUM_NOTE = ("torch.sum(view, dim=0, dtype=torch.float32): same "
                  "bytes, not the same function; the port never calls it")

SERVE = dict(page_size=16, slots=8, max_prompt=512, max_new=64,
             requests=16, prompt_lens=(64, 512), new_tokens=(16, 64),
             mean_gap=0.5, seed=0)


# The other configs, at full width: (config module, layers served; None =
# every layer).  gemma-7b serves whole (17.1 GB of bf16 weights);
# mistral-large-123b and nemotron-4-340b are cut in depth only, to what one
# 80 GB card holds beside the fp32 unembedding the engine keeps (23.8 + 1.6
# GB and 32.7 + 18.9 GB); qwen3-moe-30b-a3b (MoE, 128 experts top-8) to 32
# of 48 layers, where drawing the weights peaks near 66 GB (each stacked
# expert leaf is drawn in fp32, 25.8 GB, beside the bf16 leaves before it;
# 40 GB of bf16 weights served).
OTHER_SERVE = (("gemma_7b", None), ("mistral_large_123b", 8),
               ("nemotron_4_340b", 2), ("qwen3_moe_30b_a3b", 32))
# trained at full width, cut in depth, under each config's own gradient
# accumulation: (config module, layers, --batch, the leaf K1b is timed on).
# nemotron-4-340b does not train on one card even at one layer (12.9 B
# parameters).  qwen3-moe at 4 of 48 layers (2.80 B parameters; its stacked
# expert leaves 805 M elements each); internvl2-26b (VLM) at 3 of 48 (2.31
# B), its batches 512 tokens after the 256-patch vision prefix.
OTHER_TRAIN = (("gemma_7b", 8, 2, ("layers", "mlp", "w_in")),
               ("mistral_large_123b", 1, 4, ("embed", "unembed")),
               ("qwen3_moe_30b_a3b", 4, 2, ("layers", "moe", "w_in")),
               ("internvl2_26b", 3, 2, ("layers", "mlp", "w_in")))
# The SSM, hybrid and encoder-decoder families trained at full width under
# their own accumulation (mamba2 and zamba2: 2; whisper: 1), ``--batch 2``:
# (config module, layers (None: all), --batch, the leaf K1b is timed on,
# phase).  mamba2-1.3b whole (48 layers; its stacked ``layers/ssm/w_in`` is
# 836,763,648 fp32 values); zamba2-7b at 15 of its 81 blocks (two shared
# invocations and a remainder of 3, the structure of 81 = 13 x 6 + 3; 1.49
# B parameters); whisper-medium whole (24 + 24 layers, 1,500 zero frames).
FAMILY_TRAIN = (
    ("mamba2_1_3b", None, 2, ("layers", "ssm", "w_in"), "train_mamba2"),
    ("zamba2_7b", 15, 2, ("mamba", "ssm", "w_in"), "train_zamba2"),
    ("whisper_medium", None, 2, ("dec_layers", "mlp", "w_in"),
     "train_whisper"))
# ... and served through their contiguous prefill/decode_step (none is
# paged in the reference), bf16 weights from seed 0: (config module,
# layers (None: all), phase).  zamba2-7b at 27 of its 81 blocks (four
# shared invocations and a remainder of 3, the structure of 81 = 13 x 6 +
# 3): the call's time, which passed the card's limit on a slow host with
# phase 19 added, and this path's checks hold at any depth (first-step
# errors that grow with it, under limits read at 81 blocks)
FAMILY_SERVE = (("mamba2_1_3b", None, "serve_mamba2"),
                ("zamba2_7b", 27, "serve_zamba2"),
                ("whisper_medium", None, "serve_whisper"))
# B prompts of `prompt` tokens (whisper: after seeded frames), then `steps`
# greedy decode steps
FAMILY_SERVE_SHAPE = dict(batch=8, prompt=512, steps=32, max_seq=576)
# The first decode step's logits, relative to the largest logit of what
# they are held against, per config: "float32" and "bfloat16", against
# ``forward`` over the prompt and its token; "bfloat16_vs_float32", the
# bf16 step against the fp32 step of the same weights (cast up exactly) fed
# the same token.  fp32 against the recomputation: the SSM's chunked scan
# and its O(1) recurrence (and a fresh prefill's attention against the
# cached one) sum the same terms in another order, ~5e-6 a layer
# (``ssd_check``) carried through 48-94 blocks.  bf16 against it: the
# chunked scan also rounds dt·x to bf16 where the recurrence keeps it in
# fp32 (both as the reference computes them); the two share every other
# rounding.  bf16 against fp32: every block's bf16 roundings, carried
# through the depth (the port's drift from fp32 is held to the reference's
# own at smoke size by ``test_bf16_drift_matches_reference``).  Measured on an H100 at seeds 0 / 1 (mamba2, zamba2, whisper):
# fp32 1.1e-4 / 1.1e-4, 1.2e-4 / 1.3e-4, 1.0e-6 / 1.0e-6; bf16 0.036 /
# 0.034, 0.116 / 0.107, 0.010 / 0.011; bf16 vs fp32 0.32 / 0.26, 0.42 /
# 0.44, 0.012 / 0.012 (largest logits 4.2-4.6, 5.4-5.9, 2.9-3.0).  Each
# bf16 limit is about twice the larger of the two seeds' readings.
FAMILY_FIRST_STEP_RTOL = {
    "mamba2_1_3b": {"float32": 1e-3, "bfloat16": 0.08,
                    "bfloat16_vs_float32": 0.65},
    "zamba2_7b": {"float32": 1e-3, "bfloat16": 0.25,
                  "bfloat16_vs_float32": 0.9},
    "whisper_medium": {"float32": 1e-3, "bfloat16": 0.025,
                       "bfloat16_vs_float32": 0.025}}
# the served weights' seed, then the seeds whose first step is held too
FAMILY_CHECK_SEEDS = (0, 1)
# one Mamba2 layer at mamba2-1.3b's full geometry in fp32: the chunked
# ssd_scan (chunk 256) against the O(1) recurrence run token by token over
# `SSD_SEQ` positions, relative to the largest magnitude (the same state sums
# in another order; measured 5.4e-6 on an H100, 5.1e-6 at smoke width on the
# CPU)
SSD_SEQ = 512
SSD_TOL = 1e-4
# the wire run on mamba2-1.3b at full depth: 4 ranks, --batch 8 (2 rows a
# rank, its 2 microbatches of 1 x 512)
MAMBA_WIRE = dict(steps=3, n_ranks=4, batch=8)
# llama3.2-3b trained at train_4k's sequence (4,096; the batch cut to one
# card), attention blockwise in every layer
LONG_SEQ = 4096
# _attn_flash against _attn_full on the card at llama's attention shape
# (B=1, 4,095 positions, 24 heads, Dh=128), outputs and gradients, each
# error over the largest magnitude of the materialized path's: fp32
# inputs (the same fp32 math summed in another order), and bf16 inputs as
# the path gives them (the blockwise path casts its unnormalized
# probabilities to bf16 where the materialized one casts the normalized
# ones: each a 2^-9 relative rounding, and the output another)
FLASH_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# The paper's Fig. 4 (benchmarks/bench_convergence.py's arms and claims):
# fp32, DPS and fixed 13-bit LeNet for the paper's 2,000 steps each
FIG4_STEPS = 2000
# the initializations: seed 0, where the claims are read (the recipe
# diverges from some, fp32 included); seeds 1 and 2 are cut for the call's
# time (the three took 148-276 s of it on an H100)
FIG4_SEEDS = (0,)
# the fp32 arm's first losses on the card against a CPU run's from the same
# parameters (convolutions summed in other orders; the early transient
# amplifies a difference only after a few steps)
FIG4_HELD_STEPS = 3
FIG4_LOSS_RTOL = 1e-4
# deepseek-v2-236b served at full width, cut to 4 of its 60 layers: a layer
# is 3.97 B parameters (149 M of MLA, 3.82 B of experts), 7.94 GB of bf16;
# each stacked expert leaf is drawn in fp32 (5.03 GB a layer) before its
# cast, so drawing the third peaks near 54 GB (two bf16 expert leaves, 20.1
# GB, the third's fp32 draw and its cast, 30.2, the MLA weights and the
# untied tables, 3.3); 36 GB served with the fp32 unembedding held.  A 5th
# layer would take the init peak to ~67 GB.  B prompts of `prompt` tokens,
# then `steps` absorbed decode steps, at each latent-cache width.
DEEPSEEK_LAYERS = 4
DEEPSEEK_SERVE = dict(batch=8, prompt=512, steps=32, max_seq=576)
# one MLA layer at deepseek-v2's full geometry (H=128, q_lora 1,536, kv_lora
# 512, rope 64, v 128), train mode at B=1: the materialized path's fp32
# scores are 128 x 4,096^2 x 4 B = 8.6 GB, and with the softmax's output
# and the two score gradients of its backward ~35-45 GB, under 60 GB
MLA_SEQ = 4096
# the absorbed decode at position S against the expanded form's last row
# over S + 1 positions, relative to the largest magnitude: fp32, the same
# products summed in another order ((q·W_uk)·c against q·(W_uk·c)); bf16,
# each form rounding its products to bf16 at other points (q_c and the
# context in one, per-head K and V in the other: 2^-9 relative each)
MLA_DECODE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# One MoE layer at full geometry on stacked (data, model) meshes: x (2, 512,
# D), the loss sum(out * w) + aux.  qwen3-moe: D 2,048, 128 experts, top-8,
# F 768; deepseek-v2: D 5,120, 160 experts, top-6, F 1,536, 2 shared
# experts (7.5 GB of bf16 experts)
A2A_GEOMETRIES = (("qwen3_moe_30b_a3b", (2, 512)),
                  ("deepseek_v2_236b", (2, 512)))
A2A_MESHES = ((1, 4), (2, 4))
# Limits on the largest difference over the largest magnitude of each of
# out, aux, dx and the router and expert gradients: the a2a against the
# einsum dispatch at capacity factor 8 (no drops: the same function, its
# products in other shapes), and the stacked a2a against the plain loop at
# the configs' 1.25 (the same products at the same shapes; dx sums each
# token's k gradient rows in another order).  Measured on an H100 over both
# geometries and meshes: vs einsum 9.5e-7 to 2.0e-6 (fp32), 2.5e-3 to
# 5.9e-3 (bf16); vs plain 7.5e-8 to 1.5e-7 (fp32), 9.9e-3 to 1.01e-2
# (bf16, dx; 0 elsewhere).  Each limit is at most 10x the smallest reading
# it bounds.
A2A_TOL = {"vs_einsum": {"float32": 5e-6, "bfloat16": 2.5e-2},
           "vs_plain": {"float32": 5e-7, "bfloat16": 5e-2}}
# the int8 payload: each buffer element snapped to the <4, 4> grid moves by
# at most half a grid step unless it saturates
A2A_SNAP = 1.0 / 32
# qwen3-moe trained over a stacked (1, 4) model axis, and one step at
# capacity factor 8 against the einsum dispatch's from the same seed: the
# first losses, relative (bf16 compute, the products in other shapes;
# measured 1.7e-4 on an H100)
EP_MESH = (1, 4)
EP_LOSS_RTOL = 1e-3

# phase 17 (the sharded train step): llama3.2-3b placed over stacked
# (data, model) meshes, its layer against the unsharded one (max |diff|
# over max |value| of the output and every gradient), and its training
# run's losses against the unsharded run's
TP_MESHES = ((1, 4), (2, 4))
TP_STEPS, TP_BATCH = 3, 4
TP_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
# the first loss (before any update) against the unsharded run's, by mesh
TP_LOSS_RTOL = {"1x4": 2e-4, "2x4": 2e-4}
# the same training runs with fp32 compute (the bf16 gap's cause): the
# first loss, and the share of parameters that differ after one update and
# by how many weight-grid steps (measured 7.7e-8 / 6.9e-7, 0.89 % and 7
# steps on an H100)
TP_LOSS_RTOL_F32 = {"1x4": 5e-7, "2x4": 5e-6}
TP_FLIP_SHARE = {"1x4": 0.02, "2x4": 0.02}
TP_FLIP_STEPS = 16
# phase 18 (every family on the placed step): the other families trained
# placed on a stacked (1, 4) mesh at full width, against their unsharded
# runs of phases 8-9 (the same argv but TP_STEPS steps, the first TP_STEPS
# compared): (config module, layers (None: all), phase), the depth those
# runs train at.  At mamba2's 12 of 48 layers (and llama's 14 of 28 in
# train_llama_tp) the placed bf16 run's activation error sends fl_a to 10
# where the unsharded run's sends it to 12 at step 3 (ROADMAP Queue 3), so
# the depths are not cut further.  deepseek-v2-236b does not train on one
# card at any depth (one layer and its untied tables are ~5.0 B
# parameters, ~80 GB of fp32 weights, momentum, gradient and snap): its
# MLA layer is held at full width by ``tp_families_check`` and its placed
# step on the CPU.
TP_FAMILY_MESH = (1, 4)
TP_FAMILY_TRAIN = (("internvl2_26b", 3, "train_internvl2_tp"),
                   ("mamba2_1_3b", None, "train_mamba2_tp"),
                   ("zamba2_7b", 15, "train_zamba2_tp"),
                   ("whisper_medium", None, "train_whisper_tp"))
# their first losses with fp32 compute, placed against unsharded, by
# config: about twice the larger of seeds 0 and 1's readings on an H100
# (internvl2 4.9e-7 / 1.6e-7, mamba2 2.0e-6 / 4.0e-6, zamba2 2.2e-6 /
# 2.9e-6, whisper 8.6e-8 / 8.6e-8): the SSM carries a last-bit difference
# through its blocks further than attention does
TP_FAMILY_LOSS_RTOL_F32 = {"internvl2_26b": 1e-6, "mamba2_1_3b": 8e-6,
                           "zamba2_7b": 6e-6, "whisper_medium": 2e-7}

# phase 19 (placed prefill and decode): llama3.2-3b served at
# SERVE_TP_LAYERS of its 28 layers, unsharded and placed on stacked (1, 4)
# and (2, 4) meshes
# (``launch.specs.build_prefill_step``/``build_decode_step`` with a mesh),
# its cache in the compute dtype and int8, bf16 weights from seed 0 and
# the same weights cast up to fp32: B prompts of `prompt` tokens, then
# `steps` decode steps, every run fed the unsharded bf16 run's greedy
# tokens (teacher-forced, so that a near-tie cannot fork the rest)
SERVE_TP_SHAPE = dict(batch=8, prompt=512, steps=16, max_seq=576)
# serve_llama_tp's depth: 14 of the 28 layers, for the call's time (the
# phase launches no kernel).  Its readings at 14 layers on an H100 at 700 W
# sit where the 28-layer ones did, so the limits below hold them at about
# twice as before: fp32 logits 3.4e-6 / 3.5e-6 and 16-bit caches 4.1e-6 -
# 4.6e-6 at (1, 4) / (2, 4) (28 layers: 3.5e-6 / 4.9e-6), fp32 int8-cache
# logits 2.07e-4 / 2.04e-4 (28: 1.8e-4), bf16 logits and caches 0.91-1.24x
# bf16's own gap and int8 caches 2 grid steps against its 3
SERVE_TP_LAYERS = 14
# fp32 compute, placed against unsharded, by config: the logits and the
# 16-bit caches relative to their largest magnitude, about twice the
# larger reading of the two on an H100 at 700 W (the same sums in other
# orders through the depth: llama 3.5e-6 / 4.9e-6, deepseek 2.8e-6 /
# 2.4e-6, qwen3-moe 1.3e-6 / 2.8e-6, internvl2 7.2e-6 / 6.6e-6, whisper
# 9.2e-7 / 1.9e-6; the SSM carries a last-bit difference through its
# blocks further, as phase 18's losses and the chunked scan against the
# recurrence (1.1e-4, serve_mamba2) show: mamba2 2.1e-4 / 1.6e-4 at 48
# layers, zamba2 1.3e-5 / 1.8e-5 at 13 blocks).  An int8 entry at most one
# grid step off the unsharded one, and at the prompt's positions (where
# the fp32 16-bit run's cache holds the very values packed) only next to a
# <3, 5> rounding boundary of that value: within 32 x the config's limit
# x its largest magnitude, in grid steps (measured 4.9e-4 steps of a
# 1.6e-3 limit).  With the int8 cache the logits take
# SERVE_TP_F32_INT8_RTOL: a key or value that rounds to the neighbouring
# grid point (1/32) moves every later layer's attention (measured
# 1.8e-4).  bf16 compute: each quantity within SERVE_TP_BF16_GAPS times
# bf16's own distance from fp32 at the same weights (the rule
# train_family_tp holds losses to; measured 0.47-1.2x for the logits, 3
# grid steps of an int8 cache against bf16's own 3)
SERVE_TP_F32_RTOL = {"llama3_2_3b": 1e-5, "deepseek_v2_236b": 1e-5,
                     "qwen3_moe_30b_a3b": 1e-5, "internvl2_26b": 2e-5,
                     "mamba2_1_3b": 5e-4, "zamba2_7b": 4e-5,
                     "whisper_medium": 1e-5}
SERVE_TP_F32_INT8_RTOL = 4e-4
SERVE_TP_BF16_GAPS = 2.0
# phase 19's other families on a stacked (1, 4) mesh, at full width, cut in
# depth to what one card holds in fp32 beside its placed copy and to the
# phase's time: (config module, layers (None: all)).  deepseek-v2 at 2 of
# 60 layers (8.2 B parameters: 33 GB of fp32 weights, its 10 GB stacked
# expert leaf placed beside them), qwen3-moe at 4 of 48 and internvl2 at 3
# of 48 (the depths phases 7 and 18 train them at), zamba2 at 13 of 81
# blocks (two shared invocations and a remainder, the structure of 81 =
# 13 x 6 + 3), mamba2 and whisper whole
SERVE_TP_FAMILIES = (("deepseek_v2_236b", 2), ("qwen3_moe_30b_a3b", 4),
                     ("internvl2_26b", 3), ("mamba2_1_3b", None),
                     ("zamba2_7b", 13), ("whisper_medium", None))
SERVE_TP_FAMILY_SHAPE = dict(batch=8, prompt=256, steps=4, max_seq=264)


def depth_cut(model, layers=None):
    """``model``'s config at full width, cut to ``layers`` layers."""
    cfg = get_config(model)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


T0 = time.perf_counter()


def say(phase, **kw):
    """One phase's JSON line, with the seconds since the script started
    (``at_s``: what each phase adds to the call)."""
    print(json.dumps({"phase": phase, "at_s": round(time.perf_counter() - T0,
                                                    1), **kw}), flush=True)


def serve_layout():
    ps = SERVE["page_size"]
    prompt_pages = SERVE["max_prompt"] // ps
    pages_per_seq = prompt_pages + -(-SERVE["max_new"] // ps) + 1
    return PagedLayout(page_size=ps, n_pages=SERVE["slots"] * pages_per_seq,
                       batch_slots=SERVE["slots"],
                       max_pages_per_seq=pages_per_seq,
                       max_prompt=SERVE["max_prompt"])


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def bound(nbytes, ops):
    """The least time the card could take: bytes over its memory rate or
    fp32 operations over its fp32 rate, whichever is larger."""
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_OPS_PER_S * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

def encode_inputs(rng, tiles, quantum, groups, dtype=torch.float32, tg=None,
                  offset=0):
    """K3's operands: ``tiles`` tiles of ``quantum`` elements over a sorted
    random map onto ``groups`` table rows (one a tile when they are as
    many; ``tg`` a given map); ``offset`` > 0 gives x, bits and mask as
    views off 16-byte boundaries (the element path)."""
    n = tiles * quantum
    x = rng.standard_normal(n + offset).astype(np.float32) * np.concatenate(
        [np.ones(offset), np.repeat(2.0 ** rng.integers(-4, 4, tiles),
                                    quantum)]).astype(np.float32)
    x[::13] = 0.0
    il = rng.integers(1, 6, groups)
    tab = np.stack([il, 8 - il + rng.integers(0, 3, groups)], 1).astype(np.int32)
    if tg is None:
        tg = np.sort(rng.integers(0, groups, tiles)).astype(np.int32)
        if groups == tiles:
            tg = np.arange(tiles, dtype=np.int32)
    tg = np.asarray(tg, np.int32)
    bits = rng.integers(0, 2**32, n + offset, dtype=np.uint32).view(np.int32)
    mask = (rng.random(n + offset) > 0.15).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(DEV)
    return dict(x=t(x).to(dtype)[offset:], fmt_tab=t(tab), tile_group=t(tg),
                bits=t(bits)[offset:], mask=t(mask)[offset:], quantum=quantum)


def check_encode(inp, *, stochastic, masked, emit_stats):
    """Kernel vs plain on the card: bytes equal; count/nonzero/overflow/max
    exact, float sums to SUM_RTOL.  Returns the largest byte difference and
    the largest relative difference of a float sum."""
    args = (inp["x"], inp["fmt_tab"], inp["tile_group"],
            inp["bits"] if stochastic else None,
            inp["mask"] if masked else None)
    kw = dict(quantum=inp["quantum"], emit_stats=emit_stats)
    wk, sk = dps_quant.dps_quant_group_wire(*args, backend="kernel", **kw)
    wp, sp = dps_quant.dps_quant_group_wire(*args, backend="plain", **kw)
    torch.cuda.synchronize()
    byte_err = int((wk.to(torch.int16) - wp.to(torch.int16)).abs().max())
    if byte_err:
        raise AssertionError(f"grouped wire encode: bytes differ by {byte_err} "
                             f"(quantum {inp['quantum']}, stochastic={stochastic})")
    rel = 0.0
    if emit_stats:
        exact = [0, 1, 2, 6]
        if not torch.equal(sk[:, exact], sp[:, exact]):
            raise AssertionError("grouped wire encode: count/nonzero/overflow/"
                                 "max_abs differ from the plain version")
        sums_k, sums_p = sk[:, 3:6], sp[:, 3:6]
        rel = float(((sums_k - sums_p).abs()
                     / sums_p.abs().clamp(min=1e-30)).max())
        if rel > SUM_RTOL:
            raise AssertionError(f"grouped wire encode: float sums differ by "
                                 f"{rel:.3g} relative (> {SUM_RTOL})")
        # a second launch gives the same bits: no atomics, fixed order
        _, sk2 = dps_quant.dps_quant_group_wire(*args, backend="kernel", **kw)
        if not torch.equal(sk, sk2):
            raise AssertionError("grouped wire encode: statistics changed "
                                 "between two launches")
    elif sk is not None:
        raise AssertionError("emit_stats=False returned statistics")
    return float(byte_err), rel


def attn_inputs(rng, B, P, ps, KV, G, Dh, lens, int8):
    n_pages = B * P + 1
    t = lambda a: torch.from_numpy(a).to(DEV)
    shp = (n_pages, ps, KV, Dh)
    if int8:
        # grid integers of roughly unit-variance K/V, as a normalized
        # transformer produces them: the absolute tolerance is for that scale
        draw = lambda: np.clip(np.rint(rng.standard_normal(shp) * 32.0),
                               -128, 127).astype(np.int8)
        kp, vp = draw(), draw()
        fmt = rng.integers(5, 8, (n_pages, 2)).astype(np.int32)
    else:
        kp = rng.standard_normal(shp).astype(np.float32)
        vp = rng.standard_normal(shp).astype(np.float32)
        fmt = np.zeros((n_pages, 2), np.int32)
    lens = np.asarray(lens, np.int32)
    ptab = rng.permutation(n_pages - 1)[:B * P].reshape(B, P).astype(np.int32)
    for b in range(B):       # entries past a row's last page: the trash page
        ptab[b, -(-int(lens[b]) // ps):] = n_pages - 1
    q = rng.standard_normal((B, KV * G, Dh)).astype(np.float32)
    return dict(q=t(q), k_pages=t(kp), v_pages=t(vp), fmt=t(fmt),
                ptab=t(ptab), lens=t(lens), scale=float(Dh) ** -0.5)


def check_attn(inp):
    args = (inp["q"], inp["k_pages"], inp["v_pages"], inp["fmt"], inp["ptab"],
            inp["lens"])
    ok = paged_attn.paged_decode_attn(*args, scale=inp["scale"], backend="kernel")
    op = paged_attn.paged_decode_attn(*args, scale=inp["scale"], backend="plain")
    torch.cuda.synchronize()
    if ok.shape != op.shape or not bool(torch.isfinite(ok).all()):
        raise AssertionError("paged attention: non-finite or misshapen output")
    err = float((ok - op).abs().max())
    if err > ATTN_TOL:
        raise AssertionError(f"paged attention: max abs err {err:.3g} > {ATTN_TOL}")
    empty = inp["lens"] == 0
    if bool(empty.any()) and bool((ok[empty] != 0).any()):
        raise AssertionError("paged attention: a row of length 0 is not exactly 0")
    again = paged_attn.paged_decode_attn(*args, scale=inp["scale"], backend="kernel")
    if not torch.equal(ok, again):
        raise AssertionError("paged attention: two launches gave different bits")
    return err


def attn_bytes_ops(B, H, KV, Dh, ps, P, lens):
    """Bytes K5 must move (int8 K and V of the valid tokens, q in, out, the
    page table, the lengths, the live pages' FL rows) and its fp32
    operations (q·k and p·v, a multiply and an add each)."""
    tokens = sum(lens)
    nbytes = (2 * tokens * KV * Dh + 2 * 4 * B * H * Dh + 4 * B * P + 4 * B
              + 8 * sum(-(-t // ps) for t in lens))
    return nbytes, 4 * tokens * H * Dh


def _attn_call(inp, backend):
    args = (inp["q"], inp["k_pages"], inp["v_pages"], inp["fmt"], inp["ptab"],
            inp["lens"])
    return lambda: paged_attn.paged_decode_attn(*args, scale=inp["scale"],
                                                backend=backend)


def _split_edge_case(KV, G, Dh, int8, ps=16):
    """A small K5 case at head geometry (G, Dh): rows of 2 splits, of
    exactly one, one token either side of it, and an empty row, where a
    split is what ``split_plan`` gives this pool (128 tokens of an int8
    pool at Dh <= 192, 96 at Dh = 256; fewer in an fp32 pool)."""
    sp = paged_attn.split_plan(1, ps, 1, KV, G, Dh, 1 if int8 else 4)[0]
    S = sp * ps
    lens = [2 * S, S, S - 1, S + 1, 0]
    return (len(lens), 2 * sp + 1, ps, KV, G, Dh, lens, int8)


def serve_shape_rows(rng, cfg, lay, model=None):
    """K3 and K5 at the shapes ``cfg``'s serving path gives them, each held
    against its plain version and timed beside it and its bound: the page
    encoder on one admission's 2·L·(prompt pages) tiles of 16·KV·Dh, the
    decode attention on the serving batch (int8 pool, and an fp32 pool of
    the same shape checked).  ``model``: the config's module name, for the
    rows of a model other than the first; those rows take the name
    ``<kernel>_<model>`` and their launches from ``serve_<model>``'s run."""
    L, KV, Dh, H = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    E = lay.page_size * KV * Dh
    T = 2 * L * lay.prompt_pages
    enc = encode_inputs(rng, T, E, T)
    # as write_prompt_pages calls it: nearest, no mask (the buffer is zeroed
    # past the prompt), no statistics; the reference's masked call; and
    # everything on, at the same size
    enc_err, _ = check_encode(enc, stochastic=False, masked=False, emit_stats=False)
    enc_err = max(enc_err, check_encode(enc, stochastic=False, masked=True,
                                        emit_stats=False)[0])
    _, enc_rel = check_encode(enc, stochastic=True, masked=True, emit_stats=True)
    n = T * E
    enc_ops = 12 * n                                   # scale, 3 clips, round, mask...
    timed = {}
    for masked in (False, True):
        # x, the mask (the reference's call), wire, map, table
        nbytes = 4 * n + (4 * n if masked else 0) + n + 4 * T + 8 * T
        args = (enc["x"], enc["fmt_tab"], enc["tile_group"], None,
                enc["mask"] if masked else None)
        call = lambda: dps_quant.dps_quant_group_wire(
            *args, quantum=E, emit_stats=False, backend="kernel")
        per_call, _ = device_kernels(call)
        if per_call != 1:
            raise AssertionError(f"K3 at {cfg.name}'s admission: {per_call} "
                                 "device kernels a call")
        timed[masked] = dict(
            ms=time_ms(call, repeats=20),
            ms_graph_clean=time_graph_ms(call, repeats=20, clean=True),
            kernels_a_call=per_call, bytes=nbytes,
            plain_ms=time_ms(lambda: dps_quant.dps_quant_group_wire(
                *args, quantum=E, emit_stats=False, backend="plain"),
                repeats=5, warmup=1))
        timed[masked]["bound_ms"], timed[masked]["bound_by"] = bound(nbytes,
                                                                     enc_ops)
    del enc, args

    B, P = lay.batch_slots, lay.max_pages_per_seq
    G = H // KV
    # decode lengths as the trace produces them: prompts of 64-512 tokens
    # plus up to 64 generated, one idle slot
    lens = [577, 512, 300, 129, 64, 65, 1, 0]
    att = attn_inputs(rng, B, P, lay.page_size, KV, G, Dh, lens, True)
    att_err = check_attn(att)
    att32 = attn_inputs(rng, B, P, lay.page_size, KV, G, Dh, lens, False)
    att_err = max(att_err, check_attn(att32))
    del att32
    att_ms = time_graph_ms(_attn_call(att, "kernel"), repeats=100)
    att_plain_ms = time_ms(_attn_call(att, "plain"), repeats=5, warmup=1)
    att_bytes, att_ops = attn_bytes_ops(B, H, KV, Dh, lay.page_size, P, lens)
    att_bound, att_by = bound(att_bytes, att_ops)
    adm, ref = timed[False], timed[True]
    rows = [
        {"name": "dps_group_wire_encode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dps_quant.cu",
         "replaces": "src/repro/kernels/dps_quant.py:482",
         "shape": f"T={T} tiles x quantum={E} fp32, nearest, no mask, no "
                  "stats (the admission's call)",
         "max_abs_err": enc_err, "stats_max_rel_err": enc_rel, **adm,
         "masked": {k: ref[k] for k in ("ms", "ms_graph_clean", "bytes",
                                        "bound_ms", "kernels_a_call")},
         "masked_note": "the reference's call, with a float32 mask beside x",
         "timing": "ms: CUDA events around the wrapper, L2 zero-filled; "
                   "ms_graph_clean: CUDA-graph replay, L2 flushed by a read",
         "library_ms": None},
        {"name": "paged_decode_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
         "replaces": "src/repro/kernels/paged_attn.py:157",
         "shape": f"B={B} H={H} KV={KV} Dh={Dh} page={lay.page_size} P={P} "
                  f"int8, lens={lens}",
         "max_abs_err": att_err, "ms": att_ms, "plain_ms": att_plain_ms,
         "bound_ms": att_bound, "bound_by": att_by, "bytes": att_bytes,
         "library_ms": None,
         "split_tokens": paged_attn.split_plan(
             P, lay.page_size, B, KV, G, Dh)[0] * lay.page_size,
         "timing": "CUDA graph replay, L2 flushed"},
    ]
    if model is not None:
        for r in rows:
            r.update(name=f"{r['name']}_{model}", counter=r["name"],
                     run=f"serve_{model}", model=cfg.name, layers=L)
    return rows


def kernel_checks(cfg, lay):
    rng = np.random.default_rng(0)
    small = []
    # --- small shapes: every switch of both kernels ---
    for tiles, quantum, groups, dtype in ((9, 100, 4, torch.float32),
                                          (6, 7, 9, torch.float32),
                                          (11, 1, 2, torch.float32),
                                          (5, 4096, 3, torch.float32),
                                          (7, 1024, 3, torch.bfloat16),
                                          (4, 30, 2, torch.bfloat16),
                                          # the page quanta of nemotron-4
                                          # (16·8·192) and gemma (16·16·256)
                                          (3, 24576, 2, torch.float32),
                                          (3, 65536, 2, torch.float32)):
        inp = encode_inputs(rng, tiles, quantum, groups, dtype)
        for stochastic in (False, True):
            for masked in (False, True):
                for emit in (False, True):
                    check_encode(inp, stochastic=stochastic, masked=masked,
                                 emit_stats=emit)
        small.append(f"encode T={tiles} q={quantum} G={groups} {dtype}")
    # the persistent grid's plan (kernels/dps_quant.py's group_plan): one
    # tile; fewer tiles than SMs; tiles cut into pieces over many blocks;
    # one group's run across every block; a map that repeats groups further
    # on and ends in row 0 (a wire layout's tail); bf16 pieces; buffers off
    # 16 bytes (the element path)
    repeat = [0, 0, 1, 1, 2, 2, 2, 0, 0, 1, 3, 3, 0]
    for tiles, quantum, groups, dtype, tg, offset in (
            (1, 4096, 1, torch.float32, None, 0),
            (100, 4096, 7, torch.float32, None, 0),
            (2, 100_000, 2, torch.float32, None, 0),
            (600, 4096, 1, torch.float32, None, 0),
            (13, 20_000, 4, torch.float32, repeat, 0),
            (5, 50_000, 3, torch.bfloat16, None, 0),
            (13, 20_000, 4, torch.float32, repeat, 1),
            (6, 30_000, 2, torch.bfloat16, None, 1)):
        inp = encode_inputs(rng, tiles, quantum, groups, dtype, tg, offset)
        for stochastic in (False, True):
            for masked in (False, True):
                for emit in (False, True):
                    check_encode(inp, stochastic=stochastic, masked=masked,
                                 emit_stats=emit)
        plan = dps_quant.group_plan(tiles, quantum, groups, inp["x"].element_size(),
                                    0, True, offset == 0)
        small.append(f"encode plan T={tiles} q={quantum} G={groups} {dtype} "
                     f"{'repeating map' if tg else 'sorted map'} offset={offset}: "
                     f"{plan.items} items on {plan.blocks} blocks, vec={plan.vec}")
    attn_err_small = 0.0
    for B, P, ps, KV, G, Dh, lens, int8 in (
            (4, 4, 4, 2, 2, 16, [1, 7, 16, 0], True),
            (3, 3, 4, 2, 2, 16, [12, 0, 5], False),
            (2, 5, 8, 2, 3, 32, [40, 9], True),
            (2, 2, 4, 4, 1, 8, [8, 3], True),
            (2, 3, 5, 1, 2, 6, [0, 11], False),      # Dh not a multiple of 4
            (2, 2, 4, 1, 2, 8, [0, 0], True),
            # split edges (a split is 128 tokens of 16-token pages, 48 in an
            # fp32 pool): rows of exactly P·ps tokens, lengths at a split
            # boundary and one either side, more than 132 split blocks
            (4, 24, 16, 8, 3, 128, [384, 128, 127, 129], True),
            (4, 24, 16, 8, 3, 128, [384, 48, 47, 49], False),
            (3, 16, 16, 2, 3, 128, [256, 255, 129], True),
            (5, 40, 16, 8, 3, 128, [640, 639, 1, 0, 385], True),
            (2, 9, 5, 2, 5, 20, [45, 26], False),
            (3, 30, 4, 2, 4, 64, [120, 128, 64], True),
            # the head geometries of the other dense configs, at their
            # split edges: nemotron-4 (G=12, Dh=192: 12 chunks a row, K
            # staged unswizzled, value slices of 48 lanes), mistral-large
            # (G=12, Dh=128: three passes of four heads), gemma (G=1,
            # Dh=256: a 96-token split)
            _split_edge_case(2, 12, 192, True),
            _split_edge_case(2, 12, 192, False),
            _split_edge_case(2, 12, 128, True),
            _split_edge_case(2, 1, 256, True),
            _split_edge_case(2, 1, 256, False),
            # qwen3-moe-30b-a3b (G=8, Dh=128)
            _split_edge_case(2, 8, 128, True),
            _split_edge_case(2, 8, 128, False)):
        attn_err_small = max(attn_err_small, check_attn(
            attn_inputs(rng, B, P, ps, KV, G, Dh, lens, int8)))
        small.append(f"attn B={B} P={P} ps={ps} KV={KV} G={G} Dh={Dh} int8={int8} "
                     f"lens={lens}")

    # --- the serving path's shapes ---
    rows = serve_shape_rows(rng, cfg, lay)
    B, ps = lay.batch_slots, lay.page_size
    KV, Dh, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    # a long context: 8 rows of 4,096 tokens (67.1 MB of int8 K and V)
    lp, long_lens = 4096 // ps, [4096] * B
    lng = attn_inputs(rng, B, lp, ps, KV, H // KV, Dh, long_lens, True)
    lng_err = check_attn(lng)
    lng32 = attn_inputs(rng, B, lp, ps, KV, H // KV, Dh, long_lens, False)
    lng_err = max(lng_err, check_attn(lng32))
    del lng32
    gc.collect()
    torch.cuda.empty_cache()
    lng_ms = time_graph_ms(_attn_call(lng, "kernel"), repeats=100)
    lng_plain_ms = time_ms(_attn_call(lng, "plain"), repeats=3, warmup=1)
    lng_bytes, lng_ops = attn_bytes_ops(B, H, KV, Dh, ps, lp, long_lens)
    del lng
    gc.collect()
    torch.cuda.empty_cache()
    lng_bound, lng_by = bound(lng_bytes, lng_ops)
    rows.append(
        {"name": "paged_decode_attn_long_context", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
         "replaces": "src/repro/kernels/paged_attn.py:157",
         "shape": f"B={B} H={H} KV={KV} Dh={Dh} page={ps} P={lp} "
                  f"int8, lens={long_lens[0]} x {B} (the serving path's kernel "
                  "at a long context, which no path of this script runs)",
         "on_path": False,
         "max_abs_err": lng_err, "ms": lng_ms, "plain_ms": lng_plain_ms,
         "bound_ms": lng_bound, "bound_by": lng_by, "bytes": lng_bytes,
         "library_ms": None,
         "split_tokens": paged_attn.SPLIT_TOKENS,
         "timing": "CUDA graph replay, L2 flushed"})
    # the other configs' serving shapes (the same layout and lengths)
    for model, layers in OTHER_SERVE:
        rows += serve_shape_rows(rng, depth_cut(model, layers), lay, model)
    gc.collect()
    torch.cuda.empty_cache()
    say("checks", small_shapes=small, attn_max_abs_err_small=attn_err_small,
        attn_split_tokens=paged_attn.SPLIT_TOKENS,
        attn_two_launches_bit_equal=True, attn_empty_rows_exactly_0=True,
        tolerances={"encode_bytes": 0, "encode_float_sums_rel": SUM_RTOL,
                    "attn_abs": ATTN_TOL},
        main_path=[{k: r[k] for k in ("name", "shape", "max_abs_err", "ms",
                                      "plain_ms", "bound_ms", "bound_by")}
                   for r in rows])
    return rows


# ---------------------------------------------------------------------------
# the training quantizer, K1 and K1b
# ---------------------------------------------------------------------------

def _i32(v):
    return torch.tensor(v, dtype=torch.int32, device=DEV)


def _stats_match(sk, sp, n):
    """count/nonzero/overflow/max_abs exact (counts past 2^24 to one ulp of
    the float32 they are written in), float sums to SUM_RTOL; returns the
    largest relative difference of a float sum."""
    exact = [0, 1, 2, 6]
    if n < (1 << 24):
        ok = torch.equal(sk[exact], sp[exact])
    else:
        ulp = torch.nextafter(sp[:3], torch.full_like(sp[:3], math.inf)) - sp[:3]
        ok = (bool(((sk[:3] - sp[:3]).abs() <= ulp).all())
              and bool(sk[6] == sp[6]))
    if not ok:
        raise AssertionError(f"quantizer: count/nonzero/overflow/max_abs "
                             f"{sk[exact].tolist()} vs plain {sp[exact].tolist()}")
    rel = float(((sk[3:6] - sp[3:6]).abs() / sp[3:6].abs().clamp(min=1e-30)).max())
    if rel > SUM_RTOL:
        raise AssertionError(f"quantizer: float sums differ by {rel:.3g} "
                             f"relative (> {SUM_RTOL})")
    return rel


def _bits_name(bits):
    if bits is None:
        return "nearest"
    return "Philox" if isinstance(bits, dps_quant.Philox) else "bits operand"


def check_quant(x, il, fl, bits=None, *, stats=True):
    """One K1/K1b configuration, kernel vs plain on the card: q bit-equal,
    statistics per ``_stats_match``; with statistics, a second launch gives
    the same bits.  ``bits``: None (nearest), a tensor (K1) or a Philox
    stream (K1b).  Returns (the largest |q_kernel - q_plain|, the largest
    relative difference of a float sum)."""
    il, fl = _i32(il), _i32(fl)
    qk, sk = dps_quant.dps_quant(x, il, fl, bits, compute_stats=stats,
                                 backend="kernel")
    qp, sp = dps_quant.dps_quant(x, il, fl, bits, compute_stats=stats,
                                 backend="plain")
    torch.cuda.synchronize()
    iv = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    if not torch.equal(qk.view(iv), qp.view(iv)):
        raise AssertionError(
            f"quantizer: q differs from the plain version in "
            f"{int((qk.view(iv) != qp.view(iv)).sum())} of {x.numel()} values "
            f"({x.dtype}, {_bits_name(bits)})")
    err = float((qk.to(torch.float32) - qp.to(torch.float32)).abs().max()) \
        if x.numel() else 0.0
    if not stats:
        if sk is not None:
            raise AssertionError("compute_stats=False returned statistics")
        return err, 0.0
    rel = _stats_match(sk, sp, x.numel())
    qk2, sk2 = dps_quant.dps_quant(x, il, fl, bits, backend="kernel")
    if not (torch.equal(qk, qk2) and torch.equal(sk, sk2)):
        raise AssertionError("quantizer: two launches gave different bits")
    return err, rel


def check_prng_equals_bits(x, il, fl, seed):
    """K1b equals K1 fed ``philox_bits`` of the same seed, q and stats."""
    il, fl = _i32(il), _i32(fl)
    a, sa = dps_quant.dps_quant(x, il, fl, dps_quant.Philox(seed),
                                backend="kernel")
    b, sb = dps_quant.dps_quant(x, il, fl, dps_quant.philox_bits(seed, x.numel(), DEV),
                                backend="kernel")
    if not (torch.equal(a, b) and torch.equal(sa, sb)):
        raise AssertionError("K1b differs from K1 fed the same Philox words")


def check_unbiased(n=1 << 20, seeds=64, il=2, fl=6):
    """Stochastic rounding is unbiased: over ``seeds`` K1b launches the mean
    of q - clip(x), summed over all elements, lies within 4 sigma of 0 (sigma
    from the per-element Bernoulli variance).  Returns the bias in units of
    sigma."""
    g = torch.Generator(device=DEV).manual_seed(5)
    x = torch.randn(n, generator=g, device=DEV) * 0.5
    ilt, flt = _i32(il), _i32(fl)
    acc = torch.zeros(n, dtype=torch.float64, device=DEV)
    for s in range(seeds):
        q, _ = dps_quant.dps_quant(x, ilt, flt, dps_quant.Philox(1000 + s),
                                   compute_stats=False, backend="kernel")
        acc += q.to(torch.float64)
    span = 2.0 ** (il - 1 + fl)
    y = (x.to(torch.float64) * 2.0 ** fl).clamp(-span, span - 1)
    p = y - torch.floor(y)
    dev_ = acc / seeds - y * 2.0 ** -fl
    sigma = float(torch.sqrt((p * (1 - p)).sum() / seeds)) * 2.0 ** -fl
    z = float(dev_.sum()) / sigma
    if abs(z) > 4.0:
        raise AssertionError(f"K1b: mean of q over {seeds} seeds is {z:.2f} "
                             "sigma from clip(x)")
    return z


# K1/K2's TMA body at its edges: (whole shape, block origin, block shape)
# of K1b's block mode — rows of at least a span cut into spans, the last of
# a row shorter; rows shorter than a span taken whole, a slab's last item
# fewer rows, a row of fewer groups than a consumer warp group (the counter
# wraps inside a thread's stride); bf16 rows
TMA_BLOCKS = (((64, 16384), (0, 4096), (64, 8192)),
              ((48, 12000), (0, 6000), (48, 6000)),
              ((256, 1024), (64, 256), (128, 512)),
              ((4, 500, 80), (1, 50, 40), (2, 250, 40)),
              ((64, 8192), (0, 2048), (64, 2048)))


def tma_edge_checks(rng):
    """K1/K1b/K2/K2b on the TMA body's edge shapes: K1b on a contiguous
    tensor just past ``Q_TMA_MIN`` whose last item is short, fp32 and
    bf16, Philox offsets 0 and 4 (and K1, K2, K2b on it, which
    ``quant_plan`` sends to the grid-stride body); K1b and K2b in block
    mode at ``TMA_BLOCKS``; a grid wider than 2^22 — each launch on the
    body ``quant_plan`` gives it (asserted), q and the wire bit-equal to
    the plain versions, statistics per ``_stats_match``, two launches
    equal, each block's q equal to the unsharded launch's on its
    elements.  Returns the largest relative difference of a float sum."""
    worst = 0.0

    def body(x, want, **kw):
        plan = dps_quant.quant_plan(x.numel(), x_bytes=x.element_size(), **kw)
        if plan.body != want:
            raise AssertionError(f"quant_plan: {tuple(x.shape)} {x.dtype} "
                                 f"{kw} is on the {plan.body} body")

    n = dps_quant.Q_TMA_MIN + 8
    for dtype in (torch.float32, torch.bfloat16):
        v = rng.standard_normal(n).astype(np.float32) * 4.0
        v[::7] = 0.0
        x = torch.from_numpy(v).to(DEV).to(dtype)
        bits = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)
                                .view(np.int32)).to(DEV)
        body(x, "tma")
        body(x, "stride", operand=True)
        body(x, "stride", wire=True)
        for stats in (True, False):
            for src in (None, bits, dps_quant.Philox(7),
                        dps_quant.Philox(7, offset=4)):
                worst = max(worst, check_quant(x, 3, 9, src, stats=stats)[1])
                worst = max(worst, check_wire_quant(x, 3, 5, src,
                                                    stats=stats)[1])
        check_prng_equals_bits(x, 3, 9, seed=5)
        # a grid wider than 2^22 (no floor by two adds; the error terms
        # scaled one by one)
        worst = max(worst, check_quant(x, 8, 20, dps_quant.Philox(8))[1])
        del x, bits
    for whole, origin, shape in TMA_BLOCKS:
        dtype = torch.bfloat16 if shape == (64, 2048) else torch.float32
        g = torch.Generator(device=DEV).manual_seed(3)
        w = (torch.randn(whole, generator=g, device=DEV) * 4.0).to(dtype)
        sl = tuple(slice(o, o + b) for o, b in zip(origin, shape))
        blk = w[sl].contiguous()
        geo = dps_quant.block_geometry(whole, origin, shape)
        body(blk, "tma", geo=geo)
        src = dps_quant.Philox(21, block=geo)
        for stats in (True, False):
            worst = max(worst, check_quant(blk, 3, 9, src, stats=stats)[1])
            worst = max(worst, check_wire_quant(blk, 3, 5, src,
                                                stats=stats)[1])
        worst = max(worst, check_quant(blk, 8, 20, src)[1])
        qw, _ = dps_quant.dps_quant(w, _i32(3), _i32(9), dps_quant.Philox(21),
                                    backend="kernel")
        qb, _ = dps_quant.dps_quant(blk, _i32(3), _i32(9), src,
                                    backend="kernel")
        if not torch.equal(qb, qw[sl]):
            raise AssertionError(f"K1b block mode at {shape} of {whole} "
                                 "differs from the unsharded launch")
    return worst


def quant_row(name, shape, x, il, fl, bits, err, rel, nbytes, nops):
    """One ``kernels`` row: K1/K1b at ``x``'s shape, timed with and without
    statistics beside the plain version — ``ms`` between CUDA events around
    the wrapper with the L2 overwritten by a zero fill before each launch,
    ``ms_graph`` replayed from a CUDA graph, ``ms_graph_clean`` replayed
    with the L2 flushed by a read (clean lines) — with the body
    ``quant_plan`` gives it and the device kernels a call (``torch.profiler``
    over 10 calls outside a graph; held to 1)."""
    args = (x, _i32(il), _i32(fl), bits)
    call = lambda: dps_quant.dps_quant(*args, backend="kernel")
    ms = time_ms(call, repeats=10)
    ms_nostats = time_ms(lambda: dps_quant.dps_quant(
        *args, compute_stats=False, backend="kernel"), repeats=10)
    ms_graph = time_graph_ms(call, repeats=10)
    ms_clean = time_graph_ms(call, repeats=10, clean=True)
    per_call, _ = device_kernels(call)
    if per_call != 1:
        raise AssertionError(f"{name}: {per_call} device kernels a call")
    plain_ms = time_ms(lambda: dps_quant.dps_quant(*args, backend="plain"),
                       repeats=3, warmup=1)
    bound_ms, by = bound(nbytes, nops)
    geo = bits.block if isinstance(bits, dps_quant.Philox) else None
    plan = dps_quant.quant_plan(
        x.numel(), x_bytes=x.element_size(),
        operand=isinstance(bits, torch.Tensor), geo=geo)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dps_quant.cu",
            "replaces": "src/repro/kernels/dps_quant.py:288",
            "shape": shape, "max_abs_err": err, "stats_max_rel_err": rel,
            "ms": ms, "plain_ms": plain_ms, "ms_no_stats": ms_nostats,
            "ms_graph": ms_graph, "ms_graph_clean": ms_clean,
            "kernels_a_call": per_call, "body": plan.body,
            "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
            "library_ms": None}


def quant_checks(cfg):
    """K1/K1b at small shapes and at the training paths'; returns their two
    ``kernels`` rows (launches filled in by the training phases)."""
    rng = np.random.default_rng(1)

    def draw(n, dtype, scale=4.0, offset=0):
        # ``offset`` > 0 gives a contiguous view whose data pointer is not
        # 16-byte aligned: the kernel's scalar path
        v = rng.standard_normal(n + offset).astype(np.float32) * scale
        v[::7] = 0.0
        return torch.from_numpy(v).to(DEV).to(dtype)[offset:]

    def npbits(n):
        return torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)
                                .view(np.int32)).to(DEV)

    small = []
    worst = 0.0
    for n in (1, 3, 1023, 100_003, 4096):
        for dtype in (torch.float32, torch.bfloat16):
            for offset in (0, 1):
                x = draw(n, dtype, offset=offset)
                bits = npbits(n)
                for stats in (False, True):
                    for src in (None, bits, dps_quant.Philox(12345 + n)):
                        worst = max(worst, check_quant(x, 3, 9, src,
                                                       stats=stats)[1])
                check_prng_equals_bits(x, 3, 9, seed=777 + n)
            small.append(f"n={n} {dtype}")
    worst = max(worst, tma_edge_checks(rng))
    small.append("TMA body edges: " + ", ".join(
        f"{b} of {w}" for w, _, b in TMA_BLOCKS))
    z = check_unbiased()

    # --- the training paths' shapes ---
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    w_in, w_in_layer, tap = L * D * F, D * F, 2 * 512 * D
    rels, errs = {}, {}
    # LeNet's (K1, stochastic, a bits operand): its largest weight leaf,
    # fc1_w 800x500 fp32, and its first activation tap, 64x20x12x12 fp32
    for name, n in (("lenet_fc1_w", 800 * 500), ("lenet_tap_c1", 64 * 20 * 144)):
        x = draw(n, torch.float32, scale=0.05)
        errs[name], rels[name] = check_quant(x, 8, 12, npbits(n))
        check_quant(x, 8, 16, npbits(n), stats=False)
        if name == "lenet_fc1_w":
            # Fig. 4's arms quantize it with K1b: the small-leaf row
            errs["lenet_fc1_k1b"], rels["lenet_fc1_k1b"] = check_quant(
                x, 8, 12, dps_quant.Philox(6))
            fc1 = quant_row(
                "dps_quantize_onchip_prng_lenet_fc1",
                f"LeNet fc1_w 800x500 = {n} fp32, Philox bits in the "
                "kernel, statistics on (every K1b event of paper_fig4's "
                "quantized arms is a LeNet leaf or tap of this size or "
                "smaller)", x, 8, 12, dps_quant.Philox(6),
                errs["lenet_fc1_k1b"], rels["lenet_fc1_k1b"],
                8 * n + 8 + 28, 49 * n)
            fc1.update(counter="dps_quantize_onchip_prng", run="paper_fig4")
    # the LM's tap: bf16 residual stream, <IL, FL> as the acts domain starts
    x = draw(tap, torch.bfloat16, scale=1.0)
    errs["tap_nearest"], rels["tap_nearest"] = check_quant(x, 8, 12)
    errs["tap_k1b"], rels["tap_k1b"] = check_quant(x, 8, 12, dps_quant.Philox(3))
    check_quant(x, 8, 16, dps_quant.Philox(4), stats=False)    # the backward tap
    check_prng_equals_bits(x, 8, 12, seed=3)
    tap_args = (x, _i32(8), _i32(12), dps_quant.Philox(3))
    tap_ms = time_ms(lambda: dps_quant.dps_quant(*tap_args, backend="kernel"),
                     repeats=50)
    tap_plain_ms = time_ms(lambda: dps_quant.dps_quant(*tap_args, backend="plain"),
                           repeats=5, warmup=1)
    del x

    # The largest weight leaf, fp32, drawn like init_params' normal init.
    # K1b quantizes it in one launch; with a bits operand quantize_tree
    # draws and quantizes it one layer at a time, so K1's launch is one
    # layer's slice, D x F.
    g = torch.Generator(device=DEV).manual_seed(7)
    x = torch.randn(w_in, generator=g, device=DEV) * D ** -0.5
    x[::11] = 0.0
    il, fl = 2, 14
    errs["w_in_k1b"], rels["w_in_k1b"] = check_quant(x, il, fl, dps_quant.Philox(5))
    check_quant(x, il, fl, stats=False)
    check_prng_equals_bits(x, il, fl, seed=5)
    bits = torch.randint(-2**31, 2**31, (w_in,), dtype=torch.int32,
                         device=DEV, generator=g)
    errs["w_in_k1"], rels["w_in_k1"] = check_quant(x, il, fl, bits)
    del bits
    # bytes: x in, q out (fp32), <IL, FL> in, 7 stats out; K1 also reads the
    # bits.  Operations: ~24 fp32 operations an element (scale, two clips,
    # round, rescale; the statistics' subtract, abs, compare, divide, three
    # sums and the max); K1b adds Philox4x32-10, 10 rounds of ~10 integer
    # operations for every 4 elements, counted here at the fp32 rate.
    k1b = quant_row("dps_quantize_onchip_prng",
                    f"w_in leaf {L}x{D}x{F} = {w_in} fp32, Philox bits in the "
                    "kernel, statistics on (one launch per leaf on the LM path)",
                    x, il, fl, dps_quant.Philox(5), errs["w_in_k1b"],
                    rels["w_in_k1b"], 8 * w_in + 8 + 28, 49 * w_in)
    k1b.update(tap_shape=f"2x512x{D} bf16", tap_ms=tap_ms,
               tap_plain_ms=tap_plain_ms)
    xl = x.view(L, D, F)[L // 2]                      # one layer, contiguous
    bits = torch.randint(-2**31, 2**31, (w_in_layer,), dtype=torch.int32,
                         device=DEV, generator=g)
    errs["w_in_layer_k1"], rels["w_in_layer_k1"] = check_quant(xl, il, fl, bits)
    k1 = quant_row("dps_quantize",
                   f"one layer of the w_in leaf, {D}x{F} = {w_in_layer} fp32, "
                   "a bits operand, statistics on (the LM path's K1 launch "
                   "under --rounding-bits operand)",
                   xl, il, fl, bits, errs["w_in_layer_k1"],
                   rels["w_in_layer_k1"], 12 * w_in_layer + 8 + 28,
                   24 * w_in_layer)
    del x, xl, bits
    gc.collect()
    torch.cuda.empty_cache()

    rows = [k1, k1b, fc1]
    say("quantize", small_shapes=small, small_worst_sum_rel=worst,
        unbiased_sigma=z, main_path_q_max_abs_err=errs,
        main_path_sum_rel=rels,
        tolerances={"q": "bit-equal", "float_sums_rel": SUM_RTOL,
                    "counts": "exact below 2^24, 1 ulp above"},
        main_path=[{k: r[k] for k in ("name", "shape", "body", "ms",
                                      "ms_graph", "ms_graph_clean",
                                      "kernels_a_call", "ms_no_stats",
                                      "plain_ms", "bound_ms", "bound_by")}
                   for r in rows],

        tap={"ms": tap_ms, "plain_ms": tap_plain_ms})
    return rows


def train_shape_rows():
    """K1b on one leaf of each config of ``OTHER_TRAIN`` and
    ``FAMILY_TRAIN`` at the depth it trains at (one launch per leaf on its
    path), drawn like
    ``init_params``' normal init: q bit-equal to the plain version and to K1
    fed the same Philox words, timed like the w_in row.  Their launches are
    the training run's (``train_<model>``)."""
    rows = []
    for model, layers, _, leaf, *_ in OTHER_TRAIN + FAMILY_TRAIN:
        cfg = depth_cut(model, layers)
        layers = cfg.n_layers
        node = registry(cfg.family).model_defs(cfg)
        for k in leaf:
            node = node[k]
        shape = node.shape
        n = math.prod(shape)
        g = torch.Generator(device=DEV).manual_seed(8)
        x = torch.randn(n, generator=g, device=DEV) * shape[-2] ** -0.5
        x[::11] = 0.0
        il, fl = 2, 14
        err, rel = check_quant(x, il, fl, dps_quant.Philox(5))
        check_prng_equals_bits(x, il, fl, seed=5)
        row = quant_row(
            f"dps_quantize_onchip_prng_{model}",
            f"{cfg.name} {'/'.join(leaf)} leaf {'x'.join(map(str, shape))} = "
            f"{n} fp32 ({layers} of {get_config(model).n_layers} layers), "
            "Philox bits in the kernel, statistics on",
            x, il, fl, dps_quant.Philox(5), err, rel, 8 * n + 8 + 28, 49 * n)
        row.update(counter="dps_quantize_onchip_prng", run=f"train_{model}",
                   model=cfg.name, layers=layers)
        rows.append(row)
        del x
        gc.collect()
        torch.cuda.empty_cache()
    say("quantize_other_configs",
        main_path=[{k: r[k] for k in ("name", "shape", "max_abs_err",
                                      "stats_max_rel_err", "ms", "ms_no_stats",
                                      "plain_ms", "bound_ms", "bound_by")}
                   for r in rows])
    return rows


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def compare_with_plain(cfg, params, lay, req):
    """Kernel engine vs plain engine on the card, one request: prompt pages
    byte-equal, controller rows equal, first decode step's logits close.
    ``params`` is the serving engine's (its fp32 unembedding table already
    held, so neither engine casts another)."""
    out = {}
    for name in ("kernel", "plain"):
        eng = Engine(cfg, params, EngineConfig(
            layout=lay, kv_bits=8, attn_backend=name, encode_backend=name),
            device=DEV)
        pools = kvc.init_pool(cfg, lay, 8, DEV)
        state = eng.plan.init(DEV)[kvc.KV_DOMAIN]
        plen = int(req.prompt.size)
        need = lay.pages_needed(plen, req.max_new)
        pages = list(range(need))
        toks = np.zeros(lay.max_prompt, np.int32)
        toks[:plen] = req.prompt
        logits, ck, cv = eng.prefill(torch.from_numpy(toks).to(DEV)[None], plen)
        phys = np.full(lay.prompt_pages, lay.trash_page, np.int32)
        npp = min(need, lay.prompt_pages)
        phys[:npp] = pages[:npp]
        pools, state = eng.encode(pools, state, ck, cv,
                                  torch.from_numpy(phys).to(DEV), plen)
        live = -(-plen // lay.page_size)
        prompt_k = pools.k_pages[:, :live].clone()
        prompt_v = pools.v_pages[:, :live].clone()
        ptab = np.full((lay.batch_slots, lay.max_pages_per_seq),
                       lay.trash_page, np.int32)
        ptab[0, :need] = pages
        pos = np.zeros(lay.batch_slots, np.int32)
        pos[0] = plen
        last = np.zeros((lay.batch_slots, 1), np.int32)
        last[0, 0] = int(logits.argmax())
        step_logits, _ = eng.decode(torch.from_numpy(last).to(DEV), pools, state,
                                    torch.from_numpy(ptab).to(DEV),
                                    torch.from_numpy(pos).to(DEV))
        out[name] = (prompt_k, prompt_v, state, step_logits[0, :cfg.vocab].clone())
    (kk, kv_, ks, kl), (pk, pv, ps_, pl) = out["kernel"], out["plain"]
    if not (torch.equal(kk, pk) and torch.equal(kv_, pv)):
        raise AssertionError("prompt pages differ between the kernel and the "
                             "plain page encoder")
    if not (torch.equal(ks.il, ps_.il) and torch.equal(ks.fl, ps_.fl)):
        raise AssertionError("page formats differ between the two engines")
    if not bool(kk.ne(0).any()):
        raise AssertionError("prompt pages are all zero")
    err = float((kl - pl).abs().max())
    if not bool(torch.isfinite(kl).all()) or err > LOGIT_TOL:
        raise AssertionError(f"first decode step: logits differ by {err:.3g} "
                             f"(> {LOGIT_TOL}) between kernel and plain")
    return err, float(pl.abs().max()), int(kl.argmax()) == int(pl.argmax())


def _decode_hidden(cfg):
    """A decode step's final hidden states, (slots, 1, d) bf16."""
    g = torch.Generator(device=DEV).manual_seed(3)
    return torch.randn(SERVE["slots"], 1, cfg.d_model, device=DEV,
                       generator=g).to(torch.bfloat16)


def per_call_cast(cfg, embed):
    """The decode step's unembedding with the fp32 table cast per call
    (``embed``: the bf16 parameters alone): its logits, ms by CUDA events,
    and the bytes the cast adds to the peak.  Run before the engine holds
    its cast, so that the two fp32 tables are never on the card at once."""
    x = _decode_hidden(cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits = unembed(x, embed, cfg.vocab)
    torch.cuda.synchronize()
    adds = torch.cuda.max_memory_allocated() - base - logits.numel() * 4
    ms = time_ms(lambda: unembed(x, embed, cfg.vocab), repeats=5, warmup=1)
    return logits, {"per_call_cast_ms": ms, "per_call_cast_adds_bytes": adds}


def held_cast(cfg, held, logits):
    """The same against the table the engine holds: bit-equal logits, ms."""
    x = _decode_hidden(cfg)
    if not torch.equal(unembed(x, held, cfg.vocab), logits):
        raise AssertionError("unembed against the held fp32 table differs "
                             "from unembed with the per-call cast")
    return {"held_ms": time_ms(lambda: unembed(x, held, cfg.vocab),
                               repeats=20), "bit_equal": True}


def serve(cfg, lay, model=None):
    """``cfg`` at full width behind the continuous-batching engine, every
    assertion of the serving phase; returns the counted run's launches.
    ``model``: the config's module name for a config other than the first
    (its line says so, and how far its depth was cut)."""
    mod = registry(cfg.family)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SERVE["seed"])
    params = init_params(mod.model_defs(cfg), DEV, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    # the fp32 draws' cached blocks go back, so that a table's fp32 cast
    # (18.9 GB on nemotron-4) finds room in one piece
    torch.cuda.empty_cache()
    logits, cast = per_call_cast(cfg, params["embed"])
    eng = Engine(cfg, params, EngineConfig(layout=lay, kv_bits=8), device=DEV)
    if (eng._attn_backend, eng._enc_backend) != ("kernel", "kernel"):
        raise AssertionError("backends 'auto' did not resolve to the kernels")
    held = {k: v for k, v in eng.params["embed"].items()
            if k not in params["embed"]}
    cast.update(held_cast(cfg, eng.params["embed"], logits))
    del params, logits
    reqs = synthetic_trace(SERVE["requests"], cfg.vocab,
                           prompt_lens=SERVE["prompt_lens"],
                           new_tokens=SERVE["new_tokens"],
                           mean_gap=SERVE["mean_gap"], seed=SERVE["seed"] + 1)

    eng.run(reqs[:2])                       # warm-up: cuBLAS handles, caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the counted run: counts to 0 just before, read just after
    dps_quant.launch_count = 0
    paged_attn.launch_count = 0
    rep = eng.run(reqs)
    launches = {"dps_group_wire_encode": dps_quant.launch_count,
                "paged_decode_attn": paged_attn.launch_count}
    peak = torch.cuda.max_memory_allocated()

    m = rep.metrics
    steps = int(m["decode_steps"])
    for r in reqs:
        got = rep.tokens[r.rid]
        if len(got) != r.max_new:
            raise AssertionError(f"request {r.rid}: {len(got)} tokens, wanted "
                                 f"{r.max_new}")
        if not all(0 <= t < cfg.vocab for t in got):
            raise AssertionError(f"request {r.rid}: token outside the vocabulary")
    if launches["paged_decode_attn"] != cfg.n_layers * steps or steps == 0:
        raise AssertionError(f"paged attention launched "
                             f"{launches['paged_decode_attn']} times, wanted "
                             f"{cfg.n_layers} x {steps} decode steps")
    if launches["dps_group_wire_encode"] != len(reqs):
        raise AssertionError(f"page encoder launched "
                             f"{launches['dps_group_wire_encode']} times, "
                             f"wanted one per admission ({len(reqs)})")
    if sum(rep.format_spread.values()) == 0:
        raise AssertionError("no prompt page was placed on a grid")

    rep2 = eng.run(reqs)
    if rep2.tokens != rep.tokens:
        raise AssertionError("a second run of the same trace gave other tokens")

    logit_err, logit_max, same_argmax = compare_with_plain(
        cfg, eng.params, lay, reqs[0])

    full = get_config(model or "llama3_2_3b")
    moe = ({"n_experts": cfg.n_experts, "top_k": cfg.top_k,
            "active_params": cfg.n_active_params()} if cfg.n_experts else {})
    say("serve", model=cfg.name, layers=cfg.n_layers,
        layers_of=full.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
        **moe,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        tied_embedding=cfg.tie_embed,
        params=cfg.n_params(), weights_init_s=init_s,
        init_peak_memory_bytes=init_peak,
        fp32_unembed_held_bytes=sum(v.numel() * v.element_size()
                                    for v in held.values()),
        unembed=cast,
        requests=len(reqs), total_tokens=int(m["total_tokens"]),
        wall_s=m["wall_s"], tokens_per_s=m["tokens_per_s"], decode_steps=steps,
        mean_occupancy=m["mean_occupancy"],
        p50_ms_per_decode_step=m["p50_ms_per_step"],
        p95_ms_per_decode_step=m["p95_ms_per_step"],
        prefill_and_encode_s_total=m["prefill_s_total"],
        peak_memory_bytes=peak, launches=launches,
        format_spread=rep.format_spread, second_run_same_tokens=True,
        plain_engine={"prompt_pages_equal": True,
                      "first_step_logits_max_abs_err": logit_err,
                      "first_step_logits_max_abs": logit_max,
                      "tolerance": LOGIT_TOL, "same_argmax": same_argmax})
    return launches


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def _reset_quant_counts():
    dps_quant.quantize_launch_count = 0
    dps_quant.quantize_prng_launch_count = 0


def _quant_counts():
    return {"dps_quantize": dps_quant.quantize_launch_count,
            "dps_quantize_onchip_prng": dps_quant.quantize_prng_launch_count}


def lenet():
    """The paper's app on the card: K1 on every event, then kernel vs plain
    under nearest and under stochastic rounding."""
    from repro_torch.apps import mnist as app
    from repro_torch.data import MNISTLike
    data = MNISTLike(batch=64, seed=0, n_train=2048, n_test=512)
    qcfg = dataclasses.replace(app.paper_quant_config(), onchip_prng=False)
    steps = 20
    t0 = time.perf_counter()
    _reset_quant_counts()                      # the counted run
    hist = app.train_mnist(qcfg, steps=steps, data=data, device=DEV)
    torch.cuda.synchronize()
    launches = _quant_counts()
    wall = time.perf_counter() - t0
    # per step: 8 leaves x (weights, grads, re-snap) + 4 taps forward and
    # backward + the logit gradient's statistics
    per_step = 8 * 3 + 4 * 2 + 1
    if launches != {"dps_quantize": per_step * steps, "dps_quantize_onchip_prng": 0}:
        raise AssertionError(f"LeNet: quantizer launches {launches}, wanted "
                             f"{per_step} x {steps} on K1")
    if not all(math.isfinite(v) for v in hist["loss"]):
        raise AssertionError("LeNet: a loss is not finite")

    # kernel vs plain: the stochastic runs draw the same operand bits (the
    # same seeded generator on the card), so q is bit-equal there too
    fmt_keys = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")
    compared = {}
    for rounding in ("nearest", "stochastic"):
        runs = {}
        for backend in ("kernel", "plain"):
            q = dataclasses.replace(app.paper_quant_config(rounding=rounding),
                                    onchip_prng=False, backend=backend)
            runs[backend] = app.train_mnist(q, steps=3, data=data, device=DEV)
        for k in fmt_keys:
            if runs["kernel"][k] != runs["plain"][k]:
                raise AssertionError(f"LeNet kernel vs plain ({rounding}): {k} "
                                     f"{runs['kernel'][k]} vs {runs['plain'][k]}")
        loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in
                       zip(runs["kernel"]["loss"], runs["plain"]["loss"]))
        if loss_rel > LENET_LOSS_RTOL:
            raise AssertionError(f"LeNet kernel vs plain ({rounding}): loss "
                                 f"differs by {loss_rel:.3g} relative "
                                 f"(> {LENET_LOSS_RTOL})")
        compared[rounding] = {"steps": 3, "formats_equal": True,
                              "loss_max_rel": loss_rel,
                              "loss": runs["kernel"]["loss"]}
    say("lenet", steps=steps, wall_s=wall, loss_first=hist["loss"][0],
        loss_last=hist["loss"][-1], launches=launches,
        formats_last={k: hist[k][-1] for k in fmt_keys},
        kernel_vs_plain=compared, tolerance=LENET_LOSS_RTOL,
        master_weights=lenet_master_weights(data))
    return launches


def lenet_master_weights(data, steps=3):
    """LeNet under ``QuantConfig.master_weights`` on K1b: no re-snap after
    the update, so a step launches K1b on every event but the 8 re-snaps,
    the losses stay finite and the parameters leave the weight grid."""
    from repro_torch.apps import mnist as app
    from repro_torch.core import qtrain
    from repro_torch.models import lenet as lenet_lib
    from repro_torch.optim import SGDConfig, make_optimizer
    q = dataclasses.replace(app.paper_quant_config(), master_weights=True)
    opt = make_optimizer(SGDConfig())
    params = lenet_lib.init(0, DEV)
    step = qtrain.make_train_step(lenet_lib.loss_fn, opt, q)
    state = qtrain.TrainState.create(params, opt.init(params), q, 1, DEV)
    _reset_quant_counts()
    losses = []
    with app._full_fp32(DEV):
        for i in range(steps):
            batch = {k: torch.from_numpy(v).to(DEV)
                     for k, v in data.train_batch(i).items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    launches = _quant_counts()
    per_step = 8 * 2 + 4 * 2 + 1
    if launches != {"dps_quantize": 0,
                    "dps_quantize_onchip_prng": per_step * steps}:
        raise AssertionError(f"LeNet master_weights: quantizer launches "
                             f"{launches}, wanted {per_step} x {steps} on K1b")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("LeNet master_weights: a loss is not finite")
    scale = 2.0 ** float(m["fl_w"])
    off = sum(int(((p * scale) != torch.round(p * scale)).sum())
              for p in state.params.values())
    if not off:
        raise AssertionError("LeNet master_weights: every parameter is on "
                             "the weight grid")
    return dict(steps=steps, loss=losses, launches=launches,
                fl_w=float(m["fl_w"]), off_grid=off,
                params=sum(p.numel() for p in state.params.values()))


def paper_fig4():
    """The paper's Fig. 4 on the card, as ``benchmarks/bench_convergence.py``
    runs it, through ``repro_torch.launch.paper_eval``: LeNet on
    ``MNISTLike(batch=64, seed=0)`` (default sizes) for ``FIG4_STEPS`` steps
    in each of three arms — fp32, DPS (``paper_quant_config()``) and fixed
    13-bit (``paper_quant_config(static_bits=13)``) — every quantization
    event on K1b (the default on-chip Philox bits), from each of
    ``FIG4_SEEDS``' initializations (``paper_eval`` draws them on the CPU,
    so that a CPU run of the seed starts from the same parameters).
    Asserted: each quantized arm's launches, all on K1b, 33 a step as in
    ``lenet`` (the static controller quantizes the same events); the fp32
    arm's first
    ``FIG4_HELD_STEPS`` losses within ``FIG4_LOSS_RTOL`` of a CPU run's
    from the same parameters.  Measured and printed, not asserted: each
    arm's accuracy, widths, divergence and first non-finite loss (the
    paper's recipe diverges from some initializations, fp32 included), and
    the bench's three claims for each seed.  Returns the K1b launches."""
    from repro_torch.data import MNISTLike
    from repro_torch.launch import paper_eval
    data = MNISTLike(batch=64, seed=0)
    per_step = 8 * 3 + 4 * 2 + 1
    seeds, k1b = {}, 0
    for seed in FIG4_SEEDS:
        arms = {}
        for arm in paper_eval.ARMS:
            _reset_quant_counts()              # each arm counted from 0
            arms[arm] = r = paper_eval.run_arm(arm, FIG4_STEPS, seed, DEV,
                                               data)
            r["launches"] = _quant_counts()
            want = {"dps_quantize": 0, "dps_quantize_onchip_prng":
                    0 if arm == "fp32" else per_step * FIG4_STEPS}
            if r["launches"] != want:
                raise AssertionError(f"Fig. 4 {arm}, seed {seed}: quantizer "
                                     f"launches {r['launches']}, wanted {want}")
            k1b += r["launches"]["dps_quantize_onchip_prng"]
        cpu = paper_eval.run_arm("fp32", FIG4_HELD_STEPS, seed, "cpu", data)
        got = arms["fp32"]["first_losses"][:FIG4_HELD_STEPS]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, cpu["first_losses"]))
        if not rel <= FIG4_LOSS_RTOL:
            raise AssertionError(f"Fig. 4 fp32, seed {seed}: first losses "
                                 f"{got} on the card, {cpu['first_losses']} "
                                 f"on the CPU")
        seeds[seed] = dict(arms=arms, claims=paper_eval.claims(arms),
                           fp32_first_losses_vs_cpu_max_rel=rel)
    say("paper_fig4", steps=FIG4_STEPS, batch=64, init="cpu generator",
        seeds=seeds, launches_per_step=per_step,
        held_steps=FIG4_HELD_STEPS, tolerance=FIG4_LOSS_RTOL,
        converged={arm: [s for s, r in seeds.items()
                         if not r["arms"][arm]["diverged"]]
                   for arm in paper_eval.ARMS})
    return k1b


# the stacked per-layer trees of each family's parameters
STACKED = ("layers", "mamba", "enc_layers", "dec_layers")


def quantizer_launches_per_step(cfg, rounding_bits):
    """Quantizer launches a replicated training step makes, from
    ``model_defs``: every leaf the policy quantizes x (weights, grads,
    re-snap), plus one tap a block (the family's ``residual_taps``)
    forward and one backward for each of the config's ``train_accum``
    microbatches.  The recompute under ``torch.utils.checkpoint`` stops
    once the block's saved tensors are back, before the tap (which saves
    none): under ``remat="full"`` and under ``remat="dots"`` alike, the
    selective policy only turning some of the recomputed ops into saved
    ones (the MoE router, an fp32 island, is not quantized).  With a bits
    operand each stacked leaf is quantized one layer at a time."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.policy import QuantPolicy
    pred = QuantPolicy().param_predicate()
    defs = registry(cfg.family).model_defs(cfg)
    leaves = [(path, d) for path, d in tree_lib.leaves_with_path(defs)
              if pred(path, None)]
    taps = 2 * registry(cfg.family).residual_taps(cfg) * cfg.train_accum
    if rounding_bits == "onchip":
        return 3 * len(leaves) + taps, len(leaves)
    return (3 * sum(d.shape[0] if p[0] in STACKED else 1 for p, d in leaves)
            + taps, len(leaves))


def train_lm(cfg, rounding_bits, steps, batch=2, model="llama3_2_3b",
             seq=512, phase="train"):
    """The LM trainer's CLI at full width (``cfg``: ``model``'s config,
    perhaps cut in depth or with another ``remat``, handed to
    ``launch.train.main``), every quantization event on K1b (``onchip``) or
    on K1 (``operand``).  Returns the launches, ms a step and peak."""
    from repro_torch.launch import train as train_cli
    argv = ["--arch", model, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--optimizer", "sgd", "--log-every", "1",
            "--rounding-bits", rounding_bits]
    per_step, n_leaves = quantizer_launches_per_step(cfg, rounding_bits)
    want = ("dps_quantize_onchip_prng" if rounding_bits == "onchip"
            else "dps_quantize")
    _reset_quant_counts()                      # the counted run
    out = train_cli.main(argv, cfg=cfg)
    launches = _quant_counts()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if len(hist) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"LM training: losses {losses}")
    wanted = {"dps_quantize": 0, "dps_quantize_onchip_prng": 0}
    wanted[want] = per_step * steps
    if out["quantizer_launches_per_step"] != [per_step] * steps or \
            launches != wanted:
        raise AssertionError(f"LM training: quantizer launches {launches}, "
                             f"{out['quantizer_launches_per_step']} a step; "
                             f"wanted {per_step} a step on {want}")
    traj = [{k: h[k] for k in ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")}
            for h in hist]
    moe = {}
    if cfg.n_experts:
        aux = [h["aux_loss"] for h in hist]
        if not all(math.isfinite(v) and v > 0 for v in aux):
            raise AssertionError(f"MoE training: load-balance losses {aux}")
        moe = dict(aux_losses=aux, router_aux_coef=cfg.router_aux_coef,
                   active_params=cfg.n_active_params())
    if cfg.family == "vlm":
        moe = dict(vision_prefix=cfg.n_patches, positions=cfg.n_patches + seq)
    if cfg.family == "hybrid":
        moe = dict(shared_invocations=cfg.n_layers // cfg.hybrid_period,
                   remainder=cfg.n_layers % cfg.hybrid_period)
    if cfg.family == "encdec":
        moe = dict(enc_layers=cfg.n_enc_layers, frames=cfg.enc_seq)
    full = get_config(model)
    say(phase, command="python -m repro_torch.launch.train " + " ".join(argv),
        model=cfg.name, layers=cfg.n_layers, layers_of=full.n_layers,
        d_model=cfg.d_model, accumulation=cfg.train_accum, remat=cfg.remat,
        seq=seq, batch=batch, **moe,
        params=out["params"], losses=losses,
        first_step_s=out["first_step_s"],
        ms_per_step_after_first=out["ms_per_step_after_first"],
        tokens_per_s_after_first=out["tokens_per_s_after_first"],
        peak_memory_bytes=out["peak_memory_bytes"], formats=traj,
        launches=launches, launches_per_step=per_step,
        launches_per_step_formula=(
            f"3 x {n_leaves} quantized leaves"
            + ("" if rounding_bits == "onchip" else " (stacked ones a layer "
               "at a time)")
            + f" + 2 x {registry(cfg.family).residual_taps(cfg)} blocks x "
            f"{cfg.train_accum} microbatches"))
    res = {"launches": launches, "ms": out["ms_per_step_after_first"],
           "peak": out["peak_memory_bytes"], "losses": losses,
           "formats": traj, "argv": argv}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _attn_grads(fn, q, k, v, w, scale):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v, causal=True, scale=scale)
    grads = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    return [out.detach().float()] + [g.float() for g in grads]


def flash_check(cfg):
    """``_attn_flash`` (blocks of 1,024, each checkpointed) against
    ``_attn_full`` on the card at llama3.2-3b's attention shape at the long
    training sequence: outputs and the gradients of ``sum(out * w)`` within
    ``FLASH_TOL`` of the largest magnitude, in fp32 and in bf16; each
    path's forward + backward timed (CUDA events) and its peak memory."""
    from repro_torch.models import attention
    B, S, H, Dh = 1, LONG_SEQ - 1, cfg.n_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(Dh)
    g = torch.Generator(device=DEV).manual_seed(11)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, w = (torch.randn(B, S, H, Dh, generator=g, device=DEV
                                  ).to(dtype) for _ in range(4))
        w = w.float()
        name = str(dtype).split(".")[-1]
        runs, stat = {}, {}
        for path, fn in (("flash", attention._attn_flash),
                         ("full", attention._attn_full)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            runs[path] = _attn_grads(fn, q, k, v, w, scale)
            torch.cuda.synchronize()
            stat[f"{path}_peak_above_inputs_bytes"] = (
                torch.cuda.max_memory_allocated() - base)
            stat[f"{path}_fwd_bwd_ms"] = time_ms(
                lambda: _attn_grads(fn, q, k, v, w, scale), repeats=3,
                warmup=1)
        errs = {}
        for i, part in enumerate(("out", "dq", "dk", "dv")):
            a, b = runs["flash"][i], runs["full"][i]
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"flash {name} {part}: not finite")
            errs[part] = float((a - b).abs().max() / b.abs().max())
        if max(errs.values()) > FLASH_TOL[name]:
            raise AssertionError(f"_attn_flash vs _attn_full ({name}): "
                                 f"relative errors {errs} > {FLASH_TOL[name]}")
        res[name] = dict(max_rel_err=errs, tolerance=FLASH_TOL[name], **stat)
        del q, k, v, w, runs
        gc.collect()
        torch.cuda.empty_cache()
    say("flash", shape=f"B={B} S={S} H={H} Dh={Dh} causal, blocks of "
        f"{attention.FLASH_BLOCK}", **res)


def _mla_decode_expanded(mla_apply, cfg, p, x, *, positions, mode,
                         cache=None, cache_pos=None):
    """``mla_apply`` with its decode step in the expanded form — the plain
    path the absorbed form is held against: the new token's latents written
    as ``mla_apply`` writes them, then per-head K and V up-projected from
    the whole latent cache and one materialized attention over [0,
    cache_pos].  Other modes go to ``mla_apply`` itself."""
    from repro_torch.models import attention as A
    if mode != "decode":
        return mla_apply(cfg, p, x, positions=positions, mode=mode,
                         cache=cache, cache_pos=cache_pos)
    B, H = x.shape[0], cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = A._mla_qkr(cfg, p, x, positions)
    cc, cr = cache
    rows, at = torch.arange(B, device=x.device), cache_pos.to(torch.int64)
    cc[rows, at] = A._cache_write(c_kv[:, 0], cc.dtype)
    cr[rows, at] = A._cache_write(k_rope[:, 0], cr.dtype)
    c = A._cache_read(cc, x.dtype)
    S = c.shape[1]
    k = torch.cat([torch.einsum("bsr,rhd->bshd", c, p["w_uk"]),
                   A._cache_read(cr, x.dtype)[:, :, None, :].expand(
                       B, S, H, dr)], dim=-1)
    v = torch.einsum("bsr,rhd->bshd", c, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) / math.sqrt(
        dn + dr)
    valid = torch.arange(S, device=x.device)[None, :] <= cache_pos[:, None]
    s = s + torch.where(valid, 0.0, A.NEG_INF)[:, None, None, :]
    out = torch.einsum("bhqs,bshd->bqhd", torch.softmax(s, -1).to(v.dtype), v)
    return out.reshape(B, 1, H * dv) @ p["wo"], (cc, cr)


def _first_step_routed(cfg, params, tok, cache, pos, expanded):
    """One decode step on a copy of the cache — absorbed, or with
    ``expanded`` the expanded-form decode — recording each MoE layer's
    top-k experts.  Returns (logits over the vocabulary, [L] x (B, K)
    sorted expert indices)."""
    import functools
    from repro_torch.models import attention, moe
    absorbed, router, routes = attention.mla_apply, moe._router, []

    def recorded(*args):
        out = router(*args)
        routes.append(torch.sort(out[1], dim=-1).values)
        return out

    moe._router = recorded
    if expanded:
        attention.mla_apply = functools.partial(_mla_decode_expanded, absorbed)
    try:
        lg, _ = registry(cfg.family).decode_step(
            cfg, params, tok, tuple(c.clone() for c in cache), pos)
    finally:
        attention.mla_apply, moe._router = absorbed, router
    return lg[:, :cfg.vocab].float(), routes


def _absorbed_vs_expanded(cfg, params, tok, cache, pos):
    """The first decode step's logits, absorbed against expanded form on
    the same cache.  A row whose tokens took the same experts in every
    layer under both is held to ``LOGIT_TOL``; in a row where a layer's
    top-k differs, the two forms' rounding (bf16: ~5e-3 of an attention
    output, ``mla_check``) has tipped a router, and its logits are printed,
    not held."""
    a, ra = _first_step_routed(cfg, params, tok, cache, pos, False)
    b, rb = _first_step_routed(cfg, params, tok, cache, pos, True)
    same = torch.stack([(x == y).all(-1) for x, y in zip(ra, rb)]).all(0)
    err = (a - b).abs().amax(-1)
    held = float(err[same].max()) if bool(same.any()) else None
    if held is not None and held > LOGIT_TOL:
        raise AssertionError(f"deepseek ({cfg.dtype}, kv{cfg.kv_cache_bits}"
                             f"): first decode step's logits, absorbed vs "
                             f"expanded, differ by {held} (> {LOGIT_TOL}) "
                             f"in rows routed alike")
    return dict(rows_routed_alike=int(same.sum()), rows=int(same.numel()),
                max_abs_err_rows_routed_alike=held,
                max_abs_err_all_rows=float(err.max()),
                logits_max_abs=float(a.abs().max()), tolerance=LOGIT_TOL,
                same_argmax_rows=int((a.argmax(-1) == b.argmax(-1)).sum()))


def _mla_serve_run(cfg, params, prompts):
    """Prefill ``prompts``, then the decode steps (greedy), timed; the
    first step against the expanded-form decode's."""
    mod = registry(cfg.family)
    n, max_seq = DEEPSEEK_SERVE["steps"], DEEPSEEK_SERVE["max_seq"]
    B = prompts.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache, pos = mod.prefill(cfg, params, prompts, max_seq)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = logits[:, :cfg.vocab].argmax(-1, keepdim=True).to(torch.int32)
    vs_expanded = _absorbed_vs_expanded(cfg, params, tok, cache, pos)
    step_ms = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = mod.decode_step(cfg, params, tok, cache, pos)
        tok = lg[:, :cfg.vocab].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        pos = pos + 1
        if not bool(torch.isfinite(lg[:, :cfg.vocab]).all()):
            raise AssertionError(f"deepseek decode step {i}: logits not finite")
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = sum(c.numel() * c.element_size() for c in cache)
    gqa_bytes = 2 * cfg.n_layers * B * max_seq * 128 * 128 * \
        cache[0].element_size()
    ms = np.asarray(step_ms)
    return dict(prefill_s=prefill_s, decode_steps=n,
                p50_ms_per_decode_step=float(np.percentile(ms, 50)),
                p95_ms_per_decode_step=float(np.percentile(ms, 95)),
                tokens_per_s=B * n / (ms.sum() / 1e3),
                serve_peak_memory_bytes=peak,
                latent_cache_bytes=cache_bytes,
                gqa_cache_bytes_at_128x128=gqa_bytes,
                gqa_over_latent=gqa_bytes / cache_bytes,
                first_step_vs_expanded=vs_expanded)


def _deepseek_params(cfg):
    gen = torch.Generator(device=DEV).manual_seed(0)
    return init_params(registry(cfg.family).model_defs(cfg), DEV, gen)


def serve_deepseek():
    """deepseek-v2-236b at full width (MLA, 160 experts top-6 and 2 shared),
    bf16 weights from seed 0, cut to ``DEEPSEEK_LAYERS`` layers, through
    the contiguous path (MLA has no paged one): ``prefill`` of B prompts,
    then absorbed ``decode_step``s, with the latent caches in bf16
    (``kv_cache_bits`` 16) and int8.  Held: finite logits, and each first
    step's logits against the expanded-form decode's on the same cache
    (``_absorbed_vs_expanded``); then the same comparison in fp32 at one
    layer, where the two forms differ by summation order alone, every row
    held.  No kernel runs (MLA is plain torch, as in the reference)."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.models.common import hold_fp32_table
    gc.collect()
    torch.cuda.empty_cache()
    cfg = depth_cut("deepseek_v2_236b", DEEPSEEK_LAYERS)
    mod = registry(cfg.family)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _deepseek_params(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    params["embed"] = hold_fp32_table(params["embed"])   # as the engine does
    weights = sum(t.numel() * t.element_size()
                  for t in tree_lib.leaves(params))
    B, S = DEEPSEEK_SERVE["batch"], DEEPSEEK_SERVE["prompt"]
    g = torch.Generator(device=DEV).manual_seed(1)
    prompts = torch.randint(1, cfg.vocab, (B, S), generator=g, device=DEV,
                            dtype=torch.int32)
    mod.prefill(cfg, params, prompts[:2, :64], 80)       # warm-up
    _reset_quant_counts()
    dps_quant.launch_count = paged_attn.launch_count = 0
    runs = {}
    for bits in (16, 8):
        runs[f"kv{bits}"] = _mla_serve_run(
            dataclasses.replace(cfg, kv_cache_bits=bits), params, prompts)
    launches = dict(_quant_counts(), dps_group_wire_encode=dps_quant.launch_count,
                    paged_decode_attn=paged_attn.launch_count)
    if any(launches.values()):
        raise AssertionError(f"deepseek serving launched {launches}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # fp32 at one layer: every row held to LOGIT_TOL
    cfg32 = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    params = _deepseek_params(cfg32)
    fp32 = {}
    for bits in (16, 8):
        c = dataclasses.replace(cfg32, kv_cache_bits=bits)
        logits, cache, pos = mod.prefill(c, params, prompts,
                                         DEEPSEEK_SERVE["max_seq"])
        tok = logits[:, :c.vocab].argmax(-1, keepdim=True).to(torch.int32)
        fp32[f"kv{bits}"] = r = _absorbed_vs_expanded(c, params, tok, cache,
                                                      pos)
        if r["rows_routed_alike"] != r["rows"]:
            raise AssertionError(f"deepseek fp32 kv{bits}: the two forms "
                                 f"routed {r['rows'] - r['rows_routed_alike']}"
                                 f" rows differently")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("deepseek_v2_236b")
    say("serve_deepseek", model=cfg.name, layers=cfg.n_layers,
        layers_of=full.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
        q_lora_rank=cfg.q_lora_rank, kv_lora_rank=cfg.kv_lora_rank,
        qk_rope_dim=cfg.qk_rope_dim, n_experts=cfg.n_experts,
        n_shared_experts=cfg.n_shared_experts, top_k=cfg.top_k,
        params=cfg.n_params(), active_params=cfg.n_active_params(),
        weights_bytes_with_held_fp32_table=weights, weights_init_s=init_s,
        init_peak_memory_bytes=init_peak, batch=B, prompt=S,
        max_seq=DEEPSEEK_SERVE["max_seq"], kernel_launches=launches, **runs,
        fp32_one_layer_first_step_vs_expanded=fp32)


def _mla_train(cfg, p, x, w, positions):
    """``mla_apply`` in train mode: the output and the gradient of
    ``sum(out * w)`` with respect to ``x``."""
    from repro_torch.models import attention
    x = x.detach().requires_grad_()
    out, _ = attention.mla_apply(cfg, p, x, positions=positions, mode="train")
    (dx,) = torch.autograd.grad((out.float() * w).sum(), (x,))
    return out.detach().float(), dx.float()


def mla_check():
    """One MLA layer at deepseek-v2's full geometry on the card, fp32 and
    bf16 weights from seed 0: (1) train mode forward + backward at B=1,
    S=``MLA_SEQ``, blockwise (``_attn_flash``) against the materialized
    path (``_attn_full``, the threshold lifted for the run): output and
    input gradient within ``FLASH_TOL`` of the largest magnitude, each
    path's ms (CUDA events) and peak; (2) the absorbed decode at position S
    against the expanded form's last row over S + 1 positions, within
    ``MLA_DECODE_TOL``."""
    from repro_torch.models import attention
    cfg = get_config("deepseek_v2_236b")
    S, D = MLA_SEQ, cfg.d_model
    positions = torch.arange(S + 1, dtype=torch.int32, device=DEV)[None]
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        g = torch.Generator(device=DEV).manual_seed(13)
        p = init_params(attention.mla_defs(cfg, dtype), DEV, g)
        x = torch.randn(1, S + 1, D, generator=g, device=DEV).to(dtype)
        w = torch.randn(1, S, D, generator=g, device=DEV)
        runs, stat = {}, {}
        saved = attention.FLASH_THRESHOLD
        for path, threshold in (("flash", saved), ("full", float("inf"))):
            attention.FLASH_THRESHOLD = threshold
            try:
                fn = (lambda: _mla_train(cfg, p, x[:, :S], w,
                                         positions[:, :S]))
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                runs[path] = fn()
                torch.cuda.synchronize()
                stat[f"{path}_peak_above_inputs_bytes"] = (
                    torch.cuda.max_memory_allocated() - base)
                stat[f"{path}_fwd_bwd_ms"] = time_ms(fn, repeats=3, warmup=1)
            finally:
                attention.FLASH_THRESHOLD = saved
        errs = {}
        for i, part in enumerate(("out", "dx")):
            a, b = runs["flash"][i], runs["full"][i]
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"MLA flash {name} {part}: not finite")
            errs[part] = float((a - b).abs().max() / b.abs().max())
        if max(errs.values()) > FLASH_TOL[name]:
            raise AssertionError(f"MLA blockwise vs materialized ({name}): "
                                 f"relative errors {errs} > {FLASH_TOL[name]}")
        del runs
        with torch.no_grad():
            full, _ = attention.mla_apply(cfg, p, x, positions=positions,
                                          mode="prefill")
            _, cache = attention.mla_apply(cfg, p, x[:, :S],
                                           positions=positions[:, :S],
                                           mode="prefill")
            cache = tuple(torch.nn.functional.pad(c, (0, 0, 0, 1))
                          for c in cache)
            at = torch.full((1,), S, dtype=torch.int32, device=DEV)
            out, _ = attention.mla_apply(cfg, p, x[:, S:], positions=at[:, None],
                                         mode="decode", cache=cache,
                                         cache_pos=at)
        dec = float((out[:, 0].float() - full[:, -1].float()).abs().max()
                    / full[:, -1].float().abs().max())
        if not dec <= MLA_DECODE_TOL[name]:
            raise AssertionError(f"MLA absorbed vs expanded decode ({name}): "
                                 f"{dec} > {MLA_DECODE_TOL[name]}")
        res[name] = dict(max_rel_err=errs, tolerance=FLASH_TOL[name],
                         absorbed_decode_vs_expanded_max_rel_err=dec,
                         decode_tolerance=MLA_DECODE_TOL[name], **stat)
        del p, x, w, full, cache, out
        gc.collect()
        torch.cuda.empty_cache()
    say("mla_check", shape=f"B=1 S={S} H={cfg.n_heads} q_lora="
        f"{cfg.q_lora_rank} kv_lora={cfg.kv_lora_rank} rope="
        f"{cfg.qk_rope_dim} v={cfg.v_head_dim} causal, blocks of "
        f"{attention.FLASH_BLOCK}", **res)


# ---------------------------------------------------------------------------
# MoE expert parallelism: the all-to-all dispatch over a stacked mesh
# ---------------------------------------------------------------------------

def moe_a2a_plain(cfg, p, x, shape):
    """A second, plain implementation of the all-to-all dispatch's
    semantics on a (d, m) mesh: a Python loop over the ranks, each routing
    its own (B/d, S/m) block with its own capacity into (E, C, D) buffers
    (``index_put`` of the kept choices, no drop row), the moves to and from
    the experts' owners by explicit ``torch.cat`` of buffer slices, the
    load-balance ingredients averaged over every rank.  Returns (out, aux,
    the dispatch and return buffers as moved)."""
    from repro_torch.models import moe
    from repro_torch.models.common import act_fn
    d, m = shape
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    El, Bl, Sl = E // m, B // d, S // m
    int8 = cfg.moe_a2a_bits == 8
    snap = ((lambda t: moe._a2a_unpack(moe._a2a_pack(t), t.dtype)) if int8
            else (lambda t: t))
    ranks = [(i, j) for i in range(d) for j in range(m)]
    fs, ps, per = [], [], {}
    for i, j in ranks:
        x2 = x[i * Bl:(i + 1) * Bl, j * Sl:(j + 1) * Sl].reshape(-1, D)
        top_w, top_i, probs = moe._router(cfg, p["router"], x2)
        f, pb = moe._aux_fp(cfg, probs, top_i)
        fs.append(f)
        ps.append(pb)
        C = moe._capacity(x2.shape[0], cfg)
        pos, keep = moe._slots(cfg, top_i, C)
        t = torch.arange(x2.shape[0], device=x.device)[:, None].expand(-1, K)
        buf = x2.new_zeros((E, C, D))
        buf = buf.index_put((top_i[keep], pos[keep]), x2[t[keep]])
        per[i, j] = (top_w, top_i, pos, keep, C, buf)
    aux = E * torch.sum(torch.stack(fs).mean(0) * torch.stack(ps).mean(0)) * K
    sent, owned = [], {}
    for i, j in ranks:
        inp = torch.cat([per[i, s][5][j * El:(j + 1) * El] for s in range(m)],
                        dim=1)                                # (E_l, m·C, D)
        inp = snap(inp)
        sent.append(inp)
        sl = slice(j * El, (j + 1) * El)
        h = torch.einsum("ecd,edf->ecf", inp, p["w_in"][sl])
        g = torch.einsum("ecd,edf->ecf", inp, p["w_gate"][sl])
        owned[i, j] = torch.einsum("ecf,efd->ecd", act_fn(cfg.act, g) * h,
                                   p["w_out"][sl])
    rows, back = [], []
    for i, s in ranks:
        top_w, top_i, pos, keep, C, _ = per[i, s]
        ret = torch.cat([owned[i, j][:, s * C:(s + 1) * C] for j in range(m)],
                        dim=0)                                # (E, C, D)
        back.append(ret)
        got = snap(ret)[top_i, pos.clamp(max=C - 1)]          # (T, K, D)
        w = (top_w * keep).to(x.dtype)
        rows.append(torch.einsum("tk,tkd->td", w, got).reshape(Bl, Sl, D))
    out = torch.cat([torch.cat(rows[i * m:(i + 1) * m], dim=1)
                     for i in range(d)], dim=0)
    if cfg.n_shared_experts:
        from repro_torch.models.mlp import mlp_apply
        out = out + mlp_apply(cfg, p["shared"], x)
    return out, aux, sent, back


def _moe_grads(fn, p, x, w):
    """``fn(p, x)`` → (out, aux, ...); the gradients of ``sum(out * w) +
    aux`` with respect to x and every parameter (an unreached one:
    None)."""
    x = x.detach().requires_grad_()
    leaves = [(k, v.detach().requires_grad_()) for k, v in
              (("router", p["router"]), ("w_in", p["w_in"]),
               ("w_gate", p["w_gate"]), ("w_out", p["w_out"]))]
    q = dict(p, **dict(leaves))
    res = fn(q, x)
    out, aux = res[0], res[1]
    g = torch.autograd.grad((out.float() * w).sum() + aux,
                            [x] + [v for _, v in leaves], allow_unused=True)
    grads = {"dx": g[0], **{k: gk for (k, _), gk in zip(leaves, g[1:])}}
    return out.detach(), aux.detach(), grads, res[2:]


def _rel(a, b):
    """Largest difference over the largest magnitude of ``b``."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _dropped(cfg, p, x, shape=None):
    """Choices dropped by the per-rank capacities on ``shape`` (None: the
    einsum dispatch's one capacity over every token)."""
    from repro_torch.models import moe
    d, m = shape or (1, 1)
    B, S, D = x.shape
    n = 0
    with torch.no_grad():
        for i in range(d):
            for j in range(m):
                x2 = x[i * B // d:(i + 1) * B // d,
                       j * S // m:(j + 1) * S // m].reshape(-1, D)
                _, top_i, _ = moe._router(cfg, p["router"], x2)
                _, keep = moe._slots(cfg, top_i,
                                     moe._capacity(x2.shape[0], cfg))
                n += int((~keep).sum())
    return n


def _time_fwd_bwd(fn, p, x, w):
    """Forward + backward ms (CUDA events, median of 5 after 2 warm-ups)
    and the peak bytes above what was allocated before."""
    call = lambda: _moe_grads(fn, p, x, w)
    call()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return time_ms(call, repeats=5, warmup=2), peak


def moe_a2a_check():
    """One MoE layer at qwen3-moe's and deepseek-v2's full geometry on
    stacked (1, 4) and (2, 4) (data, model) meshes, fp32 and bf16: the
    all-to-all dispatch against the einsum dispatch at capacity factor 8
    (no drops) and against the plain loop (:func:`moe_a2a_plain`) at the
    configs' 1.25, each within ``A2A_TOL`` (out, aux, dx, the expert
    gradients); dropped choices under each; the int8 payload (every
    buffer element within ``A2A_SNAP`` of its 16-bit value unless
    saturated; its output against the 16-bit one; its expert gradient 0, as
    the reference's); forward + backward ms and peak of both dispatches."""
    from repro_torch.dist.sharding import LogicalRules, axis_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    res = {}
    for model, (B, S) in A2A_GEOMETRIES:
        full = get_config(model)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            g = torch.Generator(device=DEV).manual_seed(23)
            p = init_params(moe.moe_defs(full, dtype), DEV, g)
            x = torch.randn(B, S, full.d_model, generator=g,
                            device=DEV).to(dtype)
            w = torch.randn(B, S, full.d_model, generator=g, device=DEV)
            for shape in A2A_MESHES:
                mesh = make_mesh(shape, ("data", "model"), device=DEV)

                def a2a(cfg):
                    def fn(q, xx):
                        with axis_rules(mesh, LogicalRules()):
                            before = moe.DISPATCH_COUNTS["a2a"]
                            out = moe.moe_apply(cfg, q, xx)
                            assert moe.DISPATCH_COUNTS["a2a"] == before + 1
                        return out
                    return fn

                einsum = lambda cfg: (lambda q, xx: moe.moe_apply(cfg, q, xx))
                plain = lambda cfg: (lambda q, xx: moe_a2a_plain(cfg, q, xx,
                                                                 shape))
                row = {}
                cfg8 = dataclasses.replace(full, capacity_factor=8.0)
                cfg = full
                for tag, (ca, fa), (cb, fb) in (
                        ("vs_einsum", (cfg8, a2a), (cfg8, einsum)),
                        ("vs_plain", (cfg, a2a), (cfg, plain))):
                    oa, aa, ga, _ = _moe_grads(fa(ca), p, x, w)
                    ob, ab, gb, _ = _moe_grads(fb(cb), p, x, w)
                    errs = {"out": _rel(oa, ob), "aux": _rel(aa, ab),
                            **{k: _rel(ga[k], gb[k]) for k in gb}}
                    if not all(math.isfinite(v) for v in errs.values()) or \
                            max(errs.values()) > A2A_TOL[tag][dname]:
                        raise AssertionError(
                            f"MoE a2a {tag} ({model}, {shape}, {dname}): "
                            f"{errs} > {A2A_TOL[tag][dname]}")
                    row[tag] = dict(max_rel_err=errs,
                                    tolerance=A2A_TOL[tag][dname])
                    del oa, ob, ga, gb
                row["dropped"] = {
                    "a2a": _dropped(cfg, p, x, shape),
                    "einsum": _dropped(cfg, p, x), "choices": B * S * cfg.top_k}
                # the int8 payload against the 16-bit one
                cfg_i8 = dataclasses.replace(cfg, moe_a2a_bits=8)
                o8, _, g8, _ = _moe_grads(a2a(cfg_i8), p, x, w)
                o16, _, _, (sent, back) = _moe_grads(plain(cfg), p, x, w)
                _, _, _, (sent8, back8) = _moe_grads(plain(cfg_i8), p, x, w)
                snap_err, saturated, elems = 0.0, 0, 0
                for buf in sent + back8:
                    buf = buf.detach()
                    y = buf.float() * 16
                    sat = (y < -128.5) | (y >= 127.5)
                    err = (moe._a2a_unpack(moe._a2a_pack(buf), torch.float32)
                           - buf.float()).abs()
                    snap_err = max(snap_err, float(err[~sat].max()))
                    saturated += int(sat.sum())
                    elems += buf.numel()
                if snap_err > A2A_SNAP:
                    raise AssertionError(f"MoE int8 payload ({model}, "
                                         f"{dname}): {snap_err} > 1/32")
                if any(g8[k] is not None and bool(g8[k].any())
                       for k in ("w_in", "w_gate", "w_out")):
                    raise AssertionError("int8 a2a: an expert gradient is "
                                         "not 0 (the reference's is)")
                if not bool(torch.isfinite(o8).all()):
                    raise AssertionError("int8 a2a: output not finite")
                row["int8"] = dict(
                    max_snap_err=snap_err, limit=A2A_SNAP,
                    saturated=saturated, payload_elements=elems,
                    out_vs_16bit_max_abs=float((o8.float()
                                                - o16.float()).abs().max()),
                    out_16bit_max_abs=float(o16.float().abs().max()),
                    expert_grad_max_abs=0.0)
                del o8, g8, o16, sent, back, sent8, back8
                # forward + backward time and peak, the configs' capacity
                for name, fn in (("a2a", a2a(cfg)), ("einsum", einsum(cfg))):
                    ms, peak = _time_fwd_bwd(fn, p, x, w)
                    row[f"{name}_fwd_bwd_ms"] = ms
                    row[f"{name}_peak_above_inputs_bytes"] = peak
                res[f"{model}/{dname}/{shape[0]}x{shape[1]}"] = row
                gc.collect()
                torch.cuda.empty_cache()
            del p, x, w
            gc.collect()
            torch.cuda.empty_cache()
    say("moe_a2a_check", geometries={
            m: dict(d_model=get_config(m).d_model,
                    experts=get_config(m).n_experts,
                    top_k=get_config(m).top_k, d_ff=get_config(m).moe_d_ff,
                    shared=get_config(m).n_shared_experts, x=[B, S])
            for m, (B, S) in A2A_GEOMETRIES},
        loss="sum(out * w) + aux", **res)


def train_qwen_ep(einsum_run):
    """qwen3-moe-30b-a3b trained by ``launch.train.main`` (4 of 48 layers,
    ``--batch 2 --seq 512``, SGD, K1b) inside ``axis_rules`` of a stacked
    (1, 4) mesh: every MoE call on the all-to-all dispatch, K1b a step equal
    to the einsum run's, finite losses; ms a step, peak and first loss
    beside the einsum run of this call (``einsum_run``).  Then one step at
    capacity factor 8 under the mesh against one without it from the same
    seed, first losses within ``EP_LOSS_RTOL``."""
    from repro_torch.dist.sharding import LogicalRules, axis_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    model = "qwen3_moe_30b_a3b"
    cfg = depth_cut(model, 4)
    mesh = make_mesh(EP_MESH, ("data", "model"), device=DEV)
    before = dict(moe.DISPATCH_COUNTS)
    with axis_rules(mesh, LogicalRules()):
        run = train_lm(cfg, "onchip", 4, batch=2, model=model,
                       phase="train_qwen_ep")
    calls = {k: moe.DISPATCH_COUNTS[k] - before[k] for k in before}
    if calls["einsum"] or not calls["a2a"]:
        raise AssertionError(f"train_qwen_ep: MoE dispatch calls {calls}")
    if run["launches"] != einsum_run["launches"]:
        raise AssertionError(f"train_qwen_ep: K1b launches {run['launches']}"
                             f", the einsum run's {einsum_run['launches']}")
    cfg8 = dataclasses.replace(cfg, capacity_factor=8.0)
    with axis_rules(mesh, LogicalRules()):
        ep8 = train_lm(cfg8, "onchip", 1, batch=2, model=model,
                       phase="train_qwen_ep_cf8")
    es8 = train_lm(cfg8, "onchip", 1, batch=2, model=model,
                   phase="train_qwen_einsum_cf8")
    rel = abs(ep8["losses"][0] - es8["losses"][0]) / abs(es8["losses"][0])
    if not rel <= EP_LOSS_RTOL:
        raise AssertionError(f"train_qwen_ep at capacity 8: first loss "
                             f"{ep8['losses'][0]} vs einsum "
                             f"{es8['losses'][0]} ({rel} > {EP_LOSS_RTOL})")
    say("ep_vs_einsum", mesh=list(EP_MESH), moe_calls=calls,
        ep_ms_per_step=run["ms"], einsum_ms_per_step=einsum_run["ms"],
        ep_peak_memory_bytes=run["peak"],
        einsum_peak_memory_bytes=einsum_run["peak"],
        ep_first_loss=run["losses"][0],
        einsum_first_loss=einsum_run["losses"][0],
        launches_per_step_equal=True,
        cf8_first_loss_ep=ep8["losses"][0],
        cf8_first_loss_einsum=es8["losses"][0], cf8_rel=rel,
        cf8_tolerance=EP_LOSS_RTOL)
    return run["launches"]


# ---------------------------------------------------------------------------
# the SSM, hybrid and encoder-decoder families: contiguous serving, SSD
# ---------------------------------------------------------------------------

def _nbytes(tree):
    """Bytes of a cache: tensors in tuples and dicts."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _first_step_vs_recomputation(cfg, mod, params, prompts, kw, lg0, tok):
    """The first decode step's logits ``lg0`` (after the prompts) against
    ``forward`` over the prompts and the token ``tok`` it was fed: the
    largest error relative to the largest logit, and that logit."""
    with torch.no_grad():
        full, _ = mod.forward(cfg, params, torch.cat([prompts, tok], 1),
                              mode="prefill", **kw)
    full = full[:, -1, :cfg.vocab].float()
    big = float(full.abs().max())
    return float((lg0 - full).abs().max()) / big, big


def _draw_served(cfg, mod, seed):
    """``cfg``'s weights from ``seed`` on the card, the unembedding's fp32
    cast held as the engine holds it."""
    from repro_torch.models.common import hold_fp32_table
    params = init_params(mod.model_defs(cfg), DEV,
                         torch.Generator(device=DEV).manual_seed(seed))
    params["embed"] = hold_fp32_table(params["embed"])
    return params


def _first_step(cfg, mod, params, prompts, kw, max_seq, tok=None):
    """Prefill, then one decode step fed ``tok`` (None: the prefill's
    greedy token): that step's logits in fp32, and the token."""
    with torch.no_grad():
        logits, cache, pos = mod.prefill(cfg, params, prompts, max_seq, **kw)
        if tok is None:
            tok = logits[:, :cfg.vocab].argmax(-1, keepdim=True).to(torch.int32)
        lg, _ = mod.decode_step(cfg, params, tok, cache, pos)
    return lg[:, :cfg.vocab].float(), tok


def _first_step_readings(cfg, mod, seed, prompts, kw, max_seq, served=None):
    """The first decode step after ``prompts`` with the bf16 weights of
    ``seed``, held three ways, each as (the largest error relative to the
    largest logit of what it is held against, that logit): in bf16 and in
    fp32 (the same weights, cast up exactly) against the recomputation from
    the prompt, and the bf16 step against the fp32 step fed the same token
    (a fault that only shows in bf16: a wrong cast, a cache in the wrong
    dtype).  ``served``: the served run's (params, first-step logits,
    token) at this seed; else drawn and stepped here."""
    from repro_torch.core import tree as tree_lib
    if served is None:
        params = _draw_served(cfg, mod, seed)
        lg16, tok = _first_step(cfg, mod, params, prompts, kw, max_seq)
    else:
        params, lg16, tok = served
    out = {"bfloat16": _first_step_vs_recomputation(cfg, mod, params, prompts,
                                                    kw, lg16, tok)}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = tree_lib.map_tree(lambda t: t.float(), params)
    lg32, _ = _first_step(cfg32, mod, params, prompts, kw, max_seq, tok)
    out["float32"] = _first_step_vs_recomputation(cfg32, mod, params, prompts,
                                                  kw, lg32, tok)
    big = float(lg32.abs().max())
    out["bfloat16_vs_float32"] = (float((lg16 - lg32).abs().max()) / big, big)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_family(model, layers, phase):
    """``model`` at full width (``layers`` deep; None: all), bf16 weights
    from seed 0 on the card, served
    through its contiguous path: ``prefill`` of B prompts of ``prompt``
    tokens (an encoder-decoder's after seeded frames (B, enc_seq, D)), then
    greedy ``decode_step``s, each timed with a synchronize.  Held: finite
    logits, and the first step's logits (``_first_step_readings``, at the
    served weights and at those of each other seed of
    ``FAMILY_CHECK_SEEDS``) against the recomputation from the prompt
    (``forward`` over the prompt and the first token: the SSM's chunked
    scan against its O(1) recurrence, the attention caches against a fresh
    prefill) in bf16 and with the same weights in fp32, and the bf16 step
    against the fp32 step, each within ``FAMILY_FIRST_STEP_RTOL``'s
    limit for ``model``.  No
    kernel runs (the reference serves these families with jnp alone)."""
    from repro_torch.core import tree as tree_lib
    gc.collect()
    torch.cuda.empty_cache()
    cfg = depth_cut(model, layers)
    mod = registry(cfg.family)
    shape = FAMILY_SERVE_SHAPE
    B, S, n, max_seq = (shape[k] for k in ("batch", "prompt", "steps",
                                            "max_seq"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _draw_served(cfg, mod, FAMILY_CHECK_SEEDS[0])
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    weights = sum(t.numel() * t.element_size() for t in tree_lib.leaves(params))
    g = torch.Generator(device=DEV).manual_seed(1)
    prompts = torch.randint(1, cfg.vocab, (B, S), generator=g, device=DEV,
                            dtype=torch.int32)
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = torch.randn(B, cfg.enc_seq, cfg.d_model, generator=g,
                                   device=DEV)
    mod.prefill(cfg, params, prompts[:2, :64], 80,
                **{k: v[:2] for k, v in kw.items()})       # warm-up
    _reset_quant_counts()
    dps_quant.launch_count = paged_attn.launch_count = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache, pos = mod.prefill(cfg, params, prompts, max_seq, **kw)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cache_bytes = _nbytes(cache)
    tok = logits[:, :cfg.vocab].argmax(-1, keepdim=True).to(torch.int32)
    step_ms, first = [], None
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = mod.decode_step(cfg, params, tok, cache, pos)
        nxt = lg[:, :cfg.vocab].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if not bool(torch.isfinite(lg[:, :cfg.vocab]).all()):
            raise AssertionError(f"{phase} decode step {i}: logits not finite")
        if i == 0:
            first = (lg[:, :cfg.vocab].float(), tok)
        tok, pos = nxt, pos + 1
    peak = torch.cuda.max_memory_allocated()
    launches = dict(_quant_counts(), dps_group_wire_encode=dps_quant.launch_count,
                    paged_decode_attn=paged_attn.launch_count)
    if any(launches.values()):
        raise AssertionError(f"{phase} launched {launches}")
    del cache
    readings = {FAMILY_CHECK_SEEDS[0]: _first_step_readings(
        cfg, mod, FAMILY_CHECK_SEEDS[0], prompts, kw, max_seq,
        served=(params, *first))}
    del params, first
    gc.collect()
    torch.cuda.empty_cache()
    for seed in FAMILY_CHECK_SEEDS[1:]:
        readings[seed] = _first_step_readings(cfg, mod, seed, prompts, kw,
                                              max_seq)
    tol = FAMILY_FIRST_STEP_RTOL[model]
    for seed, errs in readings.items():
        for how, (rel, _) in errs.items():
            if not rel <= tol[how]:
                raise AssertionError(
                    f"{phase}: first decode step, weights from seed {seed}, "
                    f"{how}: {rel} > {tol[how]} of the largest logit")
    ms = np.asarray(step_ms)
    full_cfg = get_config(model)
    extra = {}
    if cfg.family == "hybrid":
        extra = dict(shared_invocations=cfg.n_layers // cfg.hybrid_period)
    if cfg.family == "encdec":
        extra = dict(enc_layers=cfg.n_enc_layers, frames=cfg.enc_seq)
    say(phase, model=cfg.name, layers=cfg.n_layers, layers_of=full_cfg.n_layers,
        d_model=cfg.d_model, **extra, params=cfg.n_params(),
        weights_bytes_with_held_fp32_table=weights, weights_init_s=init_s,
        init_peak_memory_bytes=init_peak, batch=B, prompt=S, max_seq=max_seq,
        prefill_s=prefill_s, decode_steps=n,
        p50_ms_per_decode_step=float(np.percentile(ms, 50)),
        p95_ms_per_decode_step=float(np.percentile(ms, 95)),
        tokens_per_s=B * n / (ms.sum() / 1e3), serve_peak_memory_bytes=peak,
        cache_bytes=cache_bytes,
        first_step={
            f"seed_{seed}": {
                how: {"max_rel_err": rel, "max_abs_logit": big,
                      "tolerance": tol[how]}
                for how, (rel, big) in errs.items()}
            for seed, errs in readings.items()},
        kernel_launches=launches)


def ssd_check():
    """One Mamba2 layer at mamba2-1.3b's full geometry (d=2048, 64 heads of
    64, state 128, chunk 256) in fp32, weights from seed 0 with the
    configs' initialization (``a_log = dt_bias = 0``): ``ssm_apply`` in
    train mode (the chunked ``ssd_scan``) over ``SSD_SEQ`` positions against
    the O(1) decode recurrence run token by token, within ``SSD_TOL`` of the
    largest magnitude, its input gradient finite.  Printed: the largest
    chunk span of the decays (sum of dt over a chunk), which above
    log(FLT_MAX) overflows the reference's unmasked ``exp(rel)``, and each
    path's time."""
    from repro_torch.models import ssm
    cfg = get_config("mamba2_1_3b")
    g = torch.Generator(device=DEV).manual_seed(0)
    p = init_params(ssm.ssm_defs(cfg, torch.float32), DEV, g)
    u = torch.randn(1, SSD_SEQ, cfg.d_model, generator=g, device=DEV)
    x = u.clone().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, _ = ssm.ssm_apply(cfg, p, x, mode="train")
    (dx,) = torch.autograd.grad(y.square().sum(), (x,))
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    H, P, N = ssm.n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state
    cache = (torch.zeros(1, H, P, N, device=DEV),
             torch.zeros(1, cfg.ssm_conv - 1, ssm.conv_channels(cfg),
                         device=DEV))
    steps = []
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(SSD_SEQ):
            out, cache = ssm.ssm_apply(cfg, p, u[:, t:t + 1], mode="decode",
                                       cache=cache)
            steps.append(out)
        rec = torch.cat(steps, 1)
        torch.cuda.synchronize()
    recurrence_s = time.perf_counter() - t0
    err = float((y.detach() - rec).abs().max() / rec.abs().max())
    with torch.no_grad():
        dt, _ = ssm._decays(cfg, ssm._split_proj(cfg, u @ p["w_in"])[2],
                            p["a_log"], p["dt_bias"])
        Q = cfg.ssm_chunk
        span = float(dt[:, :SSD_SEQ // Q * Q].reshape(1, -1, Q, H).sum(2).max())
    finite = bool(torch.isfinite(y).all()) and bool(torch.isfinite(dx).all())
    if not (finite and err <= SSD_TOL):
        raise AssertionError(f"ssd_check: finite {finite}, chunked vs "
                             f"recurrence {err} > {SSD_TOL}")
    f32_exp_max = math.log(np.finfo(np.float32).max)
    say("ssd_check", shape=f"B=1 S={SSD_SEQ} d={cfg.d_model} H={H} P={P} "
        f"N={N} chunk={Q} fp32", chunked_vs_recurrence_max_rel_err=err,
        tolerance=SSD_TOL, output_and_grad_finite=finite,
        largest_chunk_decay_span=span, log_flt_max=f32_exp_max,
        reference_exp_would_overflow=span > f32_exp_max,
        chunked_fwd_bwd_s=chunked_s, recurrence_s=recurrence_s)
    del p, u, x, y, dx, rec
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the wire path: K2/K2b, K3b, K4, the collectives, data-parallel training
# ---------------------------------------------------------------------------

def check_wire_quant(x, il, fl, bits=None, *, stats=True, out_offset=None):
    """One K2/K2b configuration, kernel vs plain on the card: wire bytes
    equal, statistics per ``_stats_match``, a second launch equal.
    ``out_offset`` writes the kernel's wire into a larger buffer at that
    offset (an unaligned slot takes the scalar path).  Returns (the largest
    |byte_kernel - byte_plain|, the largest relative difference of a float
    sum)."""
    il, fl = _i32(il), _i32(fl)
    out = None
    if out_offset is not None:
        buf = torch.full((x.numel() + out_offset + 5,), 77, dtype=torch.int8,
                         device=DEV)
        out = buf[out_offset:out_offset + x.numel()].view(x.shape)
    wk, sk = dps_quant.dps_quant_wire(x, il, fl, bits, compute_stats=stats,
                                      out=out, backend="kernel")
    wp, sp = dps_quant.dps_quant_wire(x, il, fl, bits, compute_stats=stats,
                                      backend="plain")
    torch.cuda.synchronize()
    if not torch.equal(wk, wp):
        raise AssertionError(
            f"wire quantizer: {int((wk != wp).sum())} of {x.numel()} bytes "
            f"differ ({x.dtype}, {_bits_name(bits)})")
    if out_offset is not None and not (bool((buf[:out_offset] == 77).all())
                                       and bool((buf[-5:] == 77).all())):
        raise AssertionError("wire quantizer wrote outside its slot")
    err = _byte_err(wk, wp)
    if not stats:
        if sk is not None:
            raise AssertionError("compute_stats=False returned statistics")
        return err, 0.0
    rel = _stats_match(sk, sp, x.numel())
    wk2, sk2 = dps_quant.dps_quant_wire(x, il, fl, bits, backend="kernel")
    if not (torch.equal(wk, wk2) and torch.equal(sk, sk2)):
        raise AssertionError("wire quantizer: two launches gave different bits")
    return err, rel


def _byte_err(a, b):
    """The largest |a - b| of two int8 tensors, as a float."""
    if not a.numel():
        return 0.0
    return float((a.to(torch.int16) - b.to(torch.int16)).abs().max())


def _reduce_body(wire, quantum):
    """The body ``reduce_plan`` gives K4 for this view of the rows."""
    n, chunk = wire.shape
    aligned = wire.data_ptr() % 16 == 0        # the output is a fresh tensor
    return dps_quant.reduce_plan(n, chunk, quantum,
                                 wire.stride(0) if n > 1 else chunk,
                                 aligned).body


def check_reduce(wire, tab, tg, quantum, body=None):
    """K4 vs plain on the card: the means bit-equal, and the launch on the
    body the plan gives (``body``, if given, too) by the TMA counter."""
    want = _reduce_body(wire, quantum)
    if body is not None and body != want:
        raise AssertionError(f"wire reduce: planned the {want} body, "
                             f"wanted {body}")
    tma0 = dps_quant.reduce_tma_launch_count
    mk = dps_quant.dps_wire_reduce(wire, tab, tg, quantum=quantum,
                                   backend="kernel")
    took = "tma" if dps_quant.reduce_tma_launch_count > tma0 else "stride"
    mp = dps_quant.dps_wire_reduce(wire, tab, tg, quantum=quantum,
                                   backend="plain")
    torch.cuda.synchronize()
    if took != want:
        raise AssertionError(f"wire reduce: launched the {took} body, "
                             f"planned {want}")
    if not torch.equal(mk.view(torch.int32), mp.view(torch.int32)):
        raise AssertionError(f"wire reduce: {int((mk != mp).sum())} of "
                             f"{mk.numel()} means differ (n={wire.shape[0]}, "
                             f"quantum={quantum}, {took} body)")
    return float((mk - mp).abs().max()) if mk.numel() else 0.0


def torch_sum_ms(view):
    """``torch.sum`` of the int8 rows into fp32: the same bytes as K4, not
    the same function (no decode, no mean), a yardstick the port never
    calls."""
    return time_ms(lambda: torch.sum(view, dim=0, dtype=torch.float32),
                   repeats=10)


def check_group_prng(x, tab, tg, src, quantum, *, mask=None, stats=True):
    """K3b vs plain, and K3b vs K3 fed the same Philox words: bytes equal,
    statistics exact (counts) and to SUM_RTOL (sums)."""
    kw = dict(quantum=quantum, emit_stats=stats)
    wk, sk = dps_quant.dps_quant_group_wire(x, tab, tg, src, mask,
                                            backend="kernel", **kw)
    wp, sp = dps_quant.dps_quant_group_wire(x, tab, tg, src, mask,
                                            backend="plain", **kw)
    words = dps_quant.group_philox_bits(src, tg, quantum)
    wb, sb = dps_quant.dps_quant_group_wire(x, tab, tg, words, mask,
                                            backend="kernel", **kw)
    torch.cuda.synchronize()
    if not (torch.equal(wk, wp) and torch.equal(wk, wb)):
        raise AssertionError(f"K3b: bytes differ from the plain version or "
                             f"from K3 fed the same words (quantum {quantum})")
    rel = 0.0
    if stats:
        exact = [0, 1, 2, 6]
        if not (torch.equal(sk[:, exact], sp[:, exact])
                and torch.equal(sk[:, exact], sb[:, exact])):
            raise AssertionError("K3b: count/nonzero/overflow/max_abs differ")
        rel = max(float(((sk[:, 3:6] - o[:, 3:6]).abs()
                         / o[:, 3:6].abs().clamp(min=1e-30)).max())
                  for o in (sp, sb))
        if rel > SUM_RTOL:
            raise AssertionError(f"K3b: float sums differ by {rel:.3g}")
    return rel


def _layout_bits(rng, sizes, n, quantum):
    """A group-aligned layout of ``sizes`` over ``n`` ranks and its tables
    on the card."""
    from repro_torch.dist import group_layout
    lay = group_layout(sizes, n_chunks=n, quantum=quantum)
    tg = torch.from_numpy(lay.tile_groups()).to(DEV)
    goff = torch.tensor(lay.offsets, dtype=torch.int64, device=DEV)
    il = rng.integers(1, 5, len(sizes))
    tab = torch.from_numpy(np.stack([il, 8 - il], 1).astype(np.int32)).to(DEV)
    return lay, tg, goff, tab


def wire_kernel_checks(cfg):
    """K2/K2b, K3b and K4 against their plain versions at small shapes and
    at the wire path's; the exact counts of K3 on a group past 2^24
    elements.  Returns the four ``kernels`` rows (launches filled in by the
    wire phases)."""
    rng = np.random.default_rng(2)

    def draw(n, dtype, scale=4.0, offset=0):
        v = rng.standard_normal(n + offset).astype(np.float32) * scale
        v[::7] = 0.0
        return torch.from_numpy(v).to(DEV).to(dtype)[offset:]

    def npbits(n):
        return torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)
                                .view(np.int32)).to(DEV)

    small, worst = [], 0.0
    # K2 / K2b: sizes, types, alignment, bit sources, saturation, statistics
    for n in (1, 3, 1023, 100_003, 4096):
        for dtype in (torch.float32, torch.bfloat16):
            for offset in (0, 1):
                x = draw(n, dtype, offset=offset)
                bits = npbits(n)
                for il, fl in ((3, 5), (6, 6)):          # (6, 6) saturates
                    for stats in (False, True):
                        for src in (None, bits, dps_quant.Philox(99 + n),
                                    dps_quant.Philox(99 + n, offset=6),
                                    dps_quant.Philox(99 + n, offset=3)):
                            worst = max(worst, check_wire_quant(
                                x, il, fl, src, stats=stats)[1])
                worst = max(worst, check_wire_quant(
                    x, 3, 5, dps_quant.Philox(5), out_offset=3)[1])
                worst = max(worst, check_wire_quant(x, 3, 5, out_offset=16)[1])
                for off in (0, 3, 8):
                    a, sa = dps_quant.dps_quant_wire(
                        x, _i32(3), _i32(5), dps_quant.Philox(11, off),
                        backend="kernel")
                    b, sb = dps_quant.dps_quant_wire(
                        x, _i32(3), _i32(5),
                        dps_quant.philox_bits(11, n, DEV, offset=off),
                        backend="kernel")
                    if not torch.equal(a, b):
                        raise AssertionError("K2b differs from K2 fed the "
                                             "same Philox words")
                    _stats_match(sa, sb, n)
            small.append(f"wire n={n} {dtype}")
    # NaN and infinities: the same byte from the kernel and the plain version
    xn = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.5, -0.25,
                       float("nan"), 3.0, 1e9], device=DEV)
    check_wire_quant(xn, 3, 5, stats=False)
    nan_byte = int(dps_quant.dps_quant_wire(xn, _i32(3), _i32(5),
                                            backend="kernel")[0][0])
    # K4: rank counts, tables, ragged chunks, strided rows; then the TMA
    # body's edges: a chunk shorter than one span, a quantum below the span
    # (an item a tile, neighbours of other formats) and above it (several
    # items a tile, the last shorter when the span does not divide it), a
    # ragged last tile, n = 16 and n = 300 (two 256-row passes of the packed
    # sums), rows at the int8 extremes, a 16-byte row stride from a base
    # off 16 bytes (the grid-stride body)
    for n_ranks, chunk, quantum, groups, stride_pad, base in (
            (1, 4096, 4096, 1, 0, 0), (2, 8192, 4096, 2, 0, 0),
            (3, 1000, 100, 4, 0, 0), (4, 777, 7, 3, 5, 0),
            (5, 4096 * 3, 4096, 3, 4096 * 2, 0), (8, 160, 16, 2, 16, 0),
            (7, 12345, 4096, 2, 0, 0), (6, 64, 16, 4, 3, 0),
            (4, 64, 4096, 1, 0, 0), (4, 4096 * 4, 1024, 5, 0, 0),
            (4, 4096 * 5, 16384, 3, 32, 0), (3, 4112 * 3, 4112, 3, 0, 0),
            (4, 4096 * 2 + 1024, 4096, 3, 0, 0), (16, 4096 * 3, 4096, 3, 0, 0),
            (300, 4096, 4096, 2, 0, 0), (4, 8192, 4096, 2, 13, 3)):
        tiles = -(-chunk // quantum)
        big = torch.from_numpy(rng.integers(
            -128, 127, (n_ranks, base + chunk + stride_pad), dtype=np.int8,
            endpoint=True)).to(DEV)
        big[:, base:base + 3] = 127
        big[:, base + 3:base + 6] = -128
        w = big[:, base:base + chunk]                     # rows stride apart
        il = rng.integers(1, 6, groups)
        tab = torch.from_numpy(np.stack([il, 8 - il], 1).astype(np.int32)).to(DEV)
        tg = torch.from_numpy(np.sort(rng.integers(0, groups, tiles))
                              .astype(np.int32)).to(DEV)
        check_reduce(w, tab, tg, quantum)
        check_reduce(w, tab[:1].contiguous(), None, quantum)
        small.append(f"reduce n={n_ranks} chunk={chunk} q={quantum} G={groups} "
                     f"row_stride={base + chunk + stride_pad} base+{base} "
                     f"{_reduce_body(w, quantum)}")
    # K3b: per-group streams over layouts, every owner's chunk
    for sizes, n_ranks, quantum, dtype in (((700, 3000, 5), 3, 128, torch.float32),
                                           ((5000, 37, 9000, 1), 4, 4096, torch.float32),
                                           ((301, 77), 2, 6, torch.float32),
                                           ((1000, 2000), 2, 64, torch.bfloat16),
                                           # chunks over many blocks, runs
                                           # of one group across them
                                           ((300_000, 5000, 1_000_000), 2, 4096,
                                            torch.float32)):
        lay, tg, goff, tab = _layout_bits(rng, sizes, n_ranks, quantum)
        x = draw(lay.total, dtype, scale=0.5)
        mask = torch.from_numpy((rng.random(lay.total) > 0.1)
                                .astype(np.float32)).to(DEV)
        tpc = lay.chunk // quantum
        for j in range(n_ranks):
            src = dps_quant.GroupPhilox(4242, goff, start=j * lay.chunk,
                                        group_base=j % 2)
            xs = x[j * lay.chunk:(j + 1) * lay.chunk]
            tj = tg[j * tpc:(j + 1) * tpc]
            for stats in (False, True):
                worst = max(worst, check_group_prng(xs, tab, tj, src, quantum,
                                                    stats=stats))
            worst = max(worst, check_group_prng(
                xs, tab, tj, src, quantum,
                mask=mask[j * lay.chunk:(j + 1) * lay.chunk]))
        small.append(f"group prng sizes={sizes} n={n_ranks} q={quantum} {dtype}")

    # K3's counts past 2^24 in one group (about 16.86 M of its 17.2 M
    # elements kept by the mask): float32 partial counts would round
    T, q = 4200, 4096
    xb = draw(T * q, torch.float32, scale=8.0)
    mb = torch.from_numpy((rng.random(T * q) > 0.02).astype(np.float32)).to(DEV)
    tab1 = torch.tensor([[1, 2]], dtype=torch.int32, device=DEV)
    tg1 = torch.zeros(T, dtype=torch.int32, device=DEV)
    _, sk = dps_quant.dps_quant_group_wire(xb, tab1, tg1, None, mb, quantum=q,
                                           backend="kernel")
    _, sp = dps_quant.dps_quant_group_wire(xb, tab1, tg1, None, mb, quantum=q,
                                           backend="plain")
    want = [float(np.float32(int((mb != 0).sum().item()))),
            float(np.float32(int(((xb != 0) & (mb != 0)).sum().item())))]
    if not (torch.equal(sk[:, [0, 1, 2, 6]], sp[:, [0, 1, 2, 6]])
            and sk[0, :2].tolist() == want and want[0] > 1 << 24):
        raise AssertionError(f"K3 counts past 2^24: {sk[0, :3].tolist()} vs "
                             f"plain {sp[0, :3].tolist()}, exact {want}")
    big_counts = {"elements": T * q, "count": float(sk[0, 0]),
                  "nonzero": float(sk[0, 1]), "overflow": float(sk[0, 2])}
    del xb, mb

    rows, errs, rels = wire_path_rows(cfg, rng, ("layers", "mlp", "w_in"),
                                      operand=True)
    say("wire_kernels", small_shapes=small, small_worst_sum_rel=worst,
        nan_byte=nan_byte, k3_counts_past_2_24=big_counts,
        main_path_sum_rel=rels, main_path_max_abs_err=errs,
        tolerances=WIRE_TOLERANCES,
        main_path=[{k: r[k] for k in ("name", "shape", "ms", "plain_ms",
                                      "bound_ms", "bound_by")} for r in rows])
    return rows


WIRE_TOLERANCES = {"wire_bytes": "bit-equal", "reduce_mean": "bit-equal",
                   "float_sums_rel": SUM_RTOL,
                   "counts": "exact below 2^24, 1 ulp above (K1/K2); "
                             "exact (K3)"}


def wire_path_rows(cfg, rng, leaf, *, operand, run=None, model=None,
                   n_ranks=4):
    """K2b (and, with ``operand``, K2 with a bits operand and at nearest) on
    the gradient of ``cfg``'s leaf ``leaf`` (its largest), then K4 on owner
    1's [n_ranks, chunk] view of the full tree's per-layer int8 stack and
    K3b (and, with ``operand``, K3 with a bits operand) on that owner's
    mean chunk, as the wire step launches them: each bit-equal to its plain
    version on the same inputs, timed, with its own bound.  ``run``: the
    rows take that run's launches, each named for its counter and
    ``model``, ``cfg``'s module; else the rows are the counters' own.
    Returns (rows, errors, the statistics' relative errors)."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.dist import group_layout
    defs = registry(cfg.family).model_defs(cfg, cfg.master_dtype())
    sizes = tuple(math.prod(d.shape) for d in tree_lib.leaves(defs))
    node = defs
    for key in leaf:
        node = node[key]
    w_in = math.prod(node.shape)
    leaf_name = (f"{'/'.join(leaf)} gradient leaf "
                 f"{'x'.join(map(str, node.shape))} = {w_in} fp32")
    # K2b on the w_in gradient leaf (grads of a random-init LM are ~1e-4;
    # the wire format of that domain starts at <6, 2> and settles at <1, 7>)
    g = torch.Generator(device=DEV).manual_seed(8)
    x = torch.randn(w_in, generator=g, device=DEV) * 0.02
    x[::11] = 0.0
    il, fl = 1, 7
    errs, rels = {}, {}
    errs["w_in_k2b"], rels["w_in_k2b"] = check_wire_quant(x, il, fl,
                                                          dps_quant.Philox(21))
    if operand:
        wbits = torch.randint(-2**31, 2**31, (w_in,), dtype=torch.int32,
                              device=DEV, generator=g)
        errs["w_in_k2"], rels["w_in_k2"] = check_wire_quant(x, il, fl, wbits)
        errs["w_in_k2_nearest"], rels["w_in_k2_nearest"] = check_wire_quant(
            x, il, fl)
    check_wire_quant(x, il, fl, dps_quant.Philox(21), stats=False)

    def row(counter, replaces, shape, **kw):
        out = {"name": counter, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/dps_quant.cu",
               "replaces": replaces, "shape": shape}
        if run is not None:
            out.update(name=f"{counter}_{model}", counter=counter, run=run,
                       model=cfg.name)
        out.update(kw)
        return out

    def wire_row(name, bits, nbytes, nops, note):
        key = "w_in_k2b" if "prng" in name else "w_in_k2"
        args = (x, _i32(il), _i32(fl), bits)
        ms = time_ms(lambda: dps_quant.dps_quant_wire(*args, backend="kernel"),
                     repeats=10)
        ms_ns = time_ms(lambda: dps_quant.dps_quant_wire(
            *args, compute_stats=False, backend="kernel"), repeats=10)
        plain_ms = time_ms(lambda: dps_quant.dps_quant_wire(
            *args, backend="plain"), repeats=3, warmup=1)
        extra = {}
        if isinstance(bits, dps_quant.Philox):
            # the bare pipe: nearest rounding, no statistics, the same bytes
            extra["ms_nearest_no_stats"] = time_ms(lambda: dps_quant.dps_quant_wire(
                args[0], args[1], args[2], None, compute_stats=False,
                backend="kernel"), repeats=10)
        b, by = bound(nbytes, nops)
        return row(name, "src/repro/kernels/dps_quant.py:288",
                   f"{cfg.name} {leaf_name} -> int8, {note}, statistics on "
                   "(leg 1, one launch per leaf per rank)",
                   max_abs_err=errs[key], stats_max_rel_err=rels[key], ms=ms,
                   plain_ms=plain_ms, ms_no_stats=ms_ns, **extra, bound_ms=b,
                   bound_by=by, bytes=nbytes, library_ms=None)

    # bytes: x in (4 B), wire out (1 B), <IL, FL> in, 7 stats out; K2 also
    # reads the bits (4 B)
    rows = [wire_row("dps_quant_wire_onchip_prng", dps_quant.Philox(21),
                     5 * w_in + 8 + 28, 49 * w_in,
                     "Philox bits in the kernel")]
    if operand:
        rows.insert(0, wire_row("dps_quant_wire", wbits, 9 * w_in + 8 + 28,
                                24 * w_in,
                                "a bits operand (--rounding-bits operand)"))
        del wbits
    del x
    gc.collect()
    torch.cuda.empty_cache()

    # K4 on owner 1's [n, c] view of the full tree's per-layer layout
    lay = group_layout(sizes, n_chunks=n_ranks, quantum=4096)
    c, tpc = lay.chunk, lay.chunk // 4096
    tg = torch.from_numpy(lay.tile_groups()).to(DEV)
    goff = torch.tensor(lay.offsets, dtype=torch.int64, device=DEV)
    il_g = rng.integers(1, 3, len(sizes))
    tab = torch.from_numpy(np.stack([il_g, 8 - il_g], 1).astype(np.int32)).to(DEV)
    stack = torch.randint(-128, 127, (n_ranks, lay.total), dtype=torch.int8,
                          device=DEV, generator=g)
    view = stack.view(n_ranks, n_ranks, c).transpose(0, 1)[1]
    tg1 = tg[tpc:2 * tpc]
    errs["reduce"] = check_reduce(view, tab, tg1, 4096, body="tma")
    red_bytes = n_ranks * c + 4 * c + 4 * tpc + 8 * len(sizes)
    red_ops = (2 * n_ranks + 1) * c
    red_ms = time_ms(lambda: dps_quant.dps_wire_reduce(
        view, tab, tg1, quantum=4096, backend="kernel"), repeats=10)
    red_plain = time_ms(lambda: dps_quant.dps_wire_reduce(
        view, tab, tg1, quantum=4096, backend="plain"), repeats=3, warmup=1)
    red_sum = torch_sum_ms(view)
    part = dps_quant.dps_wire_reduce(view, tab, tg1, quantum=4096,
                                     backend="kernel")
    del stack, view
    gc.collect()
    torch.cuda.empty_cache()
    b, by = bound(red_bytes, red_ops)
    k4 = row("dps_wire_reduce", "src/repro/kernels/dps_quant.py:544",
             f"{cfg.name}: [{n_ranks}, {c}] int8 (owner 1's strided view of "
             f"the [{n_ranks}, {lay.total}] stack, row stride {lay.total}) "
             f"-> fp32 [{c}], {len(sizes)} formats, quantum 4096",
             max_abs_err=errs["reduce"], ms=red_ms, plain_ms=red_plain,
             bound_ms=b, bound_by=by, bytes=red_bytes, library_ms=None,
             body="tma", torch_sum_ms=red_sum,
             torch_sum_note=TORCH_SUM_NOTE)

    # K3b on that owner's mean chunk, as leg 2 launches it (no statistics)
    src = dps_quant.GroupPhilox(31, goff, start=c)
    out = torch.empty(c, dtype=torch.int8, device=DEV)
    wk, _ = dps_quant.dps_quant_group_wire(part, tab, tg1, src, None,
                                           quantum=4096, emit_stats=False,
                                           out=out, backend="kernel")
    wp, _ = dps_quant.dps_quant_group_wire(part, tab, tg1, src, None,
                                           quantum=4096, emit_stats=False,
                                           backend="plain")
    if not torch.equal(wk, wp):
        raise AssertionError(f"K3b at {cfg.name}'s wire shape differs from "
                             "its plain version")
    errs["k3b"] = _byte_err(wk, wp)
    del wp
    if operand:
        # K3 with a bits operand on that chunk, as leg 2 launches it under
        # --rounding-bits operand
        obits = torch.randint(-2**31, 2**31, (c,), dtype=torch.int32,
                              device=DEV, generator=g)
        wk, _ = dps_quant.dps_quant_group_wire(part, tab, tg1, obits, None,
                                               quantum=4096, emit_stats=False,
                                               out=out, backend="kernel")
        wp, _ = dps_quant.dps_quant_group_wire(part, tab, tg1, obits, None,
                                               quantum=4096, emit_stats=False,
                                               backend="plain")
        if not torch.equal(wk, wp):
            raise AssertionError("K3 with a bits operand at the wire path's "
                                 "shape differs from its plain version")
        errs["k3_operand"] = _byte_err(wk, wp)
        del wp, obits
    g3_bytes = 4 * c + c + 4 * tpc + 8 * len(sizes) + 8 * len(sizes)
    g3 = lambda st: (lambda: dps_quant.dps_quant_group_wire(
        part, tab, tg1, src, None, quantum=4096, emit_stats=st, out=out,
        backend="kernel"))
    g3_ms = time_ms(g3(False), repeats=10)
    g3_clean = time_graph_ms(g3(False), repeats=10, clean=True)
    g3_stats_clean = time_graph_ms(g3(True), repeats=10, clean=True)
    per_call = {st: device_kernels(g3(st))[0] for st in (False, True)}
    if set(per_call.values()) != {1}:
        raise AssertionError(f"K3b at {cfg.name}'s chunk: {per_call} device "
                             "kernels a call (without, with statistics)")
    g3_plain = time_ms(lambda: dps_quant.dps_quant_group_wire(
        part, tab, tg1, src, None, quantum=4096, emit_stats=False,
        backend="plain"), repeats=2, warmup=1)
    b, by = bound(g3_bytes, 37 * c)
    k3b = row("dps_group_wire_encode_onchip_prng",
              "src/repro/kernels/dps_quant.py:482",
              f"{cfg.name}: one owner chunk of {c} fp32 -> int8, {len(sizes)} "
              "formats, quantum 4096, Philox per group, no statistics (leg 2)",
              max_abs_err=errs["k3b"], ms=g3_ms, ms_graph_clean=g3_clean,
              ms_graph_clean_stats=g3_stats_clean,
              kernels_a_call=per_call[False],
              kernels_a_call_stats=per_call[True], plain_ms=g3_plain,
              bound_ms=b, bound_by=by, bytes=g3_bytes, library_ms=None)
    del part, out
    gc.collect()
    torch.cuda.empty_cache()
    return rows + [k3b, k4], errs, rels


def mamba_wire_rows():
    """K2b, K4 and K3b at ``train_wire_mamba2``'s shapes: mamba2-1.3b's
    ``layers/ssm/w_in`` gradient (836,763,648 fp32, the largest leaf a
    kernel meets) and owner 1's chunk of its tree under
    ``MAMBA_WIRE["n_ranks"]`` ranks, each bit-equal to its plain version;
    the rows take that run's launches."""
    rows, errs, rels = wire_path_rows(
        get_config("mamba2_1_3b"), np.random.default_rng(3),
        ("layers", "ssm", "w_in"), operand=False, run="train_wire_mamba2",
        model="mamba2_1_3b", n_ranks=MAMBA_WIRE["n_ranks"])
    say("wire_kernels_mamba2", main_path_sum_rel=rels,
        main_path_max_abs_err=errs, tolerances=WIRE_TOLERANCES,
        main_path=[{k: r[k] for k in ("name", "shape", "ms", "plain_ms",
                                      "bound_ms", "bound_by")} for r in rows])
    return rows


def _map_shapes(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _map_shapes(v, fn) for k, v in shapes.items()}
    return fn(shapes)


def _ragged_tree(rng, n):
    """n ranks' trees of leaves that are not multiples of the quantum."""
    shapes = {"a": (7, 13), "b": (4097,), "c": {"d": (300, 5), "e": (1,)},
              "f": (2, 3, 4096)}
    return [_map_shapes(shapes, lambda s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * 0.3).to(DEV))
        for _ in range(n)]


def wire_collectives():
    """``dps_allreduce_mean_tree`` on the card, kernels vs plain versions,
    on a ragged tree over 4 ranks: scalar and per-leaf formats, nearest and
    stochastic rounding (Philox in the kernels, and a bits operand drawn on
    the card, the same words for both sides); the means bit-equal, the
    statistics exact and to SUM_RTOL.  Then ``ProcessGroupTransport`` over
    NCCL with one rank against ``StackedTransport(1)``."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.fixed_point import FixedPointFormat
    from repro_torch.dist import (ProcessGroupTransport, StackedTransport,
                                  dps_allreduce_mean_tree, psum_stats)
    rng = np.random.default_rng(4)
    n = 4
    trees = _ragged_tree(rng, n)
    G = len(tree_lib.leaves(trees[0]))
    fmts = {"scalar": FixedPointFormat.create(2, 6, DEV),
            "per_leaf": FixedPointFormat(
                torch.tensor([2, 1, 3, 2, 1, 2][:G], dtype=torch.int32, device=DEV),
                torch.tensor([6, 7, 5, 6, 7, 6][:G], dtype=torch.int32, device=DEV))}
    tr = StackedTransport(n, DEV)
    compared = {}
    for mode, onchip in (("nearest", True), ("stochastic", True),
                         ("stochastic", False)):
        for name, fmt in fmts.items():
            out = {}
            for backend in ("kernel", "plain"):
                m, st = dps_allreduce_mean_tree(trees, fmt, tr, 1234, mode=mode,
                                                backend=backend,
                                                onchip_prng=onchip)
                out[backend] = (m, psum_stats(st, tr))
            (mk, sk), (mp, sp) = out["kernel"], out["plain"]
            for a, b in zip(tree_lib.leaves(mk), tree_lib.leaves(mp)):
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    raise AssertionError(f"tree all-reduce ({name}, {mode}): "
                                         "kernel mean differs from plain")
            for f in ("count", "nonzero", "overflow", "max_abs"):
                if not torch.equal(getattr(sk, f), getattr(sp, f)):
                    raise AssertionError(f"tree all-reduce ({name}, {mode}): "
                                         f"{f} differs")
            rel = max(float(((getattr(sk, f) - getattr(sp, f)).abs()
                             / getattr(sp, f).abs().clamp(min=1e-30)).max())
                      for f in ("abs_err_sum", "rel_err_sum", "abs_sum"))
            if rel > SUM_RTOL:
                raise AssertionError(f"tree all-reduce: sums differ by {rel}")
            exact = sum(t["b"] for t in trees) / n
            src = "" if mode == "nearest" else ("/philox" if onchip else "/operand")
            compared[f"{name}/{mode}{src}"] = {
                "mean_bit_equal": True, "stats_sum_rel": rel,
                "b_max_abs_err_vs_fp32_mean": float((mk["b"] - exact).abs().max())}
    # one rank: torch.distributed (NCCL) against the stacked transport
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            one = trees[:1]
            for mode in ("nearest", "stochastic"):
                for fmt in fmts.values():
                    a, sa = dps_allreduce_mean_tree(one, fmt, ProcessGroupTransport(),
                                                    77, mode=mode)
                    b, sb = dps_allreduce_mean_tree(one, fmt, StackedTransport(1, DEV),
                                                    77, mode=mode)
                    if not all(torch.equal(x, y) for x, y in
                               zip(tree_lib.leaves(a), tree_lib.leaves(b))):
                        raise AssertionError("ProcessGroupTransport (NCCL, 1 "
                                             "rank) differs from StackedTransport(1)")
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    say("wire_collectives", ranks=n, leaves=G, compared=compared,
        nccl_one_rank_equals_stacked=True)


def _wire_step_launches(cfg, n_ranks, rounding_bits, zero_buckets=0):
    """Kernel launches a step of the int8-wire data-parallel step, per-layer
    formats, stochastic rounding: every quantizer event of the replicated
    step with the forward/backward and the raw-gradient statistics once per
    rank, the wire quantizer once per leaf per rank, K4 and the grouped
    encoder once per owner.  ``onchip``: K1b, K2b, K3b; ``operand``: K1 (a
    stacked leaf one layer at a time, as ``quantize_tree`` bounds its bits),
    K2, K3.  ``zero_buckets`` > 0: the ZeRO step over that many buckets —
    K4 and the leg-2 encode once per owner per bucket, and no
    optimizer-input snap (the norm scales keep the params leg in fp32).
    Each rank taps every block forward and backward in each of its
    ``train_accum`` microbatches."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.policy import QuantPolicy
    defs = registry(cfg.family).model_defs(cfg, cfg.master_dtype())
    pred = QuantPolicy().param_predicate()
    paths = tree_lib.leaves_with_path(defs)
    G = len(paths)
    taps = 2 * registry(cfg.family).residual_taps(cfg) * cfg.train_accum
    quantized = [d.shape for p, d in paths if pred(p, d)]
    if rounding_bits == "onchip":
        events = len(quantized)
    else:
        events = sum(s[0] if len(s) >= 3 and s[0] > 4 and math.prod(s) > 1 << 22
                     else 1 for s in quantized)
    sfx = "_onchip_prng" if rounding_bits == "onchip" else ""
    out = {k: 0 for k in ("dps_quantize", "dps_quantize_onchip_prng",
                          "dps_quant_wire", "dps_quant_wire_onchip_prng",
                          "dps_group_wire_encode",
                          "dps_group_wire_encode_onchip_prng")}
    snaps, owners = (2, n_ranks * zero_buckets) if zero_buckets else (3, n_ranks)
    out.update({"dps_quantize" + sfx: snaps * events + n_ranks * (taps + events),
                "dps_quant_wire" + sfx: n_ranks * G,
                "dps_group_wire_encode" + sfx: owners,
                "dps_wire_reduce": owners})
    return out


def _all_k4_on_tma(launches, what):
    """Every K4 launch of a full-width run took the TMA body."""
    k4, tma = launches["dps_wire_reduce"], dps_quant.reduce_tma_launch_count
    if k4 < 1 or tma != k4:
        raise AssertionError(f"{what}: {tma} of {k4} K4 launches took the "
                             "TMA body")


def wire_argv(steps=4, n_ranks=4, rounding_bits="onchip", *extra,
              model="llama3_2_3b", batch=None):
    """``launch.train`` arguments of the full-width int8-wire run (``batch``:
    one row a rank unless given)."""
    return ["--arch", model, "--steps", str(steps), "--batch",
            str(batch or n_ranks), "--seq", "512", "--optimizer", "sgd",
            "--grad-allreduce-bits", "8", "--data-ranks", str(n_ranks),
            "--rounding-bits", rounding_bits, "--log-every", "1", *extra]


def train_wire(cfg, steps=4, n_ranks=4, rounding_bits="onchip",
               model="llama3_2_3b", batch=None, phase="wire_train"):
    """The int8-wire data-parallel trainer's CLI at full size: n_ranks ranks
    on the card, batch 1 x 512 each (``batch``: rows in all), per-layer wire
    formats; K1b/K2b/K3b/K4, or K1/K2/K3/K4 with
    ``rounding_bits="operand"``.  ``cfg`` is ``model``'s config.
    Returns the launches, the losses and the CLI's summary."""
    from repro_torch.launch import train as train_cli
    argv = wire_argv(steps, n_ranks, rounding_bits, model=model, batch=batch)
    train_cli.reset_launch_counts()            # the counted run
    dps_quant.reduce_tma_launch_count = 0
    out = train_cli.main(argv)
    launches = train_cli.launch_counts()
    _all_k4_on_tma(launches, "wire training")
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if len(hist) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"wire training: losses {losses}")
    if not out["wire_sync"]:
        raise AssertionError("wire training: the int8 wire did not engage")
    want = _wire_step_launches(cfg, n_ranks, rounding_bits)
    per_step = [h["kernel_launches"] for h in hist]
    if per_step != [want] * steps or launches != {k: v * steps
                                                 for k, v in want.items()}:
        raise AssertionError(f"wire training: launches {per_step} a step, "
                             f"wanted {want}")
    keys = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g", "il_wire_grads",
            "fl_wire_grads", "il_wire_grads_min", "il_wire_grads_max",
            "fl_wire_grads_min", "fl_wire_grads_max", "E_wire", "R_wire")
    traj = [{k: h[k] for k in keys} for h in hist]
    say(phase, command="python -m repro_torch.launch.train " + " ".join(argv),
        params=out["params"], data_ranks=n_ranks, rounding_bits=rounding_bits,
        accumulation=cfg.train_accum,
        losses=losses,
        first_step_s=out["first_step_s"],
        ms_per_step_after_first=out["ms_per_step_after_first"],
        tokens_per_s_after_first=out["tokens_per_s_after_first"],
        peak_memory_bytes=out["peak_memory_bytes"], formats=traj,
        launches=launches, launches_per_step=want,
        k4_tma_launches=dps_quant.reduce_tma_launch_count,
        E_wire=out["E_wire"], R_wire=out["R_wire"])
    gc.collect()
    torch.cuda.empty_cache()
    return launches, losses, out


# ---------------------------------------------------------------------------
# ZeRO-1 and the overlapped bucketed wire
# ---------------------------------------------------------------------------

# The full-width ZeRO runs' losses after the first step, against the wire
# run's.  Step 1 is the same forward on the same parameters (equal bit for
# bit).  Later steps start from parameters that differ in some elements:
# the wire step's stochastic optimizer-input snap of its mean, which a ZeRO
# step with an fp32 params leg skips (as the reference's does), bumps a
# large on-grid value by one gradient grid step now and then (floor(k + u)
# in fp32 rounds up when k is large and u near 1), and the embedding's
# backward sums with atomics on the card.  Each moves a few weights by a
# grid step.  Measured on an H100: 1.03e-4 relative at worst over 3 steps,
# the two ZeRO runs (with and without the overlap) bit-equal to each other.
ZERO_LOSS_RTOL = 1e-3


def _same_stats(sk, sp, what):
    """QuantStats kernel vs plain: count/nonzero/overflow/max_abs exact,
    float sums to SUM_RTOL; returns the largest relative sum difference."""
    for f in ("count", "nonzero", "overflow", "max_abs"):
        if not torch.equal(getattr(sk, f), getattr(sp, f)):
            raise AssertionError(f"{what}: {f} differs from the plain version")
    rel = max(float(((getattr(sk, f) - getattr(sp, f)).abs()
                     / getattr(sp, f).abs().clamp(min=1e-30)).max())
              for f in ("abs_err_sum", "rel_err_sum", "abs_sum"))
    if rel > SUM_RTOL:
        raise AssertionError(f"{what}: float sums differ by {rel:.3g}")
    return rel


def _bit_equal(a, b, what):
    if a.shape != b.shape or not torch.equal(a.contiguous().view(torch.int32),
                                             b.contiguous().view(torch.int32)):
        raise AssertionError(f"{what}: kernel result differs from plain")


def zero_collectives():
    """The ZeRO halves and the bucketed all-reduce on the card, kernels vs
    plain versions, on the ragged 4-rank tree of ``wire_collectives``:
    scalar and per-leaf formats, nearest rounding and stochastic with
    Philox bits in the kernels and with a bits operand.  Results bit-equal,
    statistics exact and to SUM_RTOL; each owner's reduce-scatter shard
    bit-equal to its chunk of the monolithic all-reduce's mean; the
    bucketed all-reduce bit-equal to the monolithic one."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.fixed_point import FixedPointFormat
    from repro_torch.dist import (GroupAlignedPartitioner, StackedTransport,
                                  ZeroPartitioner, bucketed_allreduce_mean_tree,
                                  dps_allgather_params, dps_allreduce_mean_tree,
                                  dps_reduce_scatter_mean, psum_stats,
                                  zero_allgather_params,
                                  zero_bucketed_reduce_scatter)
    rng = np.random.default_rng(4)
    n = 4
    trees = _ragged_tree(rng, n)
    G = len(tree_lib.leaves(trees[0]))
    fmts = {"scalar": FixedPointFormat.create(2, 6, DEV),
            "per_leaf": FixedPointFormat(
                torch.tensor([2, 1, 3, 2, 1, 2][:G], dtype=torch.int32, device=DEV),
                torch.tensor([6, 7, 5, 6, 7, 6][:G], dtype=torch.int32, device=DEV))}
    tr = StackedTransport(n, DEV)
    parts = {"one_bucket": GroupAlignedPartitioner.create(trees[0], n),
             "bucket_per_leaf": GroupAlignedPartitioner.create(
                 trees[0], n, buckets=[(g,) for g in range(G)])}
    plain = ZeroPartitioner.create(trees[0], n)
    backends = ("kernel", "plain")
    compared = {}
    for mode, onchip in (("nearest", True), ("stochastic", True),
                         ("stochastic", False)):
        kw = dict(mode=mode, onchip_prng=onchip)
        src = "" if mode == "nearest" else ("/philox" if onchip else "/operand")
        for name, fmt in fmts.items():
            what = f"{name}/{mode}{src}"
            rels = []
            mean, _ = dps_allreduce_mean_tree(trees, fmt, tr, 1234,
                                              backend="kernel", **kw)
            bk = {be: bucketed_allreduce_mean_tree(
                trees, fmt, tr, 1234, backend=be, target_elems=5000, **kw)
                for be in backends}
            for a, b, m in zip(tree_lib.leaves(bk["kernel"][0]),
                               tree_lib.leaves(bk["plain"][0]),
                               tree_lib.leaves(mean)):
                _bit_equal(a, b, f"bucketed all-reduce ({what})")
                _bit_equal(a, m, f"bucketed vs monolithic all-reduce ({what})")
            rels.append(_same_stats(psum_stats(bk["kernel"][1], tr),
                                    psum_stats(bk["plain"][1], tr),
                                    f"bucketed all-reduce ({what})"))
            for pname, part in parts.items():
                zs = {be: zero_bucketed_reduce_scatter(
                    trees, fmt, tr, 1234, part=part, backend=be, **kw)
                    for be in backends}
                _bit_equal(zs["kernel"][0], zs["plain"][0],
                           f"zero reduce-scatter ({what}, {pname})")
                rels.append(_same_stats(psum_stats(zs["kernel"][1], tr),
                                        psum_stats(zs["plain"][1], tr),
                                        f"zero reduce-scatter ({what})"))
                flat = part.flatten(mean)
                for j in range(n):
                    _bit_equal(zs["kernel"][0][j], part.shard(flat, j),
                               f"owner {j}'s shard vs its chunk of the mean "
                               f"({what}, {pname})")
                # the params leg: K3/K3b with statistics and the owner's
                # chunk of the mask, one launch per bucket per owner
                shards = list(zs["kernel"][0])
                ag = {be: zero_allgather_params(shards, fmt, tr, 77, part=part,
                                                backend=be, **kw)
                      for be in backends}
                _bit_equal(ag["kernel"][0], ag["plain"][0],
                           f"zero params all-gather ({what}, {pname})")
                rels.append(_same_stats(psum_stats(ag["kernel"][1], tr),
                                        psum_stats(ag["plain"][1], tr),
                                        f"zero params all-gather ({what})"))
            if name == "scalar":
                xs = [plain.flatten(t) for t in trees]
                rs = {be: dps_reduce_scatter_mean(xs, fmt, tr, 1234,
                                                  backend=be, **kw)
                      for be in backends}
                _bit_equal(rs["kernel"][0], rs["plain"][0],
                           f"dps_reduce_scatter_mean ({what})")
                rels.append(_same_stats(psum_stats(rs["kernel"][1], tr),
                                        psum_stats(rs["plain"][1], tr),
                                        f"dps_reduce_scatter_mean ({what})"))
                agp = {be: dps_allgather_params(list(rs["kernel"][0]), fmt, tr,
                                                77, backend=be, **kw)
                       for be in backends}
                _bit_equal(agp["kernel"][0], agp["plain"][0],
                           f"dps_allgather_params ({what})")
                rels.append(_same_stats(psum_stats(agp["kernel"][1], tr),
                                        psum_stats(agp["plain"][1], tr),
                                        f"dps_allgather_params ({what})"))
            compared[what] = {"bit_equal": True, "stats_sum_rel": max(rels)}
    torch.cuda.synchronize()
    say("zero_collectives", ranks=n, leaves=G, compared=compared,
        owner_shards_equal_allreduce_chunks=True,
        bucketed_equals_monolithic=True,
        buckets={k: p.n_buckets for k, p in parts.items()})


def _w_in_bucket(cfg, n):
    """The w_in leaf's bucket of the partitioner ``launch.train --zero-opt
    --wire-overlap on`` builds over ``n`` ranks: (leaf paths, partitioner,
    w_in's leaf, bucket, its leaf range, its layout, its leaves' formats)."""
    from repro_torch.core import qtrain
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.fixed_point import FixedPointFormat
    from repro_torch.models import transformer
    defs = transformer.model_defs(cfg, cfg.master_dtype())
    paths = [p for p, _ in tree_lib.leaves_with_path(defs)]
    qcfg = dataclasses.replace(
        qtrain.QuantConfig(grad_allreduce_bits=8, wire_overlap=True)
        .with_per_layer_wire(defs), zero_opt_shards=n)
    part = qtrain.zero_partitioner(qcfg, defs, n)
    leaf = paths.index(("layers", "mlp", "w_in"))
    b = next(b for b in range(part.n_buckets)
             if part.leaf_range(b)[0] <= leaf < part.leaf_range(b)[1])
    lo, hi = part.leaf_range(b)
    rng = np.random.default_rng(15)
    il = rng.integers(1, 3, len(paths))        # the wire settles at <1, 7>
    fmt = FixedPointFormat(torch.tensor(il[lo:hi], dtype=torch.int32, device=DEV),
                           torch.tensor(8 - il[lo:hi], dtype=torch.int32,
                                        device=DEV))
    return defs, paths, part, leaf, b, (lo, hi), part.layouts[b], fmt


def _zero_bucket_k3b(cfg, mean, n=4, j=1, seed=1234, backend="kernel",
                     out=None):
    """Owner ``j``'s leg-2 snap at the w_in bucket, as ``_owner_rs_snap``
    launches it: K3b (Philox keyed by the bucket's global groups, no
    statistics) on ``mean``, the owner's fp32 mean chunk, through the
    kernel's wrapper with the bucket's format table built once (the path
    stacks it from the format each call: a second, small kernel)."""
    from repro_torch.core.fixed_point import fold_seed
    from repro_torch.dist.collectives import (LEG2, _aligned_bits,
                                              _layout_tables)
    from repro_torch.kernels.ops import format_table
    _, _, _, _, _, (lo, _), lay, fmt = _w_in_bucket(cfg, n)
    c, q = lay.chunk, lay.quantum
    tpc = c // q
    tg_all, goff = _layout_tables(lay, str(DEV))
    bits = _aligned_bits(fold_seed(seed, LEG2), lay, goff, j * c, c,
                         onchip_prng=True, group_base=lo)
    tab, tg = format_table(fmt), tg_all[j * tpc:(j + 1) * tpc]
    return lambda: dps_quant.dps_quant_group_wire(
        mean, tab, tg, bits, None, quantum=q, emit_stats=False, out=out,
        backend=backend)


def zero_bucket_k3b_kernels(cfg, n=4):
    """The device kernels a call of the w_in bucket's leg-2 K3b
    (``torch.profiler``), read on a random mean chunk at the plan the
    overlap path's call takes.  Read here, early in the process: a profiler
    session ~805 s into the call recorded no device event (PERF.md §7), and
    the count depends on the launch's plan alone (``group_plan``: shape,
    dtype, source, statistics, alignment), which ``zero_bucket_check``
    holds its own call to.  Returns (kernels a call, the plan)."""
    lay = _w_in_bucket(cfg, n)[6]
    gen = torch.Generator(device=DEV).manual_seed(16)
    mean = torch.randn(lay.chunk, generator=gen, device=DEV) * 0.02
    out = torch.empty(lay.chunk, dtype=torch.int8, device=DEV)
    calls = device_kernels(_zero_bucket_k3b(cfg, mean, n, out=out))[0]
    plan = _zero_bucket_plan(cfg, n, mean, out)
    del mean, out
    gc.collect()
    torch.cuda.empty_cache()
    if calls != 1:
        raise AssertionError(f"K3b at the w_in bucket: {calls} device "
                             "kernels a call")
    say("zero_bucket_k3b_kernels", kernels_a_call=calls, plan=str(plan))
    return calls, plan


def _zero_bucket_plan(cfg, n, mean, out):
    """The plan of the w_in bucket's leg-2 K3b on ``mean`` into ``out``."""
    _, _, _, _, _, (lo, hi), lay, _ = _w_in_bucket(cfg, n)
    aligned = mean.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return dps_quant.group_plan(lay.chunk // lay.quantum, lay.quantum, hi - lo,
                                4, 2, False, aligned)


def zero_bucket_check(cfg, k3b_kernels, n=4):
    """The overlap path's largest bucket at full width, kernels vs plain: the
    w_in leaf's bucket of the partitioner ``launch.train --zero-opt
    --wire-overlap on`` builds (a bucket of its own, global leaf 7, so its
    bits are keyed by a nonzero group base).  Each of 4 ranks encodes its
    gradient into the bucket (K2b), then ``TreeAllReduce(layout=...)
    .scatter_snap`` runs K4 and the leg-2 snap (K3b) on every owner's
    [4, chunk] and ``decode_owned`` decodes each owner's chunk, as the train
    step does per bucket.  Leg-2 bytes, decoded shards and owner 1's K4
    mean bit-equal; leg-1 statistics exact and to SUM_RTOL.  Returns the K4
    and K3b rows at this shape (launches: every per-bucket launch of the
    overlap run); the K3b row's device kernels a call are
    ``k3b_kernels``, :func:`zero_bucket_k3b_kernels`'s reading, whose plan
    this call must take."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.dist import StackedTransport, TreeAllReduce, psum_stats
    from repro_torch.dist.collectives import _layout_tables, _wire_reduce
    defs, paths, part, leaf, b, (lo, hi), lay, fmt = _w_in_bucket(cfg, n)
    shapes = [tuple(d.shape) for d in tree_lib.leaves(defs)[lo:hi]]
    tr = StackedTransport(n, DEV)
    seed = 1234

    def grad(r, g):
        gen = torch.Generator(device=DEV).manual_seed(100 * r + g)
        x = torch.randn(shapes[g], generator=gen, device=DEV) * 0.02
        x.view(-1)[::11] = 0.0
        return x

    like = [torch.empty((), device=DEV).expand(s) for s in shapes]
    runs, received = {}, None
    for be in ("kernel", "plain"):
        tw = TreeAllReduce(like, fmt, tr, seed, backend=be, group_base=lo,
                           layout=lay)
        for r in range(n):
            for g in range(hi - lo):
                tw.encode_leaf(r, g, grad(r, g))
        if be == "kernel":
            received = tr.all_to_all(tw.payload)     # kept for the timing
        stats = psum_stats(tw.stats, tr)
        wire2 = tw.scatter_snap()
        dec = [tw.decode_owned(i) for i in range(n)]
        runs[be] = (stats, wire2, dec)
        del tw
    torch.cuda.synchronize()
    (sk, wk, dk), (sp, wp, dp) = runs["kernel"], runs["plain"]
    rel = _same_stats(sk, sp, "w_in bucket leg 1")
    if not torch.equal(wk, wp):
        raise AssertionError("w_in bucket leg 2: kernel bytes differ from plain")
    k3b_err = _byte_err(wk, wp)
    for i in range(n):
        _bit_equal(dk[i], dp[i], f"w_in bucket, owner {i}'s decoded shard")
    del runs, wk, wp, dk, dp
    gc.collect()
    torch.cuda.empty_cache()

    # K4 and K3b on owner 1's [4, chunk] view, as _owner_rs_snap calls them
    c, q, j = lay.chunk, lay.quantum, 1
    tpc = c // q
    tg1 = _layout_tables(lay, str(DEV))[0][j * tpc:(j + 1) * tpc]
    view = received[j]
    if _reduce_body(view, q) != "tma":
        raise AssertionError("w_in bucket: K4 planned off the TMA body")
    tma0 = dps_quant.reduce_tma_launch_count
    mk = _wire_reduce(view, fmt, tg1, backend="kernel", quantum=q)
    if dps_quant.reduce_tma_launch_count != tma0 + 1:
        raise AssertionError("w_in bucket: K4 did not take the TMA body")
    mp = _wire_reduce(view, fmt, tg1, backend="plain", quantum=q)
    _bit_equal(mk, mp, "w_in bucket, owner 1's K4 mean")
    k4_err = float((mk - mp).abs().max())
    del mp
    red_ms = time_ms(lambda: _wire_reduce(view, fmt, tg1, backend="kernel",
                                          quantum=q), repeats=10)
    red_plain = time_ms(lambda: _wire_reduce(view, fmt, tg1, backend="plain",
                                             quantum=q), repeats=3, warmup=1)
    red_sum = torch_sum_ms(view)
    out = torch.empty(c, dtype=torch.int8, device=DEV)
    g3_calls, plan = k3b_kernels
    if _zero_bucket_plan(cfg, n, mk, out) != plan:
        raise AssertionError("w_in bucket: K3b planned off the plan whose "
                             "device kernels were read")
    g3 = _zero_bucket_k3b(cfg, mk, n, j, seed, out=out)
    g3_ms = time_ms(g3, repeats=10)
    g3_clean = time_graph_ms(g3, repeats=10, clean=True)
    g3_plain = time_ms(_zero_bucket_k3b(cfg, mk, n, j, seed, backend="plain"),
                       repeats=2, warmup=1)
    G = hi - lo
    red_bytes = n * c + 4 * c + 4 * tpc + 8 * G
    g3_bytes = 4 * c + c + 4 * tpc + 8 * G + 8 * G
    del received, view, mk, out
    gc.collect()
    torch.cuda.empty_cache()
    shape = (f"the w_in bucket of the overlap run (bucket {b}, leaf {lo}, "
             f"{n} owners x chunk {c}, quantum {q})")
    note = ("launches: every per-bucket launch of the --zero-opt --wire-overlap "
            f"on run, {part.n_buckets} buckets x {n} owners a step; the other "
            "buckets' chunks are smaller")
    b4, by4 = bound(red_bytes, (2 * n + 1) * c)
    b3, by3 = bound(g3_bytes, 37 * c)
    common = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/dps_quant.cu",
              "run": "zero_overlap", "launches_note": note, "library_ms": None}
    rows = [
        {"name": "dps_wire_reduce_zero_bucket", "counter": "dps_wire_reduce",
         "replaces": "src/repro/kernels/dps_quant.py:544",
         "shape": f"[{n}, {c}] int8 (owner {j}'s strided view) -> fp32 [{c}], "
                  f"{shape}", "max_abs_err": k4_err, "ms": red_ms,
         "plain_ms": red_plain, "bound_ms": b4, "bound_by": by4,
         "bytes": red_bytes, "body": "tma", "torch_sum_ms": red_sum,
         "torch_sum_note": TORCH_SUM_NOTE, **common},
        {"name": "dps_group_wire_encode_onchip_prng_zero_bucket",
         "counter": "dps_group_wire_encode_onchip_prng",
         "replaces": "src/repro/kernels/dps_quant.py:482",
         "shape": f"owner {j}'s mean chunk of {c} fp32 -> int8, Philox keyed "
                  f"by global group {lo}, no statistics (leg 2), {shape}",
         "max_abs_err": k3b_err, "ms": g3_ms, "ms_graph_clean": g3_clean,
         "kernels_a_call": g3_calls,
         "kernels_a_call_note": "torch.profiler, at this call's plan on a "
                                "random mean chunk, after the wire phase",
         "plain_ms": g3_plain, "bound_ms": b3, "bound_by": by3,
         "bytes": g3_bytes, **common}]
    say("zero_bucket", bucket=b, group_base=lo, leaf="/".join(paths[leaf]),
        owners=n, chunk=c, quantum=q, leg2_bit_equal=True,
        decoded_shards_bit_equal=True, k4_mean_bit_equal=True,
        leg1_stats_sum_rel=rel, tolerance_sums=SUM_RTOL,
        rows=[{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms")}
              for r in rows])
    return rows


def k4_buckets(cfg, n=4):
    """K4 at every bucket of the overlap run (``launch.train --zero-opt
    --wire-overlap on``: the partitioner's 11 bucket layouts): owner 1's
    [4, chunk] strided view of a random [4, 4 chunk] stack, the bucket's
    tile map and a table of its leaves' formats; kernel vs plain bit-equal
    on the TMA body, the time replayed from a CUDA graph beside the bound.
    Returns the rows and the sum over buckets x owners (K4 a step)."""
    from repro_torch.core import qtrain
    from repro_torch.models import transformer
    defs = transformer.model_defs(cfg, cfg.master_dtype())
    qcfg = dataclasses.replace(
        qtrain.QuantConfig(grad_allreduce_bits=8, wire_overlap=True)
        .with_per_layer_wire(defs), zero_opt_shards=n)
    part = qtrain.zero_partitioner(qcfg, defs, n)
    g = torch.Generator(device=DEV).manual_seed(16)
    rows = []
    for b in range(part.n_buckets):
        lo, hi = part.leaf_range(b)
        lay = part.layouts[b]
        c, q = lay.chunk, lay.quantum
        tpc = c // q
        tg = torch.from_numpy(lay.tile_groups()[tpc:2 * tpc]).to(DEV)
        G = hi - lo
        il = torch.randint(1, 3, (G,), device=DEV, generator=g)
        tab = torch.stack([il, 8 - il], 1).to(torch.int32).contiguous()
        stack = torch.randint(-128, 128, (n, n * c), dtype=torch.int8,
                              device=DEV, generator=g)
        view = stack.view(n, n, c).transpose(0, 1)[1]
        err = check_reduce(view, tab, tg, q, body="tma")
        ms = time_graph_ms(lambda: dps_quant.dps_wire_reduce(
            view, tab, tg, quantum=q, backend="kernel"),
            100 if c < 1 << 24 else 20)
        nbytes = n * c + 4 * c + 4 * tpc + 8 * G
        bnd, by = bound(nbytes, (2 * n + 1) * c)
        rows.append({"bucket": b, "leaves": [lo, hi], "chunk": c,
                     "ms": ms, "bound_ms": bnd, "bound_by": by,
                     "share_of_bound": bnd / ms, "max_abs_err": err})
        del stack, view
        torch.cuda.empty_cache()
    step_ms = n * sum(r["ms"] for r in rows)
    say("k4_buckets", owners=n, buckets=rows, k4_ms_a_step=step_ms,
        k4_bound_ms_a_step=n * sum(r["bound_ms"] for r in rows),
        timing="CUDA-graph replay, L2 flushed before each",
        tolerance="bit-equal")
    return rows, step_ms


def lenet_zero(steps=3):
    """LeNet over 4 stacked ranks with ZeRO-1, per-layer wire formats and
    every leaf quantized, so the parameter all-gather rides the int8 wire
    (K3 with statistics and a mask on each owner's chunk): kernel vs plain
    under nearest rounding, formats equal step by step, loss to
    LENET_LOSS_RTOL.  Returns the kernel run's launches."""
    from repro_torch.apps import mnist as app
    from repro_torch.core import qtrain
    from repro_torch.data import MNISTLike
    from repro_torch.dist import StackedTransport
    from repro_torch.launch import train as train_cli
    from repro_torch.models import lenet as lenet_mod
    from repro_torch.optim import SGDConfig, make_optimizer
    data = MNISTLike(batch=64, seed=0, n_train=2048, n_test=512)
    keys = ("loss", "il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g",
            "il_wire_grads", "fl_wire_grads", "il_wire_params",
            "fl_wire_params", "E_wire", "R_wire")
    runs, launches = {}, None
    for backend in ("kernel", "plain"):
        with app._full_fp32(DEV):
            params = lenet_mod.init(0, DEV)
            q = dataclasses.replace(
                app.paper_quant_config(rounding="nearest"), onchip_prng=False,
                backend=backend, grad_allreduce_bits=8,
                zero_opt_shards=4).with_per_layer_wire(params)
            opt = make_optimizer(SGDConfig())
            tr = StackedTransport(4, DEV)
            step = qtrain.make_train_step(lenet_mod.loss_fn, opt, q,
                                          transport=tr)
            if not (step.zero_opt_active and step.zero_groupaligned_active
                    and qtrain.wire_params_engaged(q, params, tr)):
                raise AssertionError("LeNet ZeRO: the int8 params leg did not "
                                     "engage")
            state = qtrain.TrainState.create(
                params, qtrain.zero_opt_state(opt, params, tr, q), q, 1, DEV)
            hist = {k: [] for k in keys}
            train_cli.reset_launch_counts()
            for i in range(steps):
                b = {k: torch.from_numpy(v).to(DEV)
                     for k, v in data.train_batch(i).items()}
                state, m = step(state, b)
                for k in keys:
                    hist[k].append(float(m[k]))
            torch.cuda.synchronize()
            if backend == "kernel":
                launches = train_cli.launch_counts()
            runs[backend] = hist
    for k in keys[1:-2]:
        if runs["kernel"][k] != runs["plain"][k]:
            raise AssertionError(f"LeNet ZeRO kernel vs plain: {k} "
                                 f"{runs['kernel'][k]} vs {runs['plain'][k]}")
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in
                   zip(runs["kernel"]["loss"], runs["plain"]["loss"]))
    if loss_rel > LENET_LOSS_RTOL:
        raise AssertionError(f"LeNet ZeRO kernel vs plain: loss differs by "
                             f"{loss_rel:.3g} relative")
    # per step: K1 8 weights + 8 re-snaps + 4 ranks x (4 taps forward and
    # backward, the logit gradient, 8 raw-gradient leaves) + the flat
    # optimizer-input snap of 4 owners; K2 4 x 8 leaves; K4 4 owners; K3 4
    # leg-2 chunks + 4 params-leg chunks (one bucket)
    want = {k: 0 for k in launches}
    want.update({"dps_quantize": 88 * steps, "dps_quant_wire": 32 * steps,
                 "dps_wire_reduce": 4 * steps,
                 "dps_group_wire_encode": 8 * steps})
    if launches != want:
        raise AssertionError(f"LeNet ZeRO: launches {launches}, wanted {want}")
    say("lenet_zero", steps=steps, ranks=4, launches=launches,
        kernel=runs["kernel"], loss_max_rel_vs_plain=loss_rel,
        tolerance=LENET_LOSS_RTOL, formats_equal=True)
    return launches


def train_zero(cfg, wire_first_loss, overlap, steps=4, n_ranks=4):
    """``launch.train --zero-opt [--wire-overlap on]`` at full size: 4
    ranks on the card, per-layer wire formats, SGD; ZeRO (and the overlap)
    engaged, finite losses, the first equal to the wire run's, launches a
    step as the CPU rehearsal counts them."""
    from repro_torch.dist import plan_buckets
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer
    from repro_torch.core import tree as tree_lib
    argv = zero_argv(overlap, steps=steps, n_ranks=n_ranks)
    train_cli.reset_launch_counts()            # the counted run
    dps_quant.reduce_tma_launch_count = 0
    out = train_cli.main(argv)
    launches = train_cli.launch_counts()
    _all_k4_on_tma(launches, "ZeRO training")
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if len(hist) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"ZeRO training: losses {losses}")
    if not (out["zero_opt"] and out["zero_groupaligned"]
            and out["wire_overlap"] == overlap):
        raise AssertionError(f"ZeRO training: zero_opt {out['zero_opt']}, "
                             f"wire_overlap {out['wire_overlap']}")
    if losses[0] != wire_first_loss:
        raise AssertionError(f"ZeRO training: step-1 loss {losses[0]!r} is "
                             f"not the wire run's {wire_first_loss!r}")
    defs = transformer.model_defs(cfg, cfg.master_dtype())
    buckets = (plan_buckets([math.prod(d.shape) for d in
                             tree_lib.leaves(defs)]).n_buckets
               if overlap else 1)
    if out["wire_buckets"] != buckets:
        raise AssertionError(f"ZeRO training: {out['wire_buckets']} buckets, "
                             f"wanted {buckets}")
    want = _wire_step_launches(cfg, n_ranks, "onchip", zero_buckets=buckets)
    per_step = [h["kernel_launches"] for h in hist]
    if per_step != [want] * steps or launches != {k: v * steps
                                                 for k, v in want.items()}:
        raise AssertionError(f"ZeRO training: launches {per_step} a step, "
                             f"wanted {want}")
    say("zero_train", command="python -m repro_torch.launch.train " + " ".join(argv),
        params=out["params"], data_ranks=n_ranks, overlap=overlap,
        buckets=buckets, losses=losses,
        wire_run_losses_first=wire_first_loss,
        first_step_s=out["first_step_s"],
        ms_per_step_after_first=out["ms_per_step_after_first"],
        tokens_per_s_after_first=out["tokens_per_s_after_first"],
        peak_memory_bytes=out["peak_memory_bytes"], launches=launches,
        launches_per_step=want,
        k4_tma_launches=dps_quant.reduce_tma_launch_count,
        E_wire=out["E_wire"], R_wire=out["R_wire"],
        formats=[{k: h[k] for k in ("il_w", "fl_w", "il_g", "fl_g",
                                    "il_wire_grads", "fl_wire_grads")}
                 for h in hist])
    summary = {k: out[k] for k in ("ms_per_step_after_first",
                                   "peak_memory_bytes")}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return launches, hist, summary


def zero_argv(overlap, *extra, steps=4, n_ranks=4):
    """``launch.train`` arguments of the full-width ZeRO-1 run."""
    argv = ["--arch", "llama3_2_3b", "--steps", str(steps), "--batch",
            str(n_ranks), "--seq", "512", "--optimizer", "sgd",
            "--grad-allreduce-bits", "8", "--data-ranks", str(n_ranks),
            "--zero-opt", "--log-every", "1"]
    return argv + (["--wire-overlap", "on"] if overlap else []) + list(extra)


# ---------------------------------------------------------------------------
# Checkpoint and resume, the health guards and the fault drills
# ---------------------------------------------------------------------------

# the launch counters of the int8 wire's kernels: 0 on a degraded step
WIRE_KERNELS = ("dps_quant_wire_onchip_prng", "dps_wire_reduce",
                "dps_group_wire_encode_onchip_prng")
# ckpt_resume's depth: llama3.2-3b at full width, 4 of its 28 layers (797 M
# parameters, a 6.4 GB state).  Its checks (every metric and every digest
# bit-equal) hold at any depth; the whole model's 25.7 GB state took
# 190-250 s of the call in its three saves, verify and restore, bound by
# the host's disk (0.44-1.4 GB/s on an H100's host)
CKPT_LAYERS = 4


def ckpt_space(cfg):
    """A fresh directory under ``build/`` (git-ignored) for ``cfg``'s
    checkpoints, after checking that its disk holds one SGD wire state (fp32
    parameters and momenta, 8 bytes a parameter) and a margin: one exists
    at a time — run A's arrays are deleted once its manifest is read, run
    B's step 2 once B′ has restored it — so the phase's disk footprint
    stays at one state.  Returns ``(dir, free bytes)``."""
    base = os.path.join(ROOT, "build")
    os.makedirs(base, exist_ok=True)
    free = shutil.disk_usage(base).free
    need = 8 * cfg.n_params() + (4 << 30)
    if free < need:
        raise AssertionError(f"ckpt_resume: {free} bytes free under {base}, "
                             f"the phase needs {need}")
    return tempfile.mkdtemp(prefix="ckpt_", dir=base), free


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def _rate(nbytes, seconds):
    return nbytes / seconds / 1e9 if seconds else None


def ckpt_resume():
    """On llama3.2-3b at full width cut to ``CKPT_LAYERS``: run A (the wire
    run's argv, its checkpoint at step 4), run B (the same with
    ``--sigterm-at 2``: a real SIGTERM, ``PREEMPTED``, a checkpoint at step
    2) and run B′ (``--resume`` to step 4): B's steps 0-1 and B′'s steps
    2-3 bit-equal to A's in every metric, and B′'s step-4 manifest's
    digests equal to A's for every key — the whole state.  One full state
    is on the disk at a time (``ckpt_space``)."""
    cfg = depth_cut("llama3_2_3b", CKPT_LAYERS)
    root, free = ckpt_space(cfg)
    try:
        _ckpt_resume(cfg, root, free)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def _ckpt_resume(cfg, root, free):
    from repro_torch.launch import train as train_cli
    a_dir, b_dir = os.path.join(root, "a"), os.path.join(root, "b")
    t0 = time.perf_counter()
    run_a = train_cli.main(wire_argv(4, 4, "onchip", "--ckpt-dir", a_dir),
                           cfg=cfg)
    a_s = time.perf_counter() - t0
    losses = [h["loss"] for h in run_a["history"]]
    if len(losses) != 4 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"ckpt_resume: run A's losses {losses}")
    step_a = os.path.join(a_dir, "step_00000004")
    ma = _manifest(a_dir, 4)
    disk = sum(os.path.getsize(os.path.join(step_a, f))
               for f in os.listdir(step_a))
    # A's digests are all the comparison needs: its arrays make room
    os.remove(os.path.join(step_a, "arrays.npz"))
    t0 = time.perf_counter()
    b = train_cli.main(wire_argv(4, 4, "onchip", "--ckpt-dir", b_dir,
                                 "--sigterm-at", "2"), cfg=cfg)
    b_s = time.perf_counter() - t0
    if b.get("preempted_at") != 2 or os.listdir(b_dir) != ["step_00000002"]:
        raise AssertionError(f"ckpt_resume: run B was not preempted at step "
                             f"2 ({b.get('preempted_at')}, {os.listdir(b_dir)})")
    hist_a = run_a["history"]
    if b["history"] != hist_a[:2]:
        raise AssertionError("ckpt_resume: run B's steps 0-1 differ from A's")
    step_b = os.path.join(b_dir, "step_00000002")

    def drop_b(step, state):
        # B′ restored step 2 before its first step: its arrays make room
        # for B′'s step-4 save (one full state on the disk at a time)
        if step == 2:
            os.remove(os.path.join(step_b, "arrays.npz"))

    t0 = time.perf_counter()
    b2 = train_cli.main(wire_argv(4, 4, "onchip", "--ckpt-dir", b_dir,
                                  "--resume"), on_step=drop_b, cfg=cfg)
    b2_s = time.perf_counter() - t0
    res = b2["resumed"]
    if res is None or res.get("step") != 2:
        raise AssertionError(f"ckpt_resume: run B′ resumed from {res}")
    if b2["history"] != hist_a[2:]:
        diff = sorted({k for x, y in zip(b2["history"], hist_a[2:])
                       for k in x if x[k] != y.get(k)})
        raise AssertionError(f"ckpt_resume: the resumed steps 2-3 differ "
                             f"from run A's in {diff}")
    mb = _manifest(b_dir, 4)
    if mb["digests"] != ma["digests"]:
        diff = sorted(k for k in ma["digests"]
                      if mb["digests"].get(k) != ma["digests"][k])
        raise AssertionError(f"ckpt_resume: step-4 digests differ in {diff}")
    saves = {"a": run_a["ckpt_saves"][-1], "b": b["ckpt_saves"][-1],
             "b_resumed": b2["ckpt_saves"][-1]}
    nbytes = saves["a"]["bytes"]
    say("ckpt_resume",
        command=("python -m repro_torch.launch.train "
                 + " ".join(wire_argv(4, 4, "onchip", "--ckpt-dir", "D",
                                      "[--sigterm-at 2 | --resume]"))),
        layers=cfg.n_layers, params=run_a["params"], losses=losses,
        free_bytes_before=free, bytes_on_disk=disk, state_bytes=nbytes,
        arrays=len(ma["digests"]),
        saves={k: dict(v, stall_GBps=_rate(v["bytes"], v["stall_s"]),
                       write_GBps=_rate(v["bytes"], v.get("write_s")))
               for k, v in saves.items()},
        verify_s=res["verify_s"],
        verify_GBps=_rate(nbytes, res["verify_s"]),
        restore_s=res["restore_s"],
        restore_GBps=_rate(nbytes, res["restore_s"]),
        metrics_bit_equal=sorted(hist_a[2]), steps_compared=[2, 3],
        digests_equal=True,
        ms_per_step_after_first={"a": run_a["ms_per_step_after_first"],
                                 "b_resumed": b2["ms_per_step_after_first"]},
        seconds={"a": a_s, "b": b_s, "b_resumed": b2_s})


def _smoke_argv(steps, *extra):
    """``launch.train`` on the card at smoke size (the int8 wire, 2
    ranks)."""
    return ["--arch", "llama3_2_3b", "--smoke", "--steps", str(steps),
            "--batch", "4", "--seq", "16", "--optimizer", "sgd",
            "--grad-allreduce-bits", "8", "--data-ranks", "2",
            "--log-every", "1", *extra]


def ckpt_corrupt():
    """At smoke size on the card: a bit flip and a truncation of the newest
    checkpoint are walked past by ``latest_step`` and refused by
    ``restore``, and ``--resume`` lands on the good step; then a ZeRO-1
    run preempted at step 2 and resumed equals its uninterrupted run bit
    for bit (every metric, every digest)."""
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.launch import train as train_cli
    from repro_torch.resilience import corrupt_checkpoint
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ckpt_smoke_", dir=os.path.join(ROOT,
                                                                  "build"))
    try:
        modes = {}
        for mode in ("bitflip", "truncate"):
            d = os.path.join(root, mode)
            train_cli.main(_smoke_argv(4, "--ckpt-dir", d, "--ckpt-every",
                                       "2"))
            corrupt_checkpoint(d, 4, mode)
            if latest_step(d) != 2:
                raise AssertionError(f"ckpt_corrupt ({mode}): latest_step "
                                     f"{latest_step(d)}, wanted 2")
            template = train_cli.setup(train_cli.make_parser().parse_args(
                _smoke_argv(4)))[2]
            try:
                restore(d, 4, template)
            except Exception as e:          # noqa: BLE001 — the refusal
                refused = f"{type(e).__name__}: {e}"[:200]
            else:
                raise AssertionError(f"ckpt_corrupt ({mode}): step 4 restored")
            del template
            out = train_cli.main(_smoke_argv(6, "--ckpt-dir", d, "--resume"))
            if (out["resumed"] or {}).get("step") != 2 or len(
                    out["history"]) != 4:
                raise AssertionError(f"ckpt_corrupt ({mode}): resumed "
                                     f"{out['resumed']}")
            modes[mode] = refused
        zero = ["--zero-opt"]
        a = train_cli.main(_smoke_argv(4, "--ckpt-dir",
                                       os.path.join(root, "za"), *zero))
        b = train_cli.main(_smoke_argv(4, "--ckpt-dir",
                                       os.path.join(root, "zb"),
                                       "--sigterm-at", "2", *zero))
        b2 = train_cli.main(_smoke_argv(4, "--ckpt-dir",
                                        os.path.join(root, "zb"),
                                        "--resume", *zero))
        if not (a["zero_opt"] and b.get("preempted_at") == 2
                and b2["resumed"]["step"] == 2
                and b["history"] + b2["history"] == a["history"]
                and _manifest(os.path.join(root, "za"), 4)["digests"]
                == _manifest(os.path.join(root, "zb"), 4)["digests"]):
            raise AssertionError("ckpt_corrupt: the resumed ZeRO run differs "
                                 "from the uninterrupted one")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say("ckpt_corrupt", refused=modes, latest_step_walked_back_to=2,
        resumed_from=2, zero_resume_bit_equal=True,
        seconds=time.perf_counter() - t0)


def _fingerprint(state):
    """Exact fingerprints of the parameters, optimizer state and DPS state,
    taken on the device: ``{checkpoint key: (int64 sum of the leaf's 32-bit
    patterns, their max)}``."""
    from repro_torch.checkpoint.ckpt import _walk
    rows = {}

    def take(key, t):
        if t.element_size() != 4:
            raise AssertionError(f"fingerprint: {key} is {t.dtype}")
        bits = t.detach().contiguous().view(torch.int32)
        rows[key] = torch.stack([bits.sum(dtype=torch.int64),
                                 bits.max().to(torch.int64)])
    for name in ("params", "opt_state", "dps"):
        _walk(getattr(state, name), "." + name, take)
    keys = sorted(rows)
    return dict(zip(keys, torch.stack([rows[k] for k in keys]).cpu()
                    .tolist()))


def _metrics(hist):
    return [{k: v for k, v in h.items()
             if k not in ("health", "skipped", "trips", "degraded")}
            for h in hist]


def guards_idle(cfg, run_a):
    """The full-width wire run with ``--guards`` and no fault, 4 steps:
    every metric run A reports bit-equal, health 0 on every step; its step
    time and peak memory beside A's."""
    from repro_torch.launch import train as train_cli
    argv = wire_argv(4, 4, "onchip", "--guards")
    t0 = time.perf_counter()
    train_cli.reset_launch_counts()
    out = train_cli.main(argv)
    hist = out["history"]
    if _metrics(hist) != run_a["history"]:
        diff = sorted({k for x, y in zip(_metrics(hist), run_a["history"])
                       for k in x if x[k] != y.get(k)})
        raise AssertionError(f"guards_idle: armed idle guards moved {diff}")
    if any(h["health"] or h["skipped"] or h["degraded"] for h in hist):
        raise AssertionError(f"guards_idle: health {[h['health'] for h in hist]}")
    say("guards_idle", command="python -m repro_torch.launch.train "
        + " ".join(argv), metrics_bit_equal_to_run_a=sorted(run_a["history"][0]),
        health=[h["health"] for h in hist],
        ms_per_step_after_first=out["ms_per_step_after_first"],
        run_a_ms_per_step_after_first=run_a["ms_per_step_after_first"],
        peak_memory_bytes=out["peak_memory_bytes"],
        run_a_peak_memory_bytes=run_a["peak_memory_bytes"],
        launches=train_cli.launch_counts(), seconds=time.perf_counter() - t0)
    del out
    gc.collect()
    torch.cuda.empty_cache()


def guards_nan(cfg, run_a):
    """The full-width wire run with ``--guards --inject-nan-at 1
    --guard-cooldown 1``, 4 steps: step 1 flags its NaN gradients and is
    skipped with the parameters, momenta and DPS state held exactly (device
    fingerprints before and after it); step 2 runs the fp32 fallback (no
    K2b, K4 or K3b launch); step 3 is back on the int8 wire with run A's
    launches; every loss after step 1 finite."""
    from repro_torch.launch import train as train_cli
    from repro_torch.resilience import (HEALTH_DEGRADED,
                                        HEALTH_GRADS_NONFINITE,
                                        HEALTH_SKIPPED, health_flags)
    argv = wire_argv(4, 4, "onchip", "--guards", "--inject-nan-at", "1",
                     "--guard-cooldown", "1")
    prints = {}

    def on_step(step, state):
        if step in (0, 1):
            prints[step] = _fingerprint(state)

    t0 = time.perf_counter()
    train_cli.reset_launch_counts()
    out = train_cli.main(argv, on_step=on_step)
    hist = out["history"]
    want = run_a["history"][0]["kernel_launches"]
    h1 = int(hist[1]["health"])
    need = HEALTH_GRADS_NONFINITE | HEALTH_SKIPPED | HEALTH_DEGRADED
    if h1 & need != need:
        raise AssertionError(f"guards_nan: step 1 health {health_flags(h1)}")
    # held exactly, but for the trip's one extra IL bit on the compute
    # gradients (widen_on_trip, as the reference does)
    widened = ".dps/grads/.il"
    moved = sorted(k for k in prints[0]
                   if k != widened and prints[0][k] != prints[1][k])
    if moved or prints[1][widened] != [v + 1 for v in prints[0][widened]]:
        raise AssertionError(f"guards_nan: the skipped step moved {moved} "
                             f"({widened} {prints[0][widened]} -> "
                             f"{prints[1][widened]})")
    deg = hist[2]["kernel_launches"]
    if (any(deg[k] for k in WIRE_KERNELS)
            or {k: v for k, v in deg.items() if k not in WIRE_KERNELS}
            != {k: v for k, v in want.items() if k not in WIRE_KERNELS}):
        raise AssertionError(f"guards_nan: the degraded step launched {deg}")
    if hist[3]["kernel_launches"] != want or hist[3]["health"]:
        raise AssertionError(f"guards_nan: step 3 launched "
                             f"{hist[3]['kernel_launches']} (health "
                             f"{hist[3]['health']})")
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(v) for v in losses[2:]):
        raise AssertionError(f"guards_nan: losses {losses}")
    say("guards_nan", command="python -m repro_torch.launch.train "
        + " ".join(argv), losses=losses,
        health=[list(health_flags(int(h["health"]))) for h in hist],
        skipped=[h["skipped"] for h in hist],
        degraded=[h["degraded"] for h in hist],
        state_held_on_skip=True, fingerprinted_leaves=len(prints[0]),
        widened_grads_il=[prints[0][widened][0], prints[1][widened][0]],
        launches_per_step=[h["kernel_launches"] for h in hist],
        E_wire=[h["E_wire"] for h in hist],
        peak_memory_bytes=out["peak_memory_bytes"],
        seconds=time.perf_counter() - t0)
    del out
    gc.collect()
    torch.cuda.empty_cache()


def rollback():
    """At smoke size on the card, the reference test's drill: NaN gradients
    at step 5 without guards, a ring of 2; 1-8 rollbacks, each replayed
    window's step-5 loss finite again, and the run completes."""
    from repro_torch.launch import train as train_cli
    t0 = time.perf_counter()
    out = train_cli.main(["--arch", "llama3_2_3b", "--smoke", "--steps", "10",
                          "--batch", "2", "--seq", "16", "--optimizer", "sgd",
                          "--inject-nan-at", "5", "--rollback-ring", "2",
                          "--log-every", "2"])
    n_rb = out["rollbacks"]
    losses = [h["loss"] for h in out["history"]]
    first_bad = next((i for i, v in enumerate(losses)
                      if not math.isfinite(v)), None)
    if (not 1 <= n_rb <= 8 or first_bad is None
            or sum(math.isfinite(v) for v in losses[first_bad:]) < n_rb):
        raise AssertionError(f"rollback: {n_rb} rollbacks, losses {losses}")
    say("rollback", rollbacks=n_rb, drained_steps=len(losses),
        finite_after_first_bad=sum(math.isfinite(v)
                                   for v in losses[first_bad:]),
        seconds=time.perf_counter() - t0)


def guards_zero_idle(overlap_hist, overlap_summary):
    """``--zero-opt --wire-overlap on --guards`` at full width, no fault, 4
    steps: every metric of ``train_zero``'s overlap run bit-equal (its
    launches too: the guards' norm pass decodes each owner's shard, no K4),
    health 0; its ms a step, peak and launches beside that run's."""
    from repro_torch.launch import train as train_cli
    argv = zero_argv(True, "--guards")
    t0 = time.perf_counter()
    train_cli.reset_launch_counts()
    dps_quant.reduce_tma_launch_count = 0
    out = train_cli.main(argv)
    hist = out["history"]
    if not (out["zero_opt"] and out["wire_overlap"] and out["guards"]):
        raise AssertionError("guards_zero_idle: ZeRO, the overlap or the "
                             "guards did not engage")
    if _metrics(hist) != overlap_hist:
        diff = sorted({k for x, y in zip(_metrics(hist), overlap_hist)
                       for k in x if x[k] != y.get(k)})
        raise AssertionError(f"guards_zero_idle: armed idle guards moved "
                             f"{diff}")
    if any(h["health"] or h["skipped"] or h["degraded"] for h in hist):
        raise AssertionError("guards_zero_idle: health "
                             f"{[h['health'] for h in hist]}")
    launches = train_cli.launch_counts()
    _all_k4_on_tma(launches, "guards_zero_idle")
    say("guards_zero_idle", command="python -m repro_torch.launch.train "
        + " ".join(argv), metrics_bit_equal_to_zero_overlap=sorted(
            overlap_hist[0]), health=[h["health"] for h in hist],
        ms_per_step_after_first=out["ms_per_step_after_first"],
        zero_overlap_ms_per_step_after_first=overlap_summary[
            "ms_per_step_after_first"],
        peak_memory_bytes=out["peak_memory_bytes"],
        zero_overlap_peak_memory_bytes=overlap_summary["peak_memory_bytes"],
        launches=launches, launches_per_step=hist[-1]["kernel_launches"],
        seconds=time.perf_counter() - t0)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def guards_zero_nan(unguarded_hist, overlap):
    """``--zero-opt [--wire-overlap on] --guards --inject-nan-at 1
    --guard-cooldown 1`` at full width, 4 steps: step 1 flags its NaN
    gradients, degrades and is skipped, the flat parameters, the sharded
    momenta and the DPS state held exactly (device fingerprints, but for
    the trip's +1 IL on the compute gradients); step 2 runs the fp32
    reduce-scatter (no K2b, K4 or K3b: on the overlap the hooks issue no
    bucket collective) at a peak no higher than the int8 step 3's; step 3
    is back on int8 with the unguarded run's launches.  Each step's wall
    time (the device synchronized after it) and peak are printed."""
    from repro_torch.launch import train as train_cli
    from repro_torch.resilience import (HEALTH_DEGRADED,
                                        HEALTH_GRADS_NONFINITE,
                                        HEALTH_SKIPPED, health_flags)
    phase = "guards_overlap_nan" if overlap else "guards_zero_nan"
    argv = zero_argv(overlap, "--guards", "--inject-nan-at", "1",
                     "--guard-cooldown", "1")
    prints, peaks, step_s = {}, [], []
    clock = {"t": None}

    def on_step(step, state):
        torch.cuda.synchronize(DEV)
        now = time.perf_counter()
        step_s.append(now - clock["t"] if clock["t"] is not None else None)
        peaks.append(torch.cuda.max_memory_allocated(DEV))
        if step in (0, 1):
            prints[step] = _fingerprint(state)
        torch.cuda.reset_peak_memory_stats(DEV)
        clock["t"] = time.perf_counter()

    t0 = time.perf_counter()
    train_cli.reset_launch_counts()
    dps_quant.reduce_tma_launch_count = 0
    out = train_cli.main(argv, on_step=on_step)
    hist = out["history"]
    if not (out["zero_opt"] and out["wire_overlap"] == overlap
            and out["guards"]):
        raise AssertionError(f"{phase}: ZeRO, the overlap or the guards did "
                             "not engage")
    want = unguarded_hist[0]["kernel_launches"]
    h1 = int(hist[1]["health"])
    need = HEALTH_GRADS_NONFINITE | HEALTH_SKIPPED | HEALTH_DEGRADED
    if h1 & need != need:
        raise AssertionError(f"{phase}: step 1 health {health_flags(h1)}")
    widened = ".dps/grads/.il"
    moved = sorted(k for k in prints[0]
                   if k != widened and prints[0][k] != prints[1][k])
    if moved or prints[1][widened] != [v + 1 for v in prints[0][widened]]:
        raise AssertionError(f"{phase}: the skipped step moved {moved} "
                             f"({widened} {prints[0][widened]} -> "
                             f"{prints[1][widened]})")
    deg = hist[2]["kernel_launches"]
    if (any(deg[k] for k in WIRE_KERNELS)
            or {k: v for k, v in deg.items() if k not in WIRE_KERNELS}
            != {k: v for k, v in want.items() if k not in WIRE_KERNELS}):
        raise AssertionError(f"{phase}: the degraded step launched {deg}")
    # the flag step 1 raised picks step 2's fp32 legs (zero wire stats);
    # the cooldown of one clean step re-arms int8 after it
    if (not hist[1]["degraded"] or hist[2]["E_wire"] != 0.0
            or hist[2]["degraded"]):
        raise AssertionError(f"{phase}: degraded {[h['degraded'] for h in hist]}"
                             f", step 2 E_wire {hist[2]['E_wire']}")
    if peaks[2] > peaks[3]:
        raise AssertionError(f"{phase}: the degraded step's peak {peaks[2]} "
                             f"B is above the int8 step's {peaks[3]} B")
    if hist[3]["kernel_launches"] != want or hist[3]["health"]:
        raise AssertionError(f"{phase}: step 3 launched "
                             f"{hist[3]['kernel_launches']} (health "
                             f"{hist[3]['health']})")
    launches = train_cli.launch_counts()
    _all_k4_on_tma(launches, phase)
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(v) for v in losses[2:]):
        raise AssertionError(f"{phase}: losses {losses}")
    say(phase, command="python -m repro_torch.launch.train " + " ".join(argv),
        losses=losses,
        health=[list(health_flags(int(h["health"]))) for h in hist],
        skipped=[h["skipped"] for h in hist],
        degraded=[h["degraded"] for h in hist],
        state_held_on_skip=True, fingerprinted_leaves=len(prints[0]),
        widened_grads_il=[prints[0][widened][0], prints[1][widened][0]],
        launches_per_step=[h["kernel_launches"] for h in hist],
        launches=launches, E_wire=[h["E_wire"] for h in hist],
        peak_bytes_per_step=peaks, seconds_per_step_synchronized=step_s,
        seconds=time.perf_counter() - t0)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the sharded train step: llama3.2-3b placed over a (data × model) mesh
# ---------------------------------------------------------------------------

def _stacked(shape):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, ("data", "model"), device=DEV)


def _rel_max(a, b):
    """max |a - b| over max |b| (fp32)."""
    a, b = a.detach().to(torch.float32), b.detach().to(torch.float32)
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _placed_leaf_check(x, spec, mesh, seed, what):
    """K1b in block mode on every held block of the whole leaf ``x`` placed
    by ``spec``: q bit-equal to the unsharded K1b launch on the same
    elements; the merged statistics' integers and max_abs exact, the float
    sums within ``SUM_RTOL``.  Returns the largest float-sum difference."""
    from repro_torch.core import fixed_point as fxp
    from repro_torch.dist.sharding import gather_placed, place_tensor
    fmt = fxp.FixedPointFormat.create(2, 14, DEV)
    qw, sw = fxp.quantize_tree_leaf(0, (what,), x, fmt, mode="stochastic",
                                    seed=seed, onchip_prng=True)
    qp, sp = fxp.quantize_placed(0, (what,), place_tensor(x, spec, mesh), fmt,
                                 mode="stochastic", seed=seed,
                                 onchip_prng=True)
    if not torch.equal(gather_placed(qp), qw):
        raise AssertionError(f"tp_check: K1b blocks of {what} differ from "
                             "the unsharded launch")
    vk = torch.stack([getattr(sp, f) for f in STAT_FIELDS])
    vw = torch.stack([getattr(sw, f) for f in STAT_FIELDS])
    return _stats_match(vk, vw, x.numel())


STAT_FIELDS = ("count", "nonzero", "overflow", "abs_err_sum", "rel_err_sum",
               "abs_sum", "max_abs")


def k1b_block_rows():
    """K1b in block mode at one rank's block of one layer of llama's
    ``w_in`` as ``place_tensor`` cuts it under the configs' specs, at each
    of ``TP_MESHES``: at (1, 4) rank 1's 3,072 × 2,048 (columns 2,048-4,095
    of 8,192), at (2, 4) rank 5's 1,536 × 2,048 (rows 1,536-3,071 too) —
    kernel vs plain bit-equal, two launches' statistics bit-identical
    (``check_quant``), q equal to the unsharded launch's on those
    elements; timed by ``quant_row`` beside the contiguous K1b launch on as
    many elements.  Each row's launches are its placed run's block
    launches (``train_llama_tp`` at that mesh)."""
    from repro_torch.dist.sharding import LogicalRules, place_tensor
    from repro_torch.launch.specs import param_shardings
    cfg = get_config("llama3_2_3b")
    D, F = cfg.d_model, cfg.d_ff
    g = torch.Generator(device=DEV).manual_seed(12)
    whole = torch.randn(D, F, generator=g, device=DEV) * D ** -0.5
    whole[:, ::11] = 0.0
    il, fl = 2, 14
    qw, _ = dps_quant.dps_quant(whole, _i32(il), _i32(fl), dps_quant.Philox(5),
                                backend="kernel")
    rows = []
    for shape in TP_MESHES:
        mesh = _stacked(shape)
        spec = param_shardings(cfg, mesh, LogicalRules())["layers"]["mlp"][
            "w_in"][1:]                                  # one layer's dims
        placed = place_tensor(whole, spec, mesh)
        rank = (shape[0] - 1) * shape[1] + 1
        origin, bshape = placed.geometry(rank)
        blk = placed.blocks[rank]
        geo = dps_quant.block_geometry((D, F), origin, bshape)
        bits = dps_quant.Philox(5, block=geo)
        err, rel = check_quant(blk, il, fl, bits)
        qb, _ = dps_quant.dps_quant(blk, _i32(il), _i32(fl), bits,
                                    backend="kernel")
        sl = tuple(slice(o, o + b) for o, b in zip(origin, bshape))
        if not torch.equal(qb, qw[sl]):
            raise AssertionError(f"K1b block mode at {shape} differs from "
                                 "the unsharded launch on the same elements")
        n = blk.numel()
        tag = "x".join(map(str, shape))
        row = quant_row(
            "dps_quantize_onchip_prng_block" + ("" if tag == "1x4"
                                                else f"_{tag}"),
            f"llama3.2-3b layers/mlp/w_in, one layer's block at {shape} "
            f"(rank {rank}, spec {spec}, origin {origin}): "
            f"{bshape[0]}x{bshape[1]} of {D}x{F} = {n} fp32, Philox bits "
            "of the whole leaf in the kernel (block mode), statistics on",
            blk, il, fl, bits, err, rel, 8 * n + 8 + 28, 49 * n)
        flat, ilt, flt = blk.reshape(-1), _i32(il), _i32(fl)
        contiguous = lambda: dps_quant.dps_quant(flat, ilt, flt,
                                                 dps_quant.Philox(5),
                                                 backend="kernel")
        row["contiguous_ms"] = time_ms(contiguous, repeats=10)
        row["contiguous_ms_graph_clean"] = time_graph_ms(contiguous,
                                                         repeats=10,
                                                         clean=True)
        row.update(counter="dps_quantize_block",
                   run="train_llama_tp" + ("" if tag == "1x4"
                                           else f"_{tag}"))
        say("k1b_block", **{k: row[k] for k in (
            "name", "shape", "body", "max_abs_err", "stats_max_rel_err",
            "ms", "ms_graph", "ms_graph_clean", "kernels_a_call",
            "ms_no_stats", "contiguous_ms", "contiguous_ms_graph_clean",
            "plain_ms", "bound_ms", "bound_by")})
        rows.append(row)
        del placed, blk, qb
    del whole, qw
    return rows


def _layer_vs_whole(cfg, defs, fn, inputs, in_logical, out_shape, *,
                    perturb=(), seed=3, noise_floor=False):
    """``fn(params, *inputs)`` (an output of ``out_shape``) whole, then
    placed on each of ``TP_MESHES`` (the parameters by their
    declarations' specs, input ``i`` by ``in_logical[i]``, the output laid
    out by ``("batch", "tp_seq", "embed")``, one rank an element): the
    output and the gradients of ``sum(out * w)`` for every floating input
    and every parameter, each as max |Δ| over max |value| of the whole
    one, within ``TP_TOL`` of ``cfg``'s compute dtype; forward + backward
    ms and peak of both.  The key bias's gradient is zero in exact
    arithmetic (a shift of every key moves a query's scores alike, which
    the softmax ignores): its largest magnitude in either run, over the
    layer's largest gradient, is held to the same limit.
    ``noise_floor``: each parameter's gradient is also computed whole a
    batch row at a time and summed — the same sums in another order — and
    the placed gradient is held within twice that difference where it
    exceeds half of ``TP_TOL`` (a gradient that sums every position of a
    head, as a Mamba2 block's ``a_log`` and ``dt_bias`` do, moves that
    much under any reordering).  ``perturb``: parameter paths drawn at random in
    place of their zero init (biases).  Returns the readings."""
    from repro_torch.core import qtrain
    from repro_torch.core import tree as tree_lib
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import (LogicalRules, axis_rules,
                                           gather_placed, place_tensor,
                                           relayout)
    from repro_torch.models.common import map_defs
    dtype = cfg.dtype
    rules = LogicalRules()
    p = init_params(defs, DEV, torch.Generator(device=DEV).manual_seed(seed))
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    for path in perturb:
        node = p
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = 0.1 * torch.randn(node[path[-1]].shape, generator=g,
                                           device=DEV)
    w = torch.randn(out_shape, generator=g, device=DEV).to(
        cfg.activation_dtype())
    floating = [x.is_floating_point() for x in inputs]

    def whole_pass(rows=slice(None)):
        pw = tree_lib.map_tree(lambda t: t.detach().requires_grad_(), p)
        xw = [x[rows].detach().requires_grad_() if f else x[rows]
              for x, f in zip(inputs, floating)]
        y = fn(pw, *xw)
        gr = torch.autograd.grad(
            (y.float() * w[rows].float()).sum(),
            [x for x, f in zip(xw, floating) if f] + tree_lib.leaves(pw),
            allow_unused=True, materialize_grads=True)
        return y, gr

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    y_w, g_w = whole_pass()
    torch.cuda.synchronize()
    res = {"unsharded_ms": time_ms(whole_pass, repeats=3, warmup=1),
           "unsharded_peak_bytes": torch.cuda.max_memory_allocated()
           - base_mem}
    names = ([f"d_input{i}" for i, f in enumerate(floating) if f]
             + ["d" + "/".join(k) for k, _ in tree_lib.leaves_with_path(p)])
    largest = max(float(t.abs().max()) for t in g_w)
    limit = dict.fromkeys(names, TP_TOL[dtype])
    if noise_floor:
        n_in = sum(floating)
        by_row = [whole_pass(slice(r, r + 1))[1][n_in:]
                  for r in range(out_shape[0])]
        floor = {n: _rel_max(sum(g[i] for g in by_row), gw)
                 for i, (n, gw) in enumerate(zip(names[n_in:], g_w[n_in:]))}
        del by_row
        limit.update({n: max(TP_TOL[dtype], 2 * f) for n, f in floor.items()
                      if not n.endswith("/bk")})
        res["reordering_noise"] = floor
    for shape in TP_MESHES:
        mesh = _stacked(shape)
        with axis_rules(mesh, rules):
            specs_ = map_defs(lambda d: rules.spec(d.logical, d.shape, mesh),
                              defs)
            pp = tree_lib.map_tree(lambda t, sp: place_tensor(t, sp, mesh),
                                   p, specs_)
            xp0 = [place_tensor(x, rules.spec(lg, x.shape, mesh), mesh)
                   for x, lg in zip(inputs, in_logical)]
            ospec = rules.spec(("batch", "tp_seq", "embed"), out_shape, mesh)
            wp = place_tensor(w, ospec, mesh)

            def placed_pass():
                # one autograd leaf a rank, as the placed step makes them
                pl = tree_lib.map_tree(qtrain._rank_leaves, pp)
                xp = [qtrain._rank_leaves(x) if f else x
                      for x, f in zip(xp0, floating)]
                y = relayout(fn(pl, *xp), ospec)
                loss = [(a.float() * b.float()).sum()
                        for a, b in zip(y.blocks, wp.blocks)]
                ins = [x for x, f in zip(xp, floating) if f] + \
                    tree_lib.leaves(pl)
                gr = torch.autograd.grad(
                    loss, [b for v in ins for b in v.blocks],
                    allow_unused=True, materialize_grads=True)
                return y, gr, ins

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_mem = torch.cuda.memory_allocated()
            y_p, g_p, ins = placed_pass()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base_mem
            ms = time_ms(lambda: placed_pass(), repeats=3, warmup=1)
            rels = {"out": _rel_max(gather_placed(y_p), y_w)}
            at = 0
            for name, v, gw in zip(names, ins, g_w):
                gb = list(g_p[at:at + len(v.blocks)])
                at += len(v.blocks)
                # a tensor replicated over an axis: each rank holds its share
                gb = sharding.psum(mesh, v.replicated_axes(), gb)
                gp = gather_placed(sharding.Placed(gb, v.spec, mesh,
                                                   v.shape))
                rels[name] = (
                    max(float(gp.abs().max()), float(gw.abs().max()))
                    / largest if name.endswith("/bk") else _rel_max(gp, gw))
        over = {k: v for k, v in rels.items() if not v <= limit.get(
            k, TP_TOL[dtype])}
        if over:
            raise AssertionError(f"{cfg.name} {dtype} {shape}: relative "
                                 f"differences {over} over their limits "
                                 f"{ {k: limit.get(k, TP_TOL[dtype]) for k in over} }")
        res[f"{shape[0]}x{shape[1]}"] = dict(max_rel=rels, ms=ms,
                                             peak_bytes=peak)
        del y_p, g_p, ins, pp, xp0, wp
    del p, y_w, g_w
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_check():
    """One llama3.2-3b layer at full geometry (D 3,072, 24/8 heads, Dh
    128, d_ff 8,192), x (2, 512, 3,072), fp32 and bf16, on stacked (1, 4)
    and (2, 4) meshes against the unsharded layer (:func:`_layer_vs_whole`):
    the output and every gradient within ``TP_TOL`` (max |Δ| over max
    |value|); K1b in block mode on every rank's block of ``w_in``, ``wk``
    (28 layers) and ``tok`` bit-equal to the unsharded launch, the merged
    statistics exact or within ``SUM_RTOL``; forward + backward ms and
    peak of both."""
    from repro_torch.dist.sharding import LogicalRules
    from repro_torch.models import transformer as tr
    base = get_config("llama3_2_3b")
    rules = LogicalRules()
    out = {}
    pos = torch.arange(512, dtype=torch.int32, device=DEV)[None, :]
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype, remat="none")
        g = torch.Generator(device=DEV).manual_seed(4)
        x = torch.randn(2, 512, cfg.d_model, generator=g, device=DEV)
        out[dtype] = _layer_vs_whole(
            cfg, tr.layer_defs(cfg, torch.float32),
            lambda p, x: tr._train_block(cfg, p, x, pos, None, 0)[0],
            [x.to(cfg.activation_dtype())], [("batch", "tp_seq", "embed")],
            x.shape)
        del x
    # K1b in block mode on the full-size leaves, every rank's block
    L, D, V = base.n_layers, base.d_model, 128512
    sums = _placed_leaves_check((
        ("w_in", (L, D, base.d_ff), (None, "fsdp", "tp")),
        ("wk", (L, D, base.n_kv_heads * base.head_dim), (None, "fsdp", "tp")),
        ("tok", (V, D), ("vocab_out", "embed"))), rules)
    say("tp_check", tolerance=TP_TOL, layer=out,
        k1b_blocks_bit_equal=True, merged_stats_sum_max_rel=sums,
        merged_stats_sum_tolerance=SUM_RTOL)
    return out


def _placed_leaves_check(leaves, rules, seed=9):
    """:func:`_placed_leaf_check` on each ``(name, shape, logical)`` leaf
    drawn at full size, on each of ``TP_MESHES``: the merged statistics'
    largest float-sum difference by leaf and mesh."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    sums = {}
    for what, shape, logical in leaves:
        x = torch.randn(shape, generator=gen, device=DEV) * 0.03
        x.view(-1)[::13] = 0.0
        for mshape in TP_MESHES:
            mesh = _stacked(mshape)
            spec = rules.spec(logical, shape, mesh)
            sums[f"{what} {mshape[0]}x{mshape[1]} {spec}"] = \
                _placed_leaf_check(x, spec, mesh, 21, what)
        del x
        gc.collect()
        torch.cuda.empty_cache()
    return sums


def tp_families_check():
    """Each placed form the other families train through, at its
    config's full geometry, fp32 and bf16, on stacked (1, 4) and (2, 4)
    meshes against the whole layer (:func:`_layer_vs_whole`, ``TP_TOL``):
    deepseek-v2's MLA layer (D 5,120, 128 heads, x (2, 512, 5,120)); the
    Mamba2 block (norm, mixer, residual) of mamba2-1.3b and of zamba2-7b;
    zamba2's shared transformer block; whisper's encoder layer (1,500
    frames, biased MHA, not causal) and decoder layer (self- and
    cross-attention over 1,500 encoder positions, biases drawn at random);
    internvl2's embedding with its 256-patch prefix before 512 tokens.
    Then K1b in block mode on the new leaves' blocks at full size
    (deepseek's stacked ``w_uk``, split on its heads; mamba2's stacked
    ``conv_w``, split on its channels; zamba2's ``shared`` ``wq`` and
    ``w_in``; whisper's stacked ``bq``) bit-equal to the unsharded
    launch."""
    from repro_torch.dist.sharding import LogicalRules
    from repro_torch.models import attention, encdec, hybrid, mamba
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import compute_cast
    S = 512
    pos = torch.arange(S, dtype=torch.int32, device=DEV)[None, :]
    resid = ("batch", "tp_seq", "embed")
    out = {}

    def draw(shape, seed, dt):
        g = torch.Generator(device=DEV).manual_seed(seed)
        return torch.randn(shape, generator=g, device=DEV).to(dt)

    biases = [(k,) for k in ("bq", "bk", "bv", "bo")]
    check = functools.partial(_layer_vs_whole, noise_floor=True)
    for dtype in ("float32", "bfloat16"):
        res = {}

        def at(model):
            return dataclasses.replace(get_config(model), dtype=dtype,
                                       remat="none")

        cfg = at("deepseek_v2_236b")
        x = draw((2, S, cfg.d_model), 4, cfg.activation_dtype())
        res["mla_deepseek_v2_236b"] = check(
            cfg, attention.mla_defs(cfg, torch.float32),
            lambda p, x: attention.mla_apply(
                cfg, compute_cast(cfg, p, attention.mla_defs), x,
                positions=pos, mode="train")[0], [x], [resid], x.shape)
        for model in ("mamba2_1_3b", "zamba2_7b"):
            cfg = at(model)
            x = draw((2, S, cfg.d_model), 5, cfg.activation_dtype())
            res[f"mamba2_block_{model}"] = check(
                cfg, mamba.layer_defs(cfg, torch.float32),
                lambda p, x: mamba.train_block(cfg, p, x, None, 0)[0], [x],
                [resid], x.shape, perturb=[("ssm", "a_log"),
                                           ("ssm", "dt_bias")])
        res["shared_block_zamba2_7b"] = check(
            cfg, hybrid.model_defs(cfg, torch.float32)["shared"],
            lambda p, x: tr._train_block(cfg, p, x, pos, None,
                                         hybrid.SHARED_TAP_BASE)[0], [x],
            [resid], x.shape)
        cfg = at("whisper_medium")
        frames = draw((2, cfg.enc_seq, cfg.d_model), 6,
                      cfg.activation_dtype())
        res["encoder_layer_whisper_medium"] = check(
            cfg, encdec._enc_layer_defs(cfg, torch.float32),
            lambda p, x: encdec._enc_train_block(
                cfg, p, x, torch.arange(cfg.enc_seq, dtype=torch.int32,
                                        device=DEV)[None, :], None, 0)[0],
            [frames], [("batch", "seq", "embed")], frames.shape,
            perturb=[("attn",) + b for b in biases])
        x = draw((2, S, cfg.d_model), 7, cfg.activation_dtype())
        res["decoder_layer_whisper_medium"] = check(
            cfg, encdec._dec_layer_defs(cfg, torch.float32),
            lambda p, x, enc: encdec._dec_train_block(cfg, p, x, enc, pos,
                                                      None, 0)[0],
            [x, frames], [resid, ("batch", "seq", "embed")], x.shape,
            perturb=[(a,) + b for a in ("self_attn", "cross_attn")
                     for b in biases])
        cfg = at("internvl2_26b")
        tokens = torch.randint(0, cfg.vocab, (2, S), device=DEV,
                               generator=torch.Generator(
                                   device=DEV).manual_seed(8))
        vision = draw((2, cfg.n_patches, cfg.d_model), 9, torch.float32)
        res["vision_embed_internvl2_26b"] = check(
            cfg, {"embed": {"tok": tr.model_defs(
                cfg, torch.float32)["embed"]["tok"]}},
            lambda p, tok, vis: tr._embed(cfg, p, tok, vis), [tokens, vision],
            [("batch", None), ("batch", None, None)],
            (2, cfg.n_patches + S, cfg.d_model))
        del x, frames, tokens, vision
        out[dtype] = res
    ds, mb, zb, wh = (get_config(m) for m in (
        "deepseek_v2_236b", "mamba2_1_3b", "zamba2_7b", "whisper_medium"))
    from repro_torch.models import ssm
    sums = _placed_leaves_check((
        ("w_uk", (ds.n_layers, ds.kv_lora_rank, ds.n_heads, ds.qk_nope_dim),
         ("layers", None, "tp", None)),
        ("conv_w", (mb.n_layers, mb.ssm_conv, ssm.conv_channels(mb)),
         ("layers", None, "tp")),
        ("shared_wq", (zb.d_model, zb.n_heads * zb.head_dim),
         ("fsdp", "tp")),
        ("shared_w_in", (zb.d_model, zb.d_ff), ("fsdp", "tp")),
        ("bq", (wh.n_layers, wh.n_heads * wh.head_dim), ("layers", "tp"))),
        LogicalRules(), seed=10)
    say("tp_families_check", tolerance=TP_TOL, layers=out,
        k1b_blocks_bit_equal=True, merged_stats_sum_max_rel=sums,
        merged_stats_sum_tolerance=SUM_RTOL)
    return out


def _tp_launches_per_step(cfg, mesh):
    """K1b launches a placed step makes on a stacked mesh, and how many of
    them are in block mode: each quantized leaf's distinct blocks (one
    launch each, the product of its split axes' sizes) three times
    (weights, gradients, re-snap), plus each rank's block of the residual
    tapped forward and backward at each of the family's taps and
    microbatches.  A block that is the whole tensor draws the plain
    stream: a replicated leaf's, and an encoder residual's (whole on
    every model rank) unless the data axis splits its rows."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.dist.sharding import LogicalRules, _axis_sizes, spec_axes
    from repro_torch.launch import specs
    pred = QuantPolicy().param_predicate()
    sizes = _axis_sizes(mesh)
    p_specs = specs.param_shardings(cfg, mesh, LogicalRules())
    blocks = [math.prod(sizes[a] for a in spec_axes(s))
              for p, s in tree_lib.leaves_with_path(p_specs) if pred(p, None)]
    block_mode = [n for n in blocks if n > 1]
    per_event = sum(blocks)
    per_tap = 2 * math.prod(sizes.values()) * cfg.train_accum
    taps = per_tap * registry(cfg.family).residual_taps(cfg)
    whole_taps = (per_tap * cfg.n_enc_layers
                  if cfg.family == "encdec" and sizes.get("data", 1) == 1
                  else 0)
    return 3 * per_event + taps, 3 * sum(block_mode) + taps - whole_taps


def train_llama_tp():
    """llama3.2-3b at full width and depth (28 layers), ``launch.train.main``
    with ``--batch 4 --seq 512``, SGD, K1b, 3 steps: unsharded, then on a
    stacked (1, 4) mesh and a stacked (2, 4) mesh (``main(..., mesh=...)``:
    the placed step, FSDP over data, tensor parallelism over model).
    Formats of every domain equal to the unsharded run's at every step,
    the first loss (before any update) within ``TP_LOSS_RTOL``, every
    step's gap reported; K1b launches a step as ``_tp_launches_per_step``
    counts them; ms a step, peak, bytes each rank holds.  Then the same
    three runs with fp32 compute: formats equal, the first loss within
    ``TP_LOSS_RTOL_F32``, and the parameters after the first update equal
    to the unsharded run's but for a share ``TP_FLIP_SHARE`` at most, each
    at most ``TP_FLIP_STEPS`` weight-grid steps away: a last-bit
    difference of a sum tips a tap's rounding of an activation or a
    cotangent onto the neighbouring grid point, and the tipped element
    feeds the next layer, so the parts grow with depth — the later losses
    part by them in fp32 as in bf16."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.dist.sharding import gather_to_host
    from repro_torch.launch import train as train_cli
    cfg = get_config("llama3_2_3b")
    argv = ["--arch", "llama3_2_3b", "--steps", str(TP_STEPS), "--batch",
            str(TP_BATCH), "--seq", "512", "--optimizer", "sgd",
            "--log-every", "1"]
    fmt_keys = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")

    def run(cfg_, shape, on_step=None):
        _reset_quant_counts()
        dps_quant.quantize_block_launch_count = 0
        t0 = time.perf_counter()
        out = train_cli.main(argv, on_step=on_step, cfg=cfg_,
                             mesh=None if shape is None else _stacked(shape))
        hist = out["history"]
        r = dict(
            losses=[h["loss"] for h in hist],
            formats=[{k: h[k] for k in fmt_keys} for h in hist],
            E_a=[h["E_a"] for h in hist],
            ms=out["ms_per_step_after_first"],
            first_step_s=out["first_step_s"],
            peak=out["peak_memory_bytes"],
            held=out["held_bytes_per_rank"],
            launches=_quant_counts(),
            block_launches=dps_quant.quantize_block_launch_count,
            per_step=out["quantizer_launches_per_step"],
            seconds=time.perf_counter() - t0)
        del out, hist
        gc.collect()
        torch.cuda.empty_cache()
        return r

    faults = []

    def against(runs, limits, what):
        """Each placed run's formats equal to the unsharded run's every
        step and its first loss (before any update) within its mesh's
        limit; every step's relative gap reported."""
        ref = runs["unsharded"]
        gaps = {}
        for tag, r in runs.items():
            if tag == "unsharded":
                continue
            if r["formats"] != ref["formats"]:
                faults.append(f"{what} {tag}: formats {r['formats']} vs "
                              f"unsharded {ref['formats']}")
            gaps[tag] = [abs(a - b) / abs(b)
                         for a, b in zip(r["losses"], ref["losses"])]
            if not all(math.isfinite(v) for v in r["losses"]) or \
                    not gaps[tag][0] <= limits[tag]:
                faults.append(f"{what} {tag}: losses {r['losses']} vs "
                              f"{ref['losses']}")
        return gaps

    tag_of = lambda shape: ("unsharded" if shape is None
                            else f"{shape[0]}x{shape[1]}")
    runs = {}
    for shape in (None,) + TP_MESHES:
        tag = tag_of(shape)
        runs[tag] = r = run(cfg, shape)
        if shape is not None:
            want, want_block = _tp_launches_per_step(cfg, _stacked(shape))
            if (r["per_step"] != [want] * TP_STEPS
                    or r["block_launches"] != want_block * TP_STEPS):
                raise AssertionError(
                    f"train_llama_tp {tag}: K1b {r['per_step']} a step, "
                    f"{r['block_launches']} in block mode; wanted {want} and "
                    f"{want_block * TP_STEPS}")
    gaps = against(runs, TP_LOSS_RTOL, "bf16")
    # the same runs with fp32 compute, same seed: the first loss agrees to
    # fp32 summation order (the bf16 gap is bf16 rounding where the placed
    # program rounds: each rank's partial product of a row-parallel
    # layer), and the parameters after the first update differ only where
    # the taps' tipped roundings reached them
    f32 = dataclasses.replace(cfg, dtype="float32")
    whole = {}

    def keep(step, state):
        if step == 0:
            whole.update((k, t.detach().to("cpu", copy=True)) for k, t in
                         tree_lib.leaves_with_path(state.params))

    def compare(into):
        def fn(step, state):
            if step != 0:
                return
            n = differ = 0
            worst = 0.0
            for k, leaf in tree_lib.leaves_with_path(state.params):
                d = (gather_to_host(leaf) - whole[k]).abs()
                n += d.numel()
                differ += int(torch.count_nonzero(d))
                worst = max(worst, float(d.max()))
            into.update(elements=n, differ=differ, max_abs=worst)
        return fn

    runs32, flips = {"unsharded": run(f32, None, keep)}, {}
    for shape in TP_MESHES:
        flips[tag_of(shape)] = {}
        runs32[tag_of(shape)] = run(f32, shape, compare(flips[tag_of(shape)]))
    whole.clear()
    gaps32 = against(runs32, TP_LOSS_RTOL_F32, "fp32")
    grid = 2.0 ** -runs32["unsharded"]["formats"][0]["fl_w"]
    for tag, f in flips.items():
        f["share"] = f["differ"] / f["elements"]
        f["max_grid_steps"] = f["max_abs"] / grid
        if not (f["share"] <= TP_FLIP_SHARE[tag]
                and f["max_grid_steps"] <= TP_FLIP_STEPS):
            faults.append(f"fp32 {tag}: parameters after one update: {f}")
    say("train_llama_tp",
        command="launch.train.main(" + repr(argv) + ", mesh=make_mesh(shape, "
        "('data', 'model')))", model=cfg.name, layers=cfg.n_layers,
        batch=TP_BATCH, seq=512, runs=runs, loss_rel=gaps,
        first_loss_tolerance=TP_LOSS_RTOL, formats_equal=True,
        params_fp32_bytes=4 * int(cfg.n_params()),
        fp32=dict(runs=runs32, loss_rel=gaps32,
                  first_loss_tolerance=TP_LOSS_RTOL_F32, formats_equal=True,
                  params_after_first_update=flips,
                  flip_share_tolerance=TP_FLIP_SHARE,
                  flip_steps_tolerance=TP_FLIP_STEPS))
    if faults:
        raise AssertionError("train_llama_tp: " + "; ".join(faults))
    return {tag: {"block": r["block_launches"],
                  "k1b": r["launches"]["dps_quantize_onchip_prng"], "run": r}
            for tag, r in runs.items()}


def _placed_fingerprint(state):
    """Exact fingerprints of a placed state, taken on the device: each
    distinct block of every parameter and momentum leaf (by leaf key and
    block index) and each DPS tensor, ``(int64 sum of its 32-bit
    patterns, their max)``, as :func:`_fingerprint` takes a whole state's."""
    from repro_torch.checkpoint.ckpt import _walk
    from repro_torch.core import tree as tree_lib
    rows = {}

    def take(key, t):
        if t.element_size() != 4:
            raise AssertionError(f"fingerprint: {key} is {t.dtype}")
        bits = t.detach().contiguous().view(torch.int32)
        rows[key] = torch.stack([bits.sum(dtype=torch.int64),
                                 bits.max().to(torch.int64)])
    for name in ("params", "opt_state"):
        for path, leaf in tree_lib.leaves_with_path(getattr(state, name)):
            for r, b in leaf.distinct():
                take(f".{name}/{'/'.join(path)}#{r}", b)
    _walk(state.dps, ".dps", take)
    keys = sorted(rows)
    return dict(zip(keys, torch.stack([rows[k] for k in keys]).cpu()
                    .tolist()))


def guards_tp(tp_1x4):
    """llama3.2-3b at full width and depth (28 layers) on a stacked (1, 4)
    mesh, ``launch.train.main`` with ``train_llama_tp``'s argv (``--batch
    4 --seq 512``, SGD, K1b, 3 steps) plus ``--guards --inject-nan-at 1``:
    step 0's loss, formats and E_a bit-equal to ``train_llama_tp``'s (1, 4)
    bf16 step 0 (``tp_1x4``: armed idle guards are bit-transparent on the
    placed step); step 1 carries the nonfinite health bit and ``skipped``
    with every held block's fingerprint and the DPS state unchanged across
    it (read through ``on_step``); step 2 updates again.  K1b a step in
    block mode as ``_tp_launches_per_step`` counts it, the skipped step's
    too (it snaps as many blocks, its writes gated); ms a step against
    ``tp_1x4``'s unarmed reading: the guards' idle cost on the placed
    step (step 2 is a clean step; step 1 too, but for the selects it
    discards)."""
    from repro_torch.launch import train as train_cli
    from repro_torch.resilience import (HEALTH_GRADS_NONFINITE,
                                        HEALTH_SKIPPED, health_flags)
    cfg = get_config("llama3_2_3b")
    argv = ["--arch", "llama3_2_3b", "--steps", str(TP_STEPS), "--batch",
            str(TP_BATCH), "--seq", "512", "--optimizer", "sgd",
            "--log-every", "1", "--guards", "--inject-nan-at", "1"]
    fmt_keys = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")
    mesh = _stacked((1, 4))
    prints = {}

    def on_step(step, state):
        prints[step] = _placed_fingerprint(state)

    t0 = time.perf_counter()
    _reset_quant_counts()
    dps_quant.quantize_block_launch_count = 0
    out = train_cli.main(argv, on_step=on_step, cfg=cfg, mesh=mesh)
    hist = out["history"]
    per_step = out["quantizer_launches_per_step"]
    block = dps_quant.quantize_block_launch_count
    want, want_block = _tp_launches_per_step(cfg, mesh)
    faults = []
    first = {"loss": hist[0]["loss"], "E_a": hist[0]["E_a"],
             **{k: hist[0][k] for k in fmt_keys}}
    unarmed = {"loss": tp_1x4["losses"][0], "E_a": tp_1x4["E_a"][0],
               **tp_1x4["formats"][0]}
    if first != unarmed:
        faults.append(f"step 0 {first} against the unarmed {unarmed}")
    nan_skip = HEALTH_GRADS_NONFINITE | HEALTH_SKIPPED
    health = [int(h["health"]) for h in hist]
    if health[0] or health[1] & nan_skip != nan_skip or health[2] & nan_skip:
        faults.append(f"health {[health_flags(h) for h in health]}")
    if [h["skipped"] for h in hist] != [0, 1, 1]:
        faults.append(f"skipped {[h['skipped'] for h in hist]}")
    moved = sorted(k for k in prints[0] if prints[0][k] != prints[1][k])
    if moved:
        faults.append(f"the skipped step moved {moved[:8]} ({len(moved)})")
    moved2 = sum(prints[1][k] != prints[2][k] for k in prints[1]
                 if not k.startswith(".dps"))
    if not moved2:
        faults.append("step 2 moved no block")
    if per_step != [want] * TP_STEPS or block != want_block * TP_STEPS:
        faults.append(f"K1b {per_step} a step, "
                      f"{block} in block mode; wanted {want} and "
                      f"{want_block * TP_STEPS}")
    say("guards_tp", command="launch.train.main(" + repr(argv)
        + ", mesh=make_mesh((1, 4), ('data', 'model')))", model=cfg.name,
        layers=cfg.n_layers, losses=[h["loss"] for h in hist],
        health=[list(health_flags(h)) for h in health],
        skipped=[h["skipped"] for h in hist],
        step0_bit_equal_to_unarmed=first == unarmed,
        # step 1's forward reads the parameters step 0 updated (gated);
        # reported, not held: the two runs' backward sums need not be
        # bit-equal run to run
        step1_loss_vs_unarmed=[hist[1]["loss"], tp_1x4["losses"][1]],
        step1_formats_equal_to_unarmed=(
            {k: hist[1][k] for k in fmt_keys} == tp_1x4["formats"][1]),
        held_blocks_fingerprinted=sum(not k.startswith(".dps")
                                      for k in prints[0]),
        held_on_skip=not moved, blocks_moved_at_step_2=moved2,
        k1b_per_step=per_step,
        k1b_block_mode=block, k1b_per_step_predicted=want,
        ms_per_step_after_first=out["ms_per_step_after_first"],
        unarmed_ms_per_step_after_first=tp_1x4["ms"],
        first_step_s=out["first_step_s"],
        peak_memory_bytes=out["peak_memory_bytes"],
        unarmed_peak_memory_bytes=tp_1x4["peak"],
        seconds=time.perf_counter() - t0)
    del out, hist, prints
    gc.collect()
    torch.cuda.empty_cache()
    if faults:
        raise AssertionError("guards_tp: " + "; ".join(faults))
    return {"k1b": sum(per_step), "block": block}


def train_family_tp(model, layers, unsharded, phase):
    """``model`` at full width (cut to ``layers``) through
    ``launch.train.main`` with the argv of its unsharded run
    (``unsharded``, the ``train_<config>`` phase's: ``--batch 2 --seq
    512``, SGD, K1b) but ``TP_STEPS`` steps, placed on a stacked
    ``TP_FAMILY_MESH``: formats equal to the unsharded run's at every
    step, the later gaps reported; K1b a step (and in block mode) as
    :func:`_tp_launches_per_step` counts them; ms a step, peak, bytes a
    rank holds.  Then one step with fp32 compute, unsharded and placed:
    their first losses within ``TP_FAMILY_LOSS_RTOL_F32``.  The bf16 first
    loss is held within ``TP_LOSS_RTOL``, or twice the unsharded run's own
    bf16 first loss's distance from the fp32 one where that is larger: a
    placed run as close to the fp32 loss as the unsharded bf16 run lies
    within twice that of it, and bf16 rounding moves the SSM models' loss
    by 2e-4 to 6e-4 (the row-parallel products' partial sums round where
    the unsharded run's do not)."""
    from repro_torch.launch import train as train_cli
    cfg = depth_cut(model, layers)
    argv = list(unsharded["argv"])
    argv[argv.index("--steps") + 1] = str(TP_STEPS)
    fmt_keys = ("il_w", "fl_w", "il_a", "fl_a", "il_g", "fl_g")
    mesh = _stacked(TP_FAMILY_MESH)
    tag = f"{TP_FAMILY_MESH[0]}x{TP_FAMILY_MESH[1]}"

    def run(cfg_, mesh_, argv_):
        _reset_quant_counts()
        dps_quant.quantize_block_launch_count = 0
        t0 = time.perf_counter()
        out = train_cli.main(argv_, cfg=cfg_, mesh=mesh_)
        hist = out["history"]
        r = dict(losses=[h["loss"] for h in hist],
                 formats=[{k: h[k] for k in fmt_keys} for h in hist],
                 launches=_quant_counts(),
                 block=dps_quant.quantize_block_launch_count,
                 per_step=out["quantizer_launches_per_step"],
                 seconds=time.perf_counter() - t0,
                 **{k: out[k] for k in (
                     "ms_per_step_after_first", "first_step_s",
                     "peak_memory_bytes", "held_bytes_per_rank")})
        del out, hist
        gc.collect()
        torch.cuda.empty_cache()
        return r

    placed = run(cfg, mesh, argv)
    losses, formats = placed["losses"], placed["formats"]
    per_step, block = placed["per_step"], placed["block"]
    want, want_block = _tp_launches_per_step(cfg, mesh)
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, unsharded["losses"])]
    # the first step again with fp32 compute, unsharded and placed: the
    # forward agrees to fp32 summation order where bf16 rounds each rank's
    # partial product of a row-parallel layer
    argv1 = list(argv)
    argv1[argv1.index("--steps") + 1] = "1"
    f32 = dataclasses.replace(cfg, dtype="float32")
    first32 = [run(f32, m, argv1)["losses"][0] for m in (None, mesh)]
    gap32 = abs(first32[1] - first32[0]) / abs(first32[0])
    # bf16's own size on this model: the unsharded bf16 first loss against
    # the unsharded fp32 one
    bf16_own = abs(unsharded["losses"][0] - first32[0]) / abs(first32[0])
    limit = max(TP_LOSS_RTOL[tag], 2 * bf16_own)
    faults = []
    same = formats == unsharded["formats"][:TP_STEPS]
    if not same:
        faults.append(f"formats {formats} vs unsharded "
                      f"{unsharded['formats'][:TP_STEPS]}")
    if not all(math.isfinite(v) for v in losses) or not gaps[0] <= limit:
        faults.append(f"losses {losses} vs {unsharded['losses']}")
    if not gap32 <= TP_FAMILY_LOSS_RTOL_F32[model]:
        faults.append(f"fp32 first losses {first32}")
    if per_step != [want] * TP_STEPS or block != want_block * TP_STEPS:
        faults.append(f"K1b {per_step} a step, {block} in block mode; wanted "
                      f"{want} and {want_block * TP_STEPS}")
    say(phase, command="launch.train.main(" + repr(argv) + ", cfg=<"
        f"{model} at {cfg.n_layers} layers>, mesh=make_mesh("
        f"{TP_FAMILY_MESH}, ('data', 'model')))", model=cfg.name,
        layers=cfg.n_layers, layers_of=get_config(model).n_layers, mesh=tag,
        losses=losses, unsharded_losses=unsharded["losses"][:TP_STEPS],
        loss_rel=gaps, first_loss_tolerance=limit,
        bf16_vs_fp32_unsharded=bf16_own, formats_equal=same,
        unsharded_ms_per_step_after_first=unsharded["ms"],
        unsharded_peak_memory_bytes=unsharded["peak"],
        **{k: placed[k] for k in ("ms_per_step_after_first", "first_step_s",
                                  "peak_memory_bytes", "held_bytes_per_rank",
                                  "launches", "seconds")},
        k1b_per_step=per_step, k1b_block_mode=block,
        fp32_first_losses=first32, fp32_first_loss_rel=gap32,
        fp32_first_loss_tolerance=TP_FAMILY_LOSS_RTOL_F32[model])
    if faults:
        raise AssertionError(f"{phase}: " + "; ".join(faults))
    return {"k1b": placed["launches"]["dps_quantize_onchip_prng"],
            "block": block}


def train_tp_pg():
    """The process path on the card: a one-rank NCCL process group and its
    (1, 1) ``DeviceMesh``.  Each block collective of the
    ``ProcessGroupTransport`` (gather, reduce-scatter, psum, copy, pmax:
    on NCCL the library's ``reduce_scatter_tensor`` and ``all_reduce``),
    forward and backward on CUDA tensors, bit-equal to the stacked axis of
    one rank; then smoke llama3.2-3b's placed step (``make_placed_train_
    step``) over that mesh, 2 steps on K1b, finite losses."""
    import socket
    import torch.distributed as dist
    from repro_torch.configs.base import smoke
    from repro_torch.core import qtrain
    from repro_torch.dist.sharding import LogicalRules
    from repro_torch.dist.transport import (ProcessGroupTransport,
                                            StackedTransport)
    from repro_torch.data import TokenStream, TokenStreamConfig
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tr
    from repro_torch.optim import SGDConfig, make_optimizer
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        g = torch.Generator(device=DEV).manual_seed(5)
        x = torch.randn(64, 96, generator=g, device=DEV)
        cot = torch.randn(64, 96, generator=g, device=DEV)
        checked = []
        for name, op in (("gather", lambda t, a: t.gather_blocks(a, 1)),
                         ("reduce_scatter",
                          lambda t, a: t.reduce_scatter_blocks(a, 1)),
                         ("psum", lambda t, a: t.psum_blocks(a)),
                         ("psum_identity",
                          lambda t, a: t.psum_blocks(a, grad="identity")),
                         ("copy", lambda t, a: t.copy_blocks(a))):
            res = []
            for t in (ProcessGroupTransport(), StackedTransport(1, DEV)):
                a = [x.clone().requires_grad_()]
                y = op(t, a)
                (g,) = torch.autograd.grad(y, a, [cot])
                res.append((y[0].detach(), g))
            if not (torch.equal(res[0][0], res[1][0])
                    and torch.equal(res[0][1], res[1][1])):
                raise AssertionError(f"train_tp_pg: {name} over NCCL differs")
            checked.append(name)
        if not torch.equal(ProcessGroupTransport().pmax_blocks([x])[0], x):
            raise AssertionError("train_tp_pg: pmax over NCCL differs")
        checked.append("pmax")
        mesh = make_mesh((1, 1), ("data", "model"), device=DEV)
        cfg = dataclasses.replace(smoke(get_config("llama3_2_3b")),
                                  remat="full")
        mod = registry(cfg.family)
        params = init_params(mod.model_defs(cfg, cfg.master_dtype()), DEV,
                             torch.Generator(device=DEV).manual_seed(0))
        qcfg = qtrain.QuantConfig()
        opt = make_optimizer(SGDConfig())
        step = qtrain.make_placed_train_step(tr.placed_loss_fn(cfg), opt,
                                             qcfg, mesh, LogicalRules())
        state = qtrain.TrainState.create(params, opt.init(params), qcfg, 1)
        specs.place_train_state(cfg, state, mesh)
        data = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=16,
                                             global_batch=8, seed=0), DEV)
        _reset_quant_counts()
        losses = []
        for i in range(2):
            state, m = step(state, data.batch(i))
            losses.append(float(m["loss"]))
        launches = _quant_counts()
        if not all(math.isfinite(v) for v in losses) or \
                not launches["dps_quantize_onchip_prng"]:
            raise AssertionError(f"train_tp_pg: losses {losses}, launches "
                                 f"{launches}")
        say("train_tp_pg", backend=dist.get_backend(), world=1,
            collectives_bit_equal_to_stacked=checked,
            mesh=type(mesh).__name__, losses=losses, launches=launches)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 19: placed prefill and decode
# ---------------------------------------------------------------------------

def _whole(t):
    from repro_torch.dist.sharding import gather_placed, is_placed
    return gather_placed(t) if is_placed(t) else t


def _cache_leaves(cache, prefix=""):
    """``{key: leaf}`` of a decode cache (tuples and dicts)."""
    if isinstance(cache, tuple):
        cache = {str(i): c for i, c in enumerate(cache)}
    if isinstance(cache, dict):
        out = {}
        for k, c in cache.items():
            out.update(_cache_leaves(c, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: cache}


def _serve_tp_run(cfg, params, inputs, shape, feed=None, mesh=None,
                  bind=None):
    """``cfg`` served through ``launch.specs.build_prefill_step`` and
    ``build_decode_step(..., with_logits=True)``, whole or (``mesh``) on
    ``params`` placed by ``place_serve_state`` (the caller's), each input
    placed over ``batch`` here; ``bind``: the mesh a whole run's MoE
    layers take their dispatch under.  Prefill, then one step a column of
    ``feed`` (B, n) (None: the run's own greedy tokens, ``shape["steps"]``
    of them), each timed with a synchronize.  Returns the logits (prefill
    and each step, whole, fp32, over the real vocabulary), the greedy
    tokens, the cache (placed when placed) and ``pos``, times, peak, the
    bytes each rank holds of the cache beside ``spec_bytes`` of
    ``decode_shardings``' cache, and the kernel launches."""
    from repro_torch.dist.sharding import (LogicalRules, axis_rules,
                                           held_bytes, spec_bytes)
    from repro_torch.launch import specs
    V, B = cfg.vocab, shape["batch"]
    prefill = specs.build_prefill_step(cfg, shape["max_seq"], mesh=mesh)
    step = specs.build_decode_step(cfg, mesh=mesh, with_logits=True)
    ctx = (axis_rules(bind, LogicalRules()) if bind is not None
           else contextlib.nullcontext())
    if mesh is not None:
        inputs = specs.place_serve_state(cfg, mesh, **inputs)
    put = (lambda t: t) if mesh is None else (
        lambda t: specs.place_serve_state(cfg, mesh, tokens=t)["tokens"])
    n = shape["steps"] if feed is None else feed.shape[1]
    _reset_quant_counts()
    dps_quant.launch_count = paged_attn.launch_count = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), ctx:
        t0 = time.perf_counter()
        logits, cache, pos = prefill(params, **inputs)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out = dict(logits=[_whole(logits)[:, :V].float()], next=[], fed=[])
        tok = out["logits"][0].argmax(-1, keepdim=True).to(torch.int32)
        ms = []
        for i in range(n):
            if feed is not None:
                tok = feed[:, i:i + 1]
            t = put(tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nxt, cache, pos, lg = step(params, t, cache, pos)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            out["fed"].append(tok)
            tok = _whole(nxt)
            out["logits"].append(_whole(lg)[:, :V].float())
            out["next"].append(tok)
    out.update(
        cache=cache, pos=_whole(pos), prefill_s=prefill_s,
        p50_ms=float(np.percentile(ms, 50)),
        p95_ms=float(np.percentile(ms, 95)),
        peak=torch.cuda.max_memory_allocated(),
        launches=dict(_quant_counts(),
                      dps_group_wire_encode=dps_quant.launch_count,
                      paged_decode_attn=paged_attn.launch_count))
    if any(out["launches"].values()):
        raise AssertionError(f"{cfg.name} served {'placed' if mesh else ''}"
                             f" launched {out['launches']}")
    if not all(bool(torch.isfinite(l).all()) for l in out["logits"]):
        raise AssertionError(f"{cfg.name}: logits not finite")
    out["next"] = torch.cat(out["next"], 1)
    out["fed"] = torch.cat(out["fed"], 1)
    if mesh is not None:
        sh = specs.decode_shardings(
            cfg, type("S", (), {"batch": B, "seq": shape["max_seq"]})(), mesh,
            LogicalRules())
        out["held_bytes"] = held_bytes(cache)
        out["spec_bytes"] = spec_bytes(registry(cfg.family).cache_struct(
            cfg, B, shape["max_seq"]), sh["cache"], mesh)
        if out["held_bytes"] != [out["spec_bytes"]] * mesh.size:
            raise AssertionError(f"{cfg.name}: a rank holds "
                                 f"{out['held_bytes']} B of the cache, "
                                 f"decode_shardings {out['spec_bytes']}")
    else:
        out["cache_bytes"] = _nbytes(cache)
    return out


def _logit_err(a, b):
    """max over the steps of max |a - b|, over the largest |b|."""
    big = max(float(t.abs().max()) for t in b)
    return max(float((x - y).abs().max()) for x, y in zip(a, b)) / big


def _top2_margin(logits):
    """(steps, B) the gap between the two largest logits of each row of
    each decode step, over the largest |logit| of the run."""
    big = max(float(t.abs().max()) for t in logits)
    top = torch.stack([l.topk(2, dim=-1).values for l in logits[1:]])
    return (top[..., 0] - top[..., 1]) / big


def _compare(placed, whole, twin=None):
    """A placed run against the unsharded run of the same config: the
    logits' relative error, the greedy tokens' agreement by the unsharded
    top-2 margin, each cache leaf's error (relative for a float cache; for
    an int8 one the largest step in grid units, how many entries moved,
    and, given ``twin`` — the fp32 16-bit cache of the same weights — how
    close to a rounding boundary the moved entries of the prompt's
    positions lie there), and ``pos`` equal."""
    out = dict(logits=_logit_err(placed["logits"], whole["logits"]),
               pos_equal=bool(torch.equal(placed["pos"], whole["pos"])))
    margin = _top2_margin(whole["logits"])
    agree = (placed["next"] == whole["next"]).T          # (steps, B)
    out["tokens"] = dict(margin=margin, agree=agree)
    caches = {}
    wl = _cache_leaves(whole["cache"])
    tl = _cache_leaves(twin) if twin is not None else {}
    for k, leaf in _cache_leaves(placed["cache"]).items():
        got, want = _whole(leaf), wl[k]
        if got.dtype == torch.int8:
            d = (got.int() - want.int()).abs()
            c = dict(max_steps=int(d.max()), moved=int((d > 0).sum()),
                     entries=d.numel())
            if k in tl and c["moved"]:
                S = SERVE_TP_SHAPE["prompt"]
                off = d[:, :, :S] > 0
                t = tl[k][:, :, :S].float()[off] * 32
                c["prompt_moved"] = int(off.sum())
                c["boundary_dist_steps"] = float(
                    (t - t.floor() - 0.5).abs().max()) if off.any() else 0.0
                c["twin_max_abs"] = float(tl[k].float().abs().max())
            caches[k] = c
        else:
            caches[k] = dict(rel=_rel_max(got, want))
    out["cache"] = caches
    return out


def _hold(name, model, cmp, dtype, gaps=None, faults=None, int8=False):
    """``cmp`` (:func:`_compare`) held: fp32 to ``model``'s
    ``SERVE_TP_F32_RTOL`` (int8
    caches one grid step at most, and off only next to a rounding
    boundary of the fp32 cache at the prompt's positions), bf16 to
    ``SERVE_TP_BF16_GAPS`` x ``gaps`` (bf16's own distance from fp32 for
    each quantity; the fp32 logits over an ``int8`` cache to
    ``SERVE_TP_F32_INT8_RTOL``); the greedy tokens equal wherever the unsharded top-2
    margin exceeds that limit; ``pos`` equal.  Returns the limits; a miss
    is appended to ``faults``."""
    def lim(key):
        if dtype == "float32":
            return SERVE_TP_F32_RTOL[model]
        return SERVE_TP_BF16_GAPS * gaps[key]
    limits = {"logits": SERVE_TP_F32_INT8_RTOL if int8 and dtype == "float32"
              else lim("logits")}
    if not cmp["logits"] <= limits["logits"]:
        faults.append(f"{name}: logits {cmp['logits']} > {limits['logits']}")
    clear = cmp["tokens"]["margin"] > limits["logits"]
    bad = int((~cmp["tokens"]["agree"] & clear).sum())
    cmp["tokens"] = dict(clear=int(clear.sum()), of=clear.numel(),
                         agree_where_clear=int(clear.sum()) - bad,
                         agree=int(cmp["tokens"]["agree"].sum()))
    if bad:
        faults.append(f"{name}: {bad} greedy tokens differ past the margin")
    if not cmp["pos_equal"]:
        faults.append(f"{name}: pos differs")
    for k, c in cmp["cache"].items():
        if "rel" in c:
            limits[k] = lim(k)
            if not c["rel"] <= limits[k]:
                faults.append(f"{name}: cache {k} {c['rel']} > {limits[k]}")
        elif dtype == "float32":
            # in grid steps: 32 x the fp32 tolerance on the cache's values
            limits[k] = 32 * lim(k) * c.get("twin_max_abs", 0.0)
            if c["moved"] and not (c["max_steps"] <= 1 and c.get(
                    "boundary_dist_steps", 0.0) <= limits[k]):
                faults.append(f"{name}: int8 cache {k} {c} (boundary "
                              f"limit {limits[k]} steps)")
        else:
            limits[k] = max(1.0, lim(k))
            if not c["max_steps"] <= limits[k]:
                faults.append(f"{name}: int8 cache {k} {c} > {limits[k]}")
    return limits


def _bf16_gaps(bf16, fp32):
    """bf16's own distance from fp32 at the same weights, per quantity:
    the logits' relative error, each float cache leaf's, and each int8
    cache leaf's largest step in grid units."""
    gaps = {"logits": _logit_err(bf16["logits"], fp32["logits"])}
    f = _cache_leaves(fp32["cache"])
    for k, leaf in _cache_leaves(bf16["cache"]).items():
        if leaf.dtype == torch.int8:
            gaps[k] = float((leaf.int() - f[k].int()).abs().max())
        else:
            gaps[k] = _rel_max(leaf, f[k])
    return gaps


def _summary(r):
    keys = ("prefill_s", "p50_ms", "p95_ms", "peak", "held_bytes",
            "spec_bytes", "cache_bytes", "launches")
    return {k: r[k] for k in keys if k in r}


def _place_copy(cfg, params, mesh):
    """A copy of the whole ``params`` placed over ``mesh`` (the copy's
    whole leaves freed as they are placed)."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch import specs
    return specs.place_serve_state(
        cfg, mesh, params=tree_lib.map_tree(torch.clone, params))["params"]


def serve_llama_tp():
    """llama3.2-3b at full width, ``SERVE_TP_LAYERS`` of its 28 layers, bf16
    weights from seed 0, served through ``build_prefill_step``/``build_decode_step``:
    unsharded, then on stacked (1, 4) and (2, 4) meshes (the state placed
    by ``place_serve_state``: tensor parallelism over model, the batch
    over data), with the cache in bf16 and in int8 (``kv_cache_bits``
    8); then all of it again with the weights cast up to fp32.  Every run
    fed the unsharded bf16 run's greedy tokens.  Held per run, against
    the unsharded run of its config (``_hold``): logits, greedy tokens,
    the gathered cache, ``pos``; the bytes each rank holds equal to
    ``spec_bytes`` of ``decode_shardings``' cache; no kernel launched
    (the contiguous path is jnp in the reference).  Prints prefill s,
    p50/p95 ms a decode step and the peak of each run."""
    from repro_torch.core import tree as tree_lib
    gc.collect()
    torch.cuda.empty_cache()
    cfg = depth_cut("llama3_2_3b", SERVE_TP_LAYERS)
    shape = SERVE_TP_SHAPE
    B, S = shape["batch"], shape["prompt"]
    g = torch.Generator(device=DEV).manual_seed(1)
    inputs = {"tokens": torch.randint(1, cfg.vocab, (B, S), generator=g,
                                      device=DEV, dtype=torch.int32)}
    params = init_params(registry(cfg.family).model_defs(cfg), DEV,
                         torch.Generator(device=DEV).manual_seed(0))
    warm = dict(shape, prompt=64, steps=1, max_seq=80)
    _serve_tp_run(cfg, params, {"tokens": inputs["tokens"][:, :64]}, warm)
    faults, runs, cmps, feed = [], {}, {}, None
    bits_of = (("bf16_cache", 16), ("int8_cache", 8))
    for dtype in ("bfloat16", "float32"):
        if dtype == "float32":
            params = tree_lib.map_tree(lambda t: t.float(), params)
        for cache, bits in bits_of:
            c = dataclasses.replace(cfg, dtype=dtype, kv_cache_bits=bits)
            r = _serve_tp_run(c, params, inputs, shape, feed)
            if feed is None:
                feed = r["fed"]
            runs[f"{dtype}/{cache}/unsharded"] = r
        for m in TP_MESHES:
            mesh = _stacked(m)
            placed = _place_copy(cfg, params, mesh)
            for cache, bits in bits_of:
                c = dataclasses.replace(cfg, dtype=dtype, kv_cache_bits=bits)
                tag = f"{dtype}/{cache}"
                r = _serve_tp_run(c, placed, inputs, shape, feed, mesh)
                twin = (runs["float32/bf16_cache/unsharded"]["cache"]
                        if dtype == "float32" and bits == 8 else None)
                cmps[f"{tag}/{m[0]}x{m[1]}"] = _compare(
                    r, runs[f"{tag}/unsharded"], twin)
                runs[f"{tag}/{m[0]}x{m[1]}"] = _summary(r)
                del r
            del placed
            gc.collect()
            torch.cuda.empty_cache()
    del params
    gaps = {cache: _bf16_gaps(runs[f"bfloat16/{cache}/unsharded"],
                              runs[f"float32/{cache}/unsharded"])
            for cache, _ in bits_of}
    limits = {}
    for tag, cmp in cmps.items():
        dtype, cache, _ = tag.split("/")
        limits[tag] = _hold(f"serve_llama_tp {tag}", "llama3_2_3b", cmp,
                            dtype, gaps.get(cache), faults,
                            cache == "int8_cache")
    for k in [k for k in runs if k.endswith("unsharded")]:
        runs[k] = _summary(runs[k])
    gc.collect()
    torch.cuda.empty_cache()
    say("serve_llama_tp", model=cfg.name, layers=cfg.n_layers,
        entry="launch.specs.build_prefill_step/build_decode_step(cfg, "
        "max_seq, mesh=make_mesh(shape, ('data', 'model')))", **shape,
        teacher_forced="the unsharded bf16 run's greedy tokens",
        runs=runs, vs_unsharded=cmps, limits=limits, bf16_vs_fp32=gaps)
    if faults:
        raise AssertionError("serve_llama_tp: " + "; ".join(faults))


def _expert_gather_bytes(cfg, params, mesh):
    """The bytes of expert weights one rank gathers in a decode step of
    the placed ``params``: layer 0's MoE at decode (B, 1, D) run under a
    trace, the collectives that take a block of ``w_in``, ``w_gate`` or
    ``w_out`` counted (one rank's payload each), times the layers."""
    from repro_torch.analysis.trace import Trace
    from repro_torch.dist.sharding import LogicalRules, axis_rules, place_tensor
    from repro_torch.dist.transport import shared_outputs
    from repro_torch.models import moe, transformer
    layer = transformer.unbind_layers(params["layers"], cfg.n_layers)[0]["moe"]
    rules, B, D = LogicalRules(), SERVE_TP_FAMILY_SHAPE["batch"], cfg.d_model
    g = torch.Generator(device=DEV).manual_seed(2)
    x = place_tensor(torch.randn(B, 1, D, generator=g, device=DEV).to(
        cfg.activation_dtype()), rules.spec(("batch", None, None), (B, 1, D),
                                            mesh), mesh)
    experts = {id(b) for k in ("w_in", "w_gate", "w_out")
               for b in layer[k].blocks}
    with torch.no_grad(), shared_outputs(), axis_rules(mesh, rules), \
            Trace(ops=False) as tr:
        moe.moe_apply(cfg, layer, x)
    out = cfg.n_layers * sum(n.meta["nbytes"] for n in tr.of_kind("collective")
                             if experts & set(n.inputs))
    tr.release()
    return out


def serve_families_tp():
    """Every other family served placed on a stacked (1, 4) mesh at full
    width (``SERVE_TP_FAMILIES``' depths), bf16 weights from seed 0 and
    the same weights cast up to fp32, each unsharded then placed, fed the
    unsharded bf16 run's greedy tokens: deepseek-v2 (MLA's absorbed
    decode, its latent cache whole on every model rank; MoE), qwen3-moe
    (both MoE models' prefill on the all-to-all, each rank's capacity, the
    unsharded run under the mesh's binding so that it takes it too;
    decode on the einsum), internvl2 (the prompt behind its 256-patch
    prefix, seeded), mamba2, zamba2 and whisper (seeded frames).  Held as
    ``serve_llama_tp`` holds its runs."""
    from repro_torch.core import tree as tree_lib
    mesh = _stacked(TP_FAMILY_MESH)
    out, faults = {}, []
    for model, layers in SERVE_TP_FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        t_start = time.perf_counter()
        cfg = depth_cut(model, layers)
        B, S = (SERVE_TP_FAMILY_SHAPE[k] for k in ("batch", "prompt"))
        prefix = cfg.n_patches if cfg.family == "vlm" else 0
        shape = dict(SERVE_TP_FAMILY_SHAPE,
                     max_seq=SERVE_TP_FAMILY_SHAPE["max_seq"] + prefix)
        g = torch.Generator(device=DEV).manual_seed(1)
        inputs = {"tokens": torch.randint(1, cfg.vocab, (B, S), generator=g,
                                          device=DEV, dtype=torch.int32)}
        if prefix:
            inputs["vision_embeds"] = torch.randn(
                B, prefix, cfg.d_model, generator=g, device=DEV).to(
                    cfg.activation_dtype())
        if cfg.family == "encdec":
            inputs["frames"] = torch.randn(B, cfg.enc_seq, cfg.d_model,
                                           generator=g, device=DEV)
        params = init_params(registry(cfg.family).model_defs(cfg), DEV,
                             torch.Generator(device=DEV).manual_seed(0))
        bind = mesh if cfg.n_experts else None
        # warm-up: a short unsharded run, so the first timed one is not
        # the first of its shapes' kernels
        _serve_tp_run(cfg, params, {k: v[:, :64] if k == "tokens" else v
                                    for k, v in inputs.items()},
                      dict(shape, prompt=64, steps=1,
                           max_seq=64 + prefix + 1), bind=bind)
        runs, res, feed = {}, {}, None
        for dtype in ("bfloat16", "float32"):
            c = dataclasses.replace(cfg, dtype=dtype)
            if dtype == "float32":
                params = tree_lib.map_tree(lambda t: t.float(), params)
                inputs = {k: v.float() if v.is_floating_point() else v
                          for k, v in inputs.items()}
            whole = _serve_tp_run(c, params, inputs, shape, feed, bind=bind)
            if feed is None:
                feed = whole["fed"]
            if dtype == "float32":
                # placed in place: the whole copy is freed as it goes
                from repro_torch.launch import specs
                placed = specs.place_serve_state(c, mesh,
                                                 params=params)["params"]
                params = None
            else:
                placed = _place_copy(c, params, mesh)
            r = _serve_tp_run(c, placed, inputs, shape, feed, mesh)
            if dtype == "bfloat16" and cfg.n_experts:
                gathered = _expert_gather_bytes(c, placed, mesh)
                if gathered:
                    faults.append(f"serve_families_tp {model}: {gathered} "
                                  "bytes of expert weights gathered a "
                                  "decode step")
            del placed
            res[dtype] = (whole, _compare(r, whole))
            runs[dtype] = {"unsharded": _summary(whole),
                           "1x4": _summary(r)}
            del r
            gc.collect()
            torch.cuda.empty_cache()
        gaps = _bf16_gaps(res["bfloat16"][0], res["float32"][0])
        limits = {dtype: _hold(f"serve_families_tp {model} {dtype}", model,
                               cmp, dtype, gaps, faults)
                  for dtype, (_, cmp) in res.items()}
        out[model] = dict(
            layers=cfg.n_layers, layers_of=get_config(model).n_layers,
            prefix=prefix, **({"frames": cfg.enc_seq}
                              if cfg.family == "encdec" else {}),
            runs=runs, vs_unsharded={d: c for d, (_, c) in res.items()},
            limits=limits, bf16_vs_fp32=gaps,
            **({"expert_gather_bytes_a_decode_step": gathered}
               if cfg.n_experts else {}),
            seconds=time.perf_counter() - t_start)
        del res, params
    gc.collect()
    torch.cuda.empty_cache()
    say("serve_families_tp", mesh=list(TP_FAMILY_MESH),
        shape=SERVE_TP_FAMILY_SHAPE, configs=out)
    if faults:
        raise AssertionError("serve_families_tp: " + "; ".join(faults))


# phase 20: (config, mode, guards) lint cells run on the card
ANALYSIS_CELLS = (("lenet", "tree", False), ("lenet", "zero-overlap", False),
                  ("lenet", "tree", True), ("lenet", "serve-decode", False))
# the kernels the cells must launch under the trace: (name, module, counter)
ANALYSIS_KERNELS = (
    ("dps_quant_wire_onchip_prng", dps_quant, "wire_prng_launch_count"),
    ("dps_group_wire_encode_onchip_prng", dps_quant,
     "group_prng_launch_count"),
    ("dps_wire_reduce", dps_quant, "reduce_launch_count"),
    ("dps_group_wire_encode", dps_quant, "launch_count"),
    ("paged_decode_attn", paged_attn, "launch_count"))


def analysis_check():
    """Phase 20: the lint cells of ``ANALYSIS_CELLS`` on the card, every
    report clean, each kernel of ``ANALYSIS_KERNELS`` launched under the
    trace and every recorded launch checked; one dry-run cell."""
    from repro_torch.analysis import lint as lint_mod
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    for _, mod, counter in ANALYSIS_KERNELS:
        setattr(mod, counter, 0)
    reports = {}
    for config, mode, guards in ANALYSIS_CELLS:
        for r in lint_mod.lint_cell(config, mode, lint_mod.DEFAULT_RANKS,
                                    DEV, guards=guards):
            if not r.ok:
                raise AssertionError(f"analysis: {r.summary()}")
            reports[r.name + ("+guards" if guards else "")] = {
                "checked": sorted(r.checked), "fired": list(r.rules_fired())}
    launched = {name: getattr(mod, counter)
                for name, mod, counter in ANALYSIS_KERNELS}
    missing = [k for k, v in launched.items() if v < 1]
    if missing:
        raise AssertionError(f"analysis: {missing} not launched under the "
                             "trace")
    checked = [n for n in reports if "launches" in n]
    if len(checked) < len(ANALYSIS_CELLS):
        raise AssertionError(f"analysis: recorded launches checked in "
                             f"{checked} only")
    lint_s = time.perf_counter() - t0
    cell = dryrun.run_cell("llama3_2_3b", "decode_32k", "single")
    say("analysis", seconds=time.perf_counter() - t0, lint_seconds=lint_s,
        launches=launched, reports=reports,
        dryrun={k: cell[k] for k in ("arch", "shape", "mesh", "state_bytes",
                                     "batch_bytes", "spec_bytes", "flops",
                                     "collective_wire_bytes", "seconds")})


def main():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    say("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.load(verbose=True)
    say("build", seconds=time.perf_counter() - t0,
        nvcc_seconds=_build.build_seconds,
        sources=[os.path.relpath(p, ROOT) for p in _build.sources()],
        library=os.path.relpath(_build.build(), ROOT))

    cfg = get_config("llama3_2_3b")
    lay = serve_layout()
    rows = kernel_checks(cfg, lay)
    rows += quant_checks(cfg)
    # K1b's block mode at the placed step's w_in blocks; its launches are
    # read from the placed runs below (a row's "run")
    rows += k1b_block_rows()
    rows += train_shape_rows()
    rows += wire_kernel_checks(cfg)
    rows += mamba_wire_rows()
    # the w_in bucket's leg-2 K3b read by torch.profiler while its sessions
    # record (its row comes with the ZeRO phases)
    k3b_bucket = zero_bucket_k3b_kernels(cfg)
    # each path runs with the counts set to 0 just before it, read just after
    launches = serve(cfg, lay)
    gc.collect()
    torch.cuda.empty_cache()                   # the serving engine's memory
    # the other configs' paths, each counted on its own; a row of theirs
    # names its run
    other = {}
    for model, layers in OTHER_SERVE:
        other[f"serve_{model}"] = serve(depth_cut(model, layers), lay, model)
        gc.collect()
        torch.cuda.empty_cache()
    lenet_k1 = lenet()["dps_quantize"]
    family_runs = {}
    fig4_k1b = paper_fig4()
    other["paper_fig4"] = {"dps_quantize_onchip_prng": fig4_k1b}
    llama = train_lm(cfg, "onchip", 4)
    launches["dps_quantize_onchip_prng"] = llama["launches"][
        "dps_quantize_onchip_prng"]
    launches["dps_quantize"] = train_lm(cfg, "operand", 3)["launches"][
        "dps_quantize"]
    runs = {}
    for model, layers, batch, _ in OTHER_TRAIN:
        runs[model] = train_lm(depth_cut(model, layers), "onchip", 4,
                               batch=batch, model=model)
        other[f"train_{model}"] = runs[model]["launches"]
        family_runs[model] = runs[model]
    # MoE expert parallelism: the all-to-all dispatch at full geometry, then
    # qwen3-moe trained over a stacked model axis
    moe_a2a_check()
    ep_k1b = train_qwen_ep(runs["qwen3_moe_30b_a3b"])
    del runs
    # the SSM, hybrid and encoder-decoder families
    for model, layers, batch, _, phase in FAMILY_TRAIN:
        family_runs[model] = train_lm(depth_cut(model, layers), "onchip", 4,
                                      batch=batch, model=model, phase=phase)
        other[f"train_{model}"] = family_runs[model]["launches"]
    # long-context training: the blockwise attention on the card, then
    # llama3.2-3b at sequence 4,096 (every layer's attention blockwise),
    # then remat="dots" beside the full remat of the run above
    flash_check(cfg)
    serve_deepseek()
    mla_check()
    ssd_check()
    for model, layers, phase in FAMILY_SERVE:
        serve_family(model, layers, phase)
    long_run = train_lm(cfg, "onchip", 3, batch=1, seq=LONG_SEQ,
                        phase="train_long")
    dots = train_lm(dataclasses.replace(cfg, remat="dots"), "onchip", 4,
                    phase="train_dots")
    say("dots_vs_full", dots_ms_per_step=dots["ms"], full_ms_per_step=llama["ms"],
        dots_peak_memory_bytes=dots["peak"], full_peak_memory_bytes=llama["peak"],
        launches_equal=dots["launches"] == llama["launches"])
    if dots["launches"] != llama["launches"]:
        raise AssertionError(f"remat='dots' launched {dots['launches']}, full "
                             f"remat {llama['launches']}")
    # the sharded train step: K1b in block mode, one llama layer placed,
    # llama3.2-3b trained placed on stacked (1, 4) and (2, 4) meshes, the
    # process path over a one-rank NCCL group
    tp_check()
    tp_runs = train_llama_tp()
    other["train_llama_tp"] = {"dps_quantize_block": tp_runs["1x4"]["block"]}
    other["train_llama_tp_2x4"] = {
        "dps_quantize_block": tp_runs["2x4"]["block"]}
    # the health guards and the NaN drill on the placed step, held to the
    # unarmed (1, 4) run above
    guards_placed = guards_tp(tp_runs["1x4"]["run"])
    train_tp_pg()
    # every other family on the placed step: each placed layer at full
    # geometry, then each trained placed against its unsharded run above
    tp_families_check()
    tp_family = {phase: train_family_tp(model, layers, family_runs[model],
                                        phase)
                 for model, layers, phase in TP_FAMILY_TRAIN}
    del family_runs
    # placed prefill and decode: llama3.2-3b whole on (1, 4) and (2, 4),
    # then every other family on (1, 4)
    serve_llama_tp()
    serve_families_tp()
    wire_collectives()
    # the counted wire run: run A of the guards' phases
    wire, wire_losses, run_a = train_wire(cfg)
    for k in ("dps_quant_wire_onchip_prng",
              "dps_group_wire_encode_onchip_prng", "dps_wire_reduce"):
        launches[k] = wire[k]
    ckpt_resume()
    ckpt_corrupt()
    guards_idle(cfg, run_a)
    guards_nan(cfg, run_a)
    rollback()
    del run_a
    launches["dps_quant_wire"] = train_wire(
        cfg, steps=2, rounding_bits="operand")[0]["dps_quant_wire"]
    # the int8 wire at mamba2-1.3b's leaves, full depth
    mamba_wire = train_wire(get_config("mamba2_1_3b"), MAMBA_WIRE["steps"],
                            MAMBA_WIRE["n_ranks"], model="mamba2_1_3b",
                            batch=MAMBA_WIRE["batch"],
                            phase="train_wire_mamba2")[0]
    # ZeRO-1 and the overlapped wire: the halves on the card, LeNet's int8
    # params leg, then the trainer at full width without and with the
    # overlap; each run counted from 0
    zero_collectives()
    rows += zero_bucket_check(cfg, k3b_bucket)
    bucket_rows, k4_step_ms = k4_buckets(cfg)
    for r in rows:
        if r["name"] == "dps_wire_reduce_zero_bucket":
            r["k4_buckets"] = [{k: b[k] for k in ("bucket", "chunk", "ms",
                                                  "bound_ms")}
                               for b in bucket_rows]
            r["k4_ms_a_step_overlap"] = k4_step_ms
    zero_launches = {"lenet_zero": lenet_zero()}
    zero_hist, zero_summary = {}, {}
    for run, overlap in (("zero", False), ("zero_overlap", True)):
        zero_launches[run], zero_hist[run], zero_summary[run] = train_zero(
            cfg, wire_losses[0], overlap)
    zero_losses = {run: [h["loss"] for h in hist]
                   for run, hist in zero_hist.items()}
    rel = {run: max(abs(a - b) / abs(b) for a, b in
                    zip(ls[1:], wire_losses[1:]))
           for run, ls in zero_losses.items()}
    if max(rel.values()) > ZERO_LOSS_RTOL:
        raise AssertionError(f"ZeRO training: losses after the first differ "
                             f"from the wire run's by {rel} relative "
                             f"(> {ZERO_LOSS_RTOL})")
    # the overlap changes when and in what pieces the wire runs, not what it
    # computes: every metric of every step (losses, every domain's formats,
    # E/R, E_wire/R_wire) bit-equal to the run without it
    metrics = [{k: v for k, v in h.items()
                if k not in ("launches", "kernel_launches")}
               for h in zero_hist["zero"]]
    over = [{k: v for k, v in h.items()
             if k not in ("launches", "kernel_launches")}
            for h in zero_hist["zero_overlap"]]
    if metrics != over:
        diff = sorted({k for a, b in zip(metrics, over) for k in a
                       if a[k] != b.get(k)})
        raise AssertionError(f"ZeRO training: the overlap run differs from "
                             f"the run without it in {diff}")
    say("zero_vs_wire", wire_losses=wire_losses, zero_losses=zero_losses,
        loss_max_rel_after_first=rel, tolerance=ZERO_LOSS_RTOL,
        step1_bit_equal=True, overlap_bit_equal_metrics=sorted(metrics[0]))
    # the health guards and the NaN drill on ZeRO-1 and the overlapped wire
    guards_zero_idle(zero_hist["zero_overlap"], zero_summary["zero_overlap"])
    guards_zero_nan(zero_hist["zero"], overlap=False)
    guards_zero_nan(zero_hist["zero_overlap"], overlap=True)
    # the verifier on the card, after every counted path above
    analysis_check()
    # a row measured at the overlap run's bucket shape takes that run's
    # launches; the rows of the same counters at other shapes do not
    at_bucket = {(r["run"], r["counter"]) for r in rows if "run" in r}
    runs = {**zero_launches, **other, "train_wire_mamba2": mamba_wire}
    for r in rows:
        if "run" in r:
            r["launches"] = runs[r["run"]][r["counter"]]
        else:
            # a row off the path (K5 at a long context) has no launches
            r["launches"] = (launches[r["name"]] if r.get("on_path", True)
                             else 0)
        if r.get("on_path", True) and r["launches"] < 1:
            raise AssertionError(f"{r['name']} was not launched on the main path")
        if r["name"] == "dps_quantize":
            r["launches_lenet"] = lenet_k1
        if r["name"] == "dps_quantize_onchip_prng":
            r["launches_train_long"] = long_run["launches"][r["name"]]
            r["launches_train_dots"] = dots["launches"][r["name"]]
            r["launches_paper_fig4"] = fig4_k1b
            r["launches_train_qwen_ep"] = ep_k1b[r["name"]]
            for tag in ("1x4", "2x4"):
                r[f"launches_train_llama_tp_{tag}"] = tp_runs[tag]["k1b"]
            r["launches_guards_tp"] = guards_placed["k1b"]
            for phase, counts in tp_family.items():
                r[f"launches_{phase}"] = counts["k1b"]
        if r["name"] == "dps_quantize_onchip_prng_block":
            r["launches_train_llama_tp_2x4"] = tp_runs["2x4"]["block"]
            r["launches_guards_tp"] = guards_placed["block"]
            for phase, counts in tp_family.items():
                r[f"launches_{phase}"] = counts["block"]
        for run, counts in zero_launches.items():
            if ("run" not in r and counts.get(r["name"])
                    and (run, r["name"]) not in at_bucket):
                r[f"launches_{run}"] = counts[r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
