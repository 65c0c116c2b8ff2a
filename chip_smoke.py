#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

  python3 chip_smoke.py

Phases, each printing its findings and its seconds (any failure exits
non-zero before the result line is printed):

1. device  -- the card's name and power limit (nvidia-smi);
2. build   -- compile the seven kernel sources of ``src/repro_torch/csrc``
              with nvcc, one process per source, and print ptxas
              registers / spills (for the six kernels redesigned for
              Hopper, fused_matmul.cu, chunk_prefill_attn.cu,
              slstm_cell.cu, decode_layer.cu, decode_attn.cu and
              mlstm_chunk.cu, the report's lines as ptxas prints them);
3. kernels -- each Hopper kernel against its plain PyTorch version: the
              dense kernels at the tinyllama-1.1b width (M=4, B=4, S=1024,
              C=32, D=2048, H=32, KVH=4, hd=64, F=5632, V=32000), the sLSTM
              cell at the xlstm-1.3b width (M=4, B=4, D=2048, H=4, hd=512,
              S=1 and 32), and at the hymba-1.5b width (H=25, KVH=5, hd=64)
              the decode attention (S=1536, mixed kv_len), the chunk
              attention at both of its geometries (SWA ring: S=1152,
              pin=128, window=1024, sink=128; global: S=1536,
              window=1<<30) and the logits at D=1600, V=32001; the merged
              matmul at (M, T, D, F) = (4, 4, 2048, 5632) and (32, 128, 768,
              3072) with and without bias and at T=77; the group RMS norm
              at (32, 128, 768) and (4, 128, 2048) with an f32 scale, and
              at (32, 128, 768) with the scale in x's dtype (the
              profiler's); the chunkwise mLSTM at
              the xlstm-1.3b profiler shape (M=B=H=4, S=32, hd=1024, chunk
              32) and over four chunks of 64 (S=256, hd=128) with
              gate-neutral padded steps, h and the final C, n, m compared,
              and junk in the padded steps changing nothing bit for bit;
              the attention and FFN phases of the sharded decode layer at a
              rank's widths of tinyllama-1.1b at TP=2 (H=16, KVH=2, F=2816)
              over a wrapped ring with lanes frozen by ``alive``, at M=4
              and at a data rank's M_L=2, and the whole layer and the
              logits (V and a rank's V/2) at M_L=2; the
              sharded decode attention at the hymba-1.5b width for the
              plan of each rank count (None at TP=2, "kv" at TP=5,
              "expand" at TP=25, also against the repeat form), every
              rank's block through the wrapper in this process;
              ``fused_matmul_sharded`` on every rank's block at meshes
              1x2, 2x1 and 2x2 at (4, 4, 2048, 5632) and (32, 128, 768,
              3072) with and without bias and at M=3, F=77 (replicated),
              each block and the reassembled output against the plain
              version; all in bf16 and f32; the Hopper designs' edges in
              bf16, each twice and bit for bit: the merged matmul at T in
              {1, 8, 16, 17, 64, 127, 128, 129, 257} with D = F = 200 (off
              the 64-deep k-step and the 128-wide tile), D split 2 and 8
              ways over a cluster at a 2x2 rank's block, 256-column tiles,
              bias on and off; the chunk attention with its keys split over
              a cluster of blocks (an all-junk lane, wrapped rings, hd 8,
              64, 128) and at hymba's G = 5; the ninth slice's redesigns,
              each twice and bit for bit: the sLSTM cell at the xlstm-1.3b
              width in every plan variant (f32 r in registers, shared
              memory and streamed from L2 at S=32, all streamed at S=1;
              bf16 r), a prefill reading r's instances through ``rows``
              (bit for bit against the gathered copy), the co-resident
              cluster count of each plan; the decode layer's wgmma path at
              M=4 x B=4 and at B=12 (wgmma N 16), its weights' tensor maps
              encoded once; the tenth slice's redesigns, each twice and bit
              for bit: the decode attention at the hymba-1.5b width (8
              splits over a cluster) with kv_len on both sides of every
              split boundary and NaN in every slot past kv_len (bit for
              bit), bf16 and f32; the chunkwise mLSTM at hd 1024 in one
              chunk of 32 (64 lanes), one and two chunks of 128 and four of
              64, bf16 and f32; a lane's independence of its call, bit for
              bit in bf16 (one lane alone against its row of M=4 x B=4,
              M=2 and M=4 x B=12 calls): the decode layer at the
              tinyllama-1.1b width, its attention phase at the
              olmoe-1b-7b width (16 / 16 heads of 128), the chunk
              attention at both widths (one lane against 4 and 2), the
              merged matmul skinny (the tinyllama FFN, olmoe's 64 experts)
              and wide (32 and 64 rows; 64 instances, whose wide tiles are
              256 columns, against one, whose are 128); past 16 lanes an
              instance (the wgmma path's lane groups of 16), one lane alone
              against its row of M=4 x B=24 and M=1 x B=32 calls, bit for
              bit, for the whole decode layer and both phases, and the
              whole layer at M=4 x B=32 against its plain version and timed
              on the lane groups and on the lanes matvec that ran there
              before; internvl2-26b's widths (the whole layer at d 6144, a
              GQA group of 6 over heads of 128, d_ff 16384; the logits at
              V=92553) against their plain versions, each product's plan
              printed; whisper-small's widths (12 / 12 heads of 64): the
              encoder's chunk attention (one chunk of 1500 rows, no
              cache, ``causal=False``) at 4 lanes and one lane alone bit
              for bit, the decoder's over a 1024-slot cache, the decode
              attention over the 1500 cross frames and over the self ring;
4. serve   -- four main paths, each with every launch counter set to 0
              just before it and read just after: ``MultiModelServer`` on
              the full tinyllama-1.1b config (dense: decode layer, chunk
              attention, logits), on the full xlstm-1.3b config (ssm:
              sLSTM cell, logits) and on the full hymba-1.5b config
              (hybrid: chunk attention, decode attention of the 3 global
              layers, logits; max_context 1536) and on the full
              olmoe-1b-7b config (moe: 16 layers, 64 experts top-8, 57 GB
              of weights at M=4; chunk attention, the decode layer's
              attention phase, the merged matmul carrying the experts,
              logits), M=4 seeded random instances, and on internvl2-26b
              at M=2 cut to 24 of its 48 layers (vlm: the 256 zero patch
              positions before each prompt; the whole decode layer, the
              chunk attention, the logits), and on whisper-small at full
              width and depth (audio: the encoder reruns each chunk call;
              24 chunk-attention launches a chunk call, 24 decode-attention
              launches a decode step, no logits kernel), 16 requests each;
              every kernel of a path must have launched, with the counts
              each step and chunk call implies; each path's mix served
              again with PROFILE_STEPS engine steps after its first
              decode block under torch.profiler (the device idle share
              of that window);
4b. periphery -- the serving periphery around full-width tinyllama-1.1b
              (M=4, 4 slots, chunk 32, 4 lanes, K=8, the serve mix, bf16):
              a fault-free drain first, then six gates: (a) through the
              ``AsyncEngine`` under a ``Supervisor``, the 16 streams equal
              the serve phase's, every launch counter set to 0 just before
              and read just after; (b) a plan of a driver raise (device
              step 3), a decode raise (call 7) and a chunk-call raise (call
              2), streams equal, ``replay_mismatches == 0``, restarts ==
              the injected raises in ``fired``; (c) a ``nan`` fault on
              instance 2 quarantines instance 2 alone, the other three's
              streams equal; (d) tracing and accounting on: streams equal,
              conservation below 1e-6, the tracer's summary, tok/s with
              tracing off and on; (e) HTTP on 127.0.0.1 port 0: two SSE
              completions equal their streams, ``/metrics`` in Prometheus
              text parses line by line, ``/healthz`` 200; (f) a 2 s decode
              stall under a 0.5 s watchdog counted as a ``WatchdogTimeout``
              and the soft recovery's streams equal; no restart and no
              error in (a), (d), (e); the time to recover per restart;
5. check   -- greedy K=1 vs K=8 streams identical on the card for the
              four families (full widths, cut depth; olmoe-1b-7b and
              qwen3-moe-30b-a3b and internvl2-26b at 4 layers, whisper-small
              at 12), and the kernel path against the plain path on the CPU
              on small f32 configs (hymba-smoke at 4 layers over 176
              prefilled positions: the meta prefix and a wrapped SWA ring;
              olmoe-smoke with its exact-length capacity; internvl2-smoke
              with random patch embeddings over its 8 prefix positions;
              whisper-smoke with random frames);
5b. graph  -- the paper's Algorithm 1 (``repro_torch.core.graph``): the
              FFNN graph (FC -> LayerNorm -> GELU -> FC) at bert-base's FFN
              widths (768 -> 3072 -> 768, 128 tokens an instance) and the
              residual CNN graph at a resnet50 stage (56 x 56 x 256, 3x3
              convolutions, batch norm, max pool, 1000 classes) merged at
              M in {1, 8, 32}: the merged run against the M per-instance
              runs in f32, TF32 off, within PAPER_EXACT_TOL, both timed;
5c. train  -- training (``train/loop.py``, ``launch/train.py``): (a)
              tinyllama-1.1b and (b) xlstm-1.3b at full depth and width
              (M=2; B=2, S=512 and B=1, S=256), f32 master weights, bf16
              compute, remat per layer, TRAIN_STEPS AdamW steps on one
              fixed batch, every launch counter set to 0 just before and
              read just after: losses finite and falling, grad norms
              finite and above 0, every parameter with a gradient, the
              mLSTM and sLSTM kernels (under their autograd Functions)
              twice a layer and step (forward and remat's recompute), no
              other kernel; ms a step, tokens/s, peak memory; (g)
              olmoe-1b-7b (4 of 16 layers; B=1, S=512; the merged matmul
              under its autograd Function 12 times a layer and step, its
              aux logged), internvl2-26b (1 of 48 layers; 256 patches +
              256 tokens) and whisper-small (full depth; B=2, S=256, 1500
              frames), the same gates, vlm and audio launching no kernel;
              the Function's bf16 output, dx and dw at an olmoe expert
              shape against the plain version's autograd; (c) one
              step's loss and gradients on the card against the CPU on
              the f32 smoke configs of the six families; (d) instance
              isolation of M=3 fused training; (e) the training CLI at
              full tinyllama width with ``--save``, the checkpoint
              restored and served; (f) whole-sequence ``api.prefill``
              against the chunked path's last logits (bf16 at full
              tinyllama width, first greedy tokens on the f32 smokes),
              and for the moe, vlm and audio smokes its cache against the
              chunked path's and 4 greedy steps from each;
6. tp      -- tensor-parallel serving over 2 ranks, one process each, sharing
              the card (gloo): the full tinyllama-1.1b (M=4, 16 requests of
              16-512 tokens, 32 new, K=8) with every launch counter set to 0
              just before and read just after on each rank -- the attention
              and FFN phase kernels 22 times each per decode step, the
              whole-layer kernel never; the ranks' streams identical; K=1 ==
              K=8 at 4 layers; the f32 smoke config's cache shards, gathered
              logits and greedy tokens against the single-device plain path
              on the CPU; in the same spawn the ssm family: xlstm-1.3b at
              full width cut to 16 of its 48 layers (14 mLSTM, 2 sLSTM;
              M=4, the serve mix), each rank on 2 of the 4 heads, the sLSTM
              FFN and half the vocab -- per decode step the sLSTM cell 2
              times, the merged matmul 14 times (q C), the logits once over
              V/2; per layer pass (a decode step or a chunk call) 30 sums
              and 2 gathers counted on the rank's handle; the ranks'
              streams identical, and how many equal a one-device serve of
              the same cut (information: the row-split sums round in
              another order); 8 layers at K=1 == K=8; the f32 xlstm-smoke
              (V 256) equal to the single-device plain path on the CPU;
7. tp_hybrid -- tensor-parallel hybrid serving over 2 ranks sharing the
              card (gloo): the full hymba-1.5b (M=4, 16 requests of 16-512
              tokens, 32 new, K=8, max_context 1536; the attention whole on
              each rank, FFN and mamba branch split) with every launch
              counter set to 0 just before and read just after on each
              rank -- decode_attention_sharded once per layer and step,
              the chunk kernel 32 times per chunk call, the logits once
              per step; the ranks' streams identical; K=1 == K=8 at 4
              layers; the "kv" plan end to end over 5 ranks (4 layers,
              M=2); the f32 smoke config's streams at TP=2 and TP=4
              ("expand") equal to the single-device plain path on the CPU;
              over the same 4 ranks xlstm-smoke widened to 4 heads (d_model
              128: a rank's sLSTM head of 32 is the kernel's step) in f32,
              equal to the CPU plain path too;
8. data    -- serving on a (data=D, model=T) mesh, the D*T ranks sharing
              the card (gloo), at 2x1 and 2x2: the full tinyllama-1.1b (M=4,
              16 requests of 16-512 tokens, 32 new, K=8), every launch
              counter set to 0 just before and read just after on each rank
              -- at 2x1 the whole-layer kernel 22 times per decode step, at
              2x2 the attention and FFN phases 22 times each, the chunk
              kernel and the logits in both; the ranks' streams identical;
              the f32 smoke config's streams equal to the single-device
              plain path on the CPU; the 2x1 streams equal to the serve
              phase's one-device streams at M=4, 16 of 16, for tinyllama
              and for the full xlstm-1.3b, hymba-1.5b and whisper-small
              served at 2x1 too (a lane's bf16 result does not depend on
              the instance count of its call; whisper's data ranks each
              hold 2 instances' cross caches and launch the chunk attention
              24 times a chunk call, the decode attention 24 times a decode
              step); at
              2x2 K=1 == K=8 at 4 layers and
              ``fused_matmul_sharded`` on each rank's block of a seeded
              (4, 4, 2048, 5632) problem with bias, reassembled against the
              plain version, each rank's wrapper launched once per call;
              reported: the data gather's and the model sums' ms;
8b. moe_mesh -- merged MoE on (data=D, model=T) meshes, the ranks sharing
              the card (gloo), each rank drawing only its shard: 1x2 and
              2x1 the full olmoe-1b-7b (M=4, 16 requests of 16-512 tokens,
              32 new, K=8; 1x2: a rank holds 8 of 16 heads, 32 of 64
              experts an instance, half the vocab), 2x2 qwen3-moe-30b-a3b
              cut to 4 layers (128 experts in windows of 64); every launch
              counter set to 0 just before and read just after on each rank
              -- 16 attention phases and 48 merged matmuls a decode step,
              the whole layer never; the ranks' streams identical; the f32
              olmoe-smoke config's streams equal to the single-device plain
              path on the CPU; 2x1 streams equal to the serve phase's
              one-device streams, 16 of 16; 2x2 K=1 == K=8; no 1x2 rank's
              setup peak above its shard, caches and one drawn layer of a
              leaf; reported: ms per sum, each rank's peaks, how many 1x2
              streams equal one device's;
8c. vlm_mesh -- internvl2-26b (M=2, 24 of 48 layers) on a 1x2 mesh, the
              ranks sharing the card (gloo), each drawing only its shard
              (heads, kv heads and d_ff halved; the projector, embedding
              and odd-vocab head whole), the serve mix, launch counters set
              to 0 just before and read just after on each rank: the
              attention and FFN phases 24 times each a decode step, the
              whole layer never; the ranks' streams identical; no rank's
              setup peak above its shard, caches and one drawn leaf; the
              f32 internvl2-smoke streams on 1x2 and 1x4 equal to the
              single-device plain path on the CPU; reported: tok/s, ms per
              decode step, sums per step and ms per sum, each rank's peaks;
9. paper   -- the paper's evaluation through ``benchmarks/torch_run.py``
              at full width: bert-base and xlnet-base at S=128, resnet50
              and resnext50 at 224x224, bs=1, M in {1, 8, 32} under
              sequential, concurrent (one CUDA stream per instance),
              hybrid (P=4, resnext) and netfuse; netfuse's speedup at
              M=32; merged vs per-instance max |diff| in f32 with TF32 off
              (held to PAPER_EXACT_TOL); at M=32 the outputs of
              concurrent and hybrid (P=4) element by element against
              sequential (the dtype's kernel tolerance); peak memory per
              strategy and the merge time at M=32;
10. profile -- the port's kernel profiler on each kernel at the
              architecture that launches it (dense kernels at
              tinyllama-1.1b, sLSTM and mLSTM at xlstm-1.3b, decode
              attention at hymba-1.5b, M=4; the merged matmul also and
              the group RMS norm at bert-base, M=32), every launch counter
              set to 0 just before and read just after: the three kernels
              of this path must have launched; one call of the decode
              attention runs exactly one device kernel, of the mLSTM (one
              and four chunks) exactly two (torch.profiler, in a fresh
              process);
11. times  -- each kernel, its plain version and, where one PyTorch call
              computes the same function, that call (SDPA for chunk and
              decode attention, ``torch.bmm`` for the merged matmul) timed
              with CUDA events at the serving / profiler shapes (the two
              phase kernels at a rank's shapes at TP=2, the sharded decode
              attention at each plan's per-rank shape, the sharded merged
              matmul at a rank's block at 2x2), beside the bound from bytes
              and FLOPs; the chunk attention and the merged matmul (both
              shapes of each row) also as device time queued behind a spin
              kernel, beside SDPA's and ``torch.bmm``'s timed the same way;
              the whole decode layer and both sLSTM shapes (two copies of
              r rotating, so r loads from HBM as in serving) also as device
              time; the decode attention beside SDPA's device time and its
              latency floor (an empty kernel on its grid of clusters); the
              mLSTM's device time at the profiler shape, over four chunks
              of 64 and two of 128, and both recurrent kernels at the train
              phase's xlstm shape.  Each serve path logs the tensor maps it encoded; the
              tinyllama serve's profile counts the decode layer's kernels
              per layer (at most 6).

The line before the last is the per-kernel JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

sys.path.insert(0, os.path.join(HERE, "benchmarks"))

# the full-width shapes of tinyllama-1.1b at M=4 instances, 4 slots each
M, B, S, C = 4, 4, 1024, 32
# engine steps of a serve cell's profiled window (each up to 4 chunk calls
# and one decode block; a cell's 16 requests take 14 to 16 decode blocks)
PROFILE_STEPS = 4
D, H, KVH, HD, F, V = 2048, 32, 4, 64, 5632, 32000
# the sLSTM cell of xlstm-1.3b: D=2048 over 4 heads
XH, XHD = 4, 512
# hymba-1.5b: 25 heads over 5 kv heads of 64, d 1600, vocab 32001; the
# serving context holds the 128 meta tokens, the 1024-slot SWA window and
# prompts of up to 512 tokens with 32 new ones
YH, YKVH, YD, YV, YS = 25, 5, 1600, 32001, 1536
YSWA = 128 + 1024
# tensor parallelism: TP ranks share the card; a rank's share of tinyllama at
# TP=2 is 16 query heads over 2 kv heads and 2816 of d_ff
TP = 2
TH, TKVH, TF = H // TP, KVH // TP, F // TP
# requests of the TP serve cell (cut before anything else to keep the script
# inside its time)
TP_REQUESTS = 16
# the ssm TP cell: xlstm-1.3b at full width cut to 16 of its 48 layers (14
# mLSTM, 2 sLSTM: layers 3, 11; 0.81 B parameters an instance, 8.20 GB at
# M=4 with the f32 embedding and head, drawn whole by each rank before it
# keeps its 4.92 GB shard, computed from shapes; with 24 layers the script
# took 1190.5 s of its 1200 on an NVIDIA H100 80GB HBM3 at 700 W whose host
# ran the gloo cells slowly), and to 8 layers for K=1 == K=8 (8 requests)
XLSTM_TP_LAYERS, XLSTM_CHECK_LAYERS = 16, 8
# hymba-1.5b under TP: TP=2 keeps its 25 q heads whole on every rank
# (plan None), TP=5 splits its 5 kv heads ("kv"), TP=25 gives each rank one
# q head over the kv head it reads ("expand")
HYBRID_TPS = (2, 5, 25)
# the data axis: the (data, model) meshes of the data phase, all ranks on the
# one card over gloo; fused_matmul_sharded's blocks are checked on these and
# on 1x2
DATA_MESHES = ((2, 1), (2, 2))
MATMUL_MESHES = ((1, 2), (2, 1), (2, 2))
# a data rank's instance rows at D=2: the decode kernels run at M_L, not M
M_L = M // 2
# the vlm serve cell: internvl2-26b at 2 instances, cut to 24 of its 48
# layers (46.6 GB merged in bf16 with the f32 embed and head, computed from
# shapes; the whole depth would be 90 GB)
VLM_M, VLM_LAYERS = 2, 24
# the moe mesh cells: (data, model) meshes, all ranks on the one card over
# gloo; olmoe-1b-7b at full depth on 1x2 and 2x1, qwen3-moe-30b-a3b cut to
# QWEN_LAYERS of 48 layers on 2x2
MOE_MESHES = ((1, 2), (2, 1), (2, 2))
QWEN_LAYERS = 4

# bf16 tolerance, relative to the largest magnitude of the plain output:
# one bf16 ulp is 2^-8 = 3.9e-3; the kernels sum in another order than
# cuBLAS / torch, which can flip the rounding of an intermediate stored in
# bf16 (q, k, v, the attention output, the SwiGLU hidden) and later stages
# carry that on.  f32: summation order only.
TOL = {"bfloat16": 3e-2, "float32": 1e-4}
# calls of the decode layer's ring attention on one input beside a busy
# side stream, all bit for bit equal (``ring_repeat_cases``)
RING_REPEATS = 400
# the periphery phase's watchdog gate: a decode stall of PERIPHERY_STALL_S
# under a watchdog of PERIPHERY_WATCHDOG_S
PERIPHERY_STALL_S, PERIPHERY_WATCHDOG_S = 2.0, 0.5
# the train phase's cells at full width: (arch, M, B, S, layers: None for
# the full depth); AdamW steps a cell, on one fixed batch, cosine schedule
# from this lr.  olmoe-1b-7b keeps 4 of its 16 layers (3.77 B parameters at
# M=2, 60.3 GB of f32 master, gradient and two moments; all 16 would be
# 221 GB) and internvl2-26b 1 of its 48 (3.09 B, 49.5 GB: its f32 embed and
# head are 4.55 GB each, and two layers would be about 62 GB before AdamW's
# temporaries), computed from the configs' shapes.  vlm's S counts the 256
# patch positions and 256 tokens.
TRAIN_CELLS = (("tinyllama-1.1b", 2, 2, 512, None), ("xlstm-1.3b", 2, 1, 256, None),
               ("olmoe-1b-7b", 2, 1, 512, 4), ("internvl2-26b", 2, 1, 512, 1),
               ("whisper-small", 2, 2, 256, None))
# the merged matmul's launches a moe layer and train step: 3 products
# forward, 3 again in remat's recompute, dx and dw of each in the backward
MOE_TRAIN_LAUNCHES = 12
# the merged matmul's Function at an olmoe-1b-7b train shape (M=2 x 64
# experts, 80 rows a pair, D=2048, F=1024): x bf16, w the f32 master
TRAIN_MATMUL = (128, 80, 2048, 1024)
TRAIN_STEPS, TRAIN_LR = 4, 3e-5
# one training step on the card against the CPU on f32 smoke configs: the
# loss relative, every gradient leaf relative to its largest magnitude
# (kernels and library calls sum in other orders; a gradient sums over
# every token)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
# instance isolation with AdamW's clip (the instances' one coupling) off:
# instance 0's largest parameter difference against the run with the other
# instances on other streams (summation order only), and against instance 0
# trained alone (the fused loss averages over M, so AdamW's eps acts on the
# tiniest gradients); instance 0 fed another stream moves by ~2e-2
ISOLATION_OTHERS_TOL, ISOLATION_SOLO_TOL = 1e-4, 1e-3
# merged vs per-instance outputs of the paper's models in f32, TF32 off,
# relative to the largest output magnitude: the merged and the single
# calls may take other cuBLAS / cuDNN algorithms, so only summation order
# differs (the f32 kernel figure)
PAPER_EXACT_TOL = 1e-4


def log(phase, **kw):
    print(f"[{phase}] " + ", ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item()


def part_err(got, want):
    """Error relative to the largest magnitude of ``want`` itself, with no
    floor: for a partial with no residual added (an out-proj or down-proj
    partial of a rank), whose values lie far below 1."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def abs_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def bound_ms(nbytes, flops, dtype):
    """max(bytes / HBM rate, FLOPs / peak) in ms, from the H100 peaks that
    ``repro_torch.serving.obs.kernel_profile`` keeps."""
    from repro_torch.serving.obs.kernel_profile import HBM_BYTES_PER_S, PEAK_FLOPS

    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def layer_inputs(torch, dev, dt, seed, bias=False, h=H, kvh=KVH, ff=F, m=M):
    """One layer's weights, x and ring of ``m`` instances at the tinyllama
    width (default) or at a rank's share of the heads and FFN (``h``,
    ``kvh``, ``ff``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shp, sc=1.0: torch.randn(shp, generator=g, device=dev) * sc
    lp = {
        "attn_norm": 1 + 0.1 * r(m, D), "mlp_norm": 1 + 0.1 * r(m, D),
        "wq": r(m, D, h * HD, sc=D ** -0.5).to(dt), "wk": r(m, D, kvh * HD, sc=D ** -0.5).to(dt),
        "wv": r(m, D, kvh * HD, sc=D ** -0.5).to(dt),
        "wo": r(m, h * HD, D, sc=(H * HD) ** -0.5).to(dt),
        "w_gate": r(m, D, ff, sc=D ** -0.5).to(dt), "w_up": r(m, D, ff, sc=D ** -0.5).to(dt),
        "w_down": r(m, ff, D, sc=F ** -0.5).to(dt),
    }
    if bias:
        lp.update(bq=r(m, h * HD, sc=0.1).to(dt), bk=r(m, kvh * HD, sc=0.1).to(dt),
                  bv=r(m, kvh * HD, sc=0.1).to(dt))
    x = r(m, B, D).to(dt)
    ck, cv = r(m, B, S, kvh, HD).to(dt), r(m, B, S, kvh, HD).to(dt)
    return lp, x, ck, cv


def chunk_inputs(torch, dev, dt, seed, m, b, offsets, s=None, h=None, kvh=None):
    """q (m,b,C,h,hd), k/v (m,b,s+C,kvh,hd) (default: the tinyllama width
    S, H, KVH) and the lanes' offsets."""
    s, h, kvh = s or S, h or H, kvh or KVH
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(m, b, C, h, HD, generator=g, device=dev).to(dt)
    k = torch.randn(m, b, s + C, kvh, HD, generator=g, device=dev).to(dt)
    v = torch.randn(m, b, s + C, kvh, HD, generator=g, device=dev).to(dt)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev).reshape(m, b)
    return q, k, v, off


def logits_inputs(torch, dev, xdt, seed, dup=True, d=None, v=None, m=M):
    """x (m,B,d), scale (m,d), f32 head (m,d,v) (default: M instances at
    the tinyllama width D, V).  With ``dup``, one column is made the clear
    winner for every lane and copied to an earlier and a later index: the
    answer must be the earlier copy, bit-exactly tied."""
    d, v = d or D, v or V
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, B, d, generator=g, device=dev).to(xdt)
    scale = 1 + 0.1 * torch.randn(m, d, generator=g, device=dev)
    head = torch.randn(m, d, v, generator=g, device=dev) * d ** -0.5
    if dup:
        xf = x.float()
        n = xf / xf.pow(2).mean(-1, keepdim=True).add(1e-5).sqrt() * scale[:, None]
        win = n.sum(1) / (B * d ** 0.5)
        for col in (v - 1000, 5, v - 1):
            head[:, :, col] = win
    return x, scale, head


def decode_attn_inputs(torch, dev, dt, seed, lens=None, h=YH, kvh=YKVH):
    """q (M,B,25,64), k/v (M,B,1536,5,64) at the hymba-1.5b width (or a
    rank's ``h`` q heads over ``kvh`` kv heads) and kv_len (M,B): the
    edges 1, 128 (one split), 129, 1536 and random lengths, unless
    ``lens`` gives its own range [lo, hi)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(M, B, h, HD, generator=g, device=dev).to(dt)
    k = torch.randn(M, B, YS, kvh, HD, generator=g, device=dev).to(dt)
    v = torch.randn(M, B, YS, kvh, HD, generator=g, device=dev).to(dt)
    lo, hi = lens or (1, YS + 1)
    kv_len = torch.randint(lo, hi, (M, B), generator=g, device=dev, dtype=torch.int32)
    if lens is None:
        kv_len.view(-1)[:4] = torch.tensor([1, 128, 129, YS], dtype=torch.int32)
    return q, k, v, kv_len


def slstm_inputs(torch, dev, dt, rdt, m, b, s, seed, junk=False, h=XH):
    """Gate pre-activations (M,B,S,4,D), recurrent weights (M,4,H,hd,hd)
    and a non-zero carried state at the xlstm-1.3b cell width (``h`` of
    its heads of 512: a TP rank's share).  With ``junk``, lanes end early
    as in a padded final prefill chunk: their suffix takes the neutral
    gates (input -1e30, forget +1e30)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d = h * XHD
    pre = torch.randn(m, b, s, 4, d, generator=g, device=dev)
    if junk:
        neutral = torch.tensor([0.0, -1e30, 1e30, 0.0], device=dev)[:, None]
        ends = torch.randint(0, s, (m, b), generator=g, device=dev)
        for mi in range(m):
            for bi in range(b):
                pre[mi, bi, int(ends[mi, bi]):] = neutral
    r = (torch.randn(m, 4, h, XHD, XHD, generator=g, device=dev) * XHD ** -0.5).to(rdt)
    state = (torch.randn(m, b, d, generator=g, device=dev),
             torch.rand(m, b, d, generator=g, device=dev) + 0.5,
             (0.5 * torch.randn(m, b, d, generator=g, device=dev)).to(dt),
             torch.randn(m, b, d, generator=g, device=dev))
    return pre.to(dt), r, state


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    log("device", name=name, count=torch.cuda.device_count(), nvidia_smi=repr(card),
        torch=torch.__version__, cuda=torch.version.cuda)
    return card


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build_all()
    secs = time.perf_counter() - t0
    for src, rep in reports.items():
        for fn, body in re.findall(r"Compiling entry function '(\w+)'.*?\n(.*?)(?=ptxas info    : Compiling|\Z)",
                                   rep, re.S):
            short = re.search(r"(matvec_partial_kernel|matvec_epilogue_kernel|ring_attn_kernel|"
                              r"ring_combine_kernel|logits_partial_kernel|logits_reduce_kernel|"
                              r"chunk_attn_kernel|slstm_kernel|decode_attn_tc|"
                              r"decode_attn_f32|decode_attn_floor|fused_matmul_bf16|"
                              r"fused_matmul_f32|matmul_wide|matmul_skinny|chunk_attn_tc|"
                              r"tc_matvec|group_rms_kernel|mlstm_gates_kernel|mlstm_state_kernel|"
                              r"mlstm_one_chunk_kernel)(I.*?E)?", fn)
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
            smem = re.search(r"(\d+) bytes smem", body)
            log("build", source=f"{src}.cu",
                kernel=(short.group(0) if short else fn)[:60],
                registers=regs.group(1) if regs else "?",
                static_smem=smem.group(1) if smem else 0,
                spills=f"{spill.group(1)}/{spill.group(2)}" if spill else "?")
    # the ptxas report of the six kernels redesigned for Hopper, as printed
    for src in ("fused_matmul", "chunk_prefill_attn", "slstm_cell", "decode_layer",
                "decode_attn", "mlstm_chunk"):
        for line in reports.get(src, "").splitlines():
            if re.search(r"Compiling entry|Used \d+ registers|spill", line):
                print(f"[ptxas] {src}.cu: {line.strip()}", flush=True)
    log("build", sources=len(build.SOURCES), built=len(reports), seconds=round(secs, 2))


def phase_kernels(torch, dev):
    from repro_torch.kernels import chunk_prefill_attn as cpa
    from repro_torch.kernels import decode_layer as dl

    errs = {}
    # decode layer: pre-wrap, wrapped ring, sliding window over a wrapped ring
    g = torch.Generator(device=dev).manual_seed(7)
    cases = [("bfloat16", 0, 0, False), ("bfloat16", S, 0, True),
             ("bfloat16", 2 * S, 256, False), ("float32", S, 0, True)]
    for dtn, base, window, bias in cases:
        dt = getattr(torch, dtn)
        lp, x, ck, cv = layer_inputs(torch, dev, dt, 1, bias)
        pos = (base + torch.randint(0, S, (M, B), generator=g, device=dev)).to(torch.int32)
        kw = dict(num_heads=H, head_dim=HD, rope_theta=10000.0, window=window)
        want = dl.decode_layer_plain(lp, x, ck.clone(), cv.clone(), pos, **kw)
        got = dl.decode_layer_cuda(lp, x, ck.clone(), cv.clone(), pos, **kw)
        torch.cuda.synchronize()
        e = max(rel_err(a, b) for a, b in zip(got, want))
        assert e <= TOL[dtn], f"decode_layer {dtn} base={base} window={window}: {e}"
        errs[f"decode_layer/{dtn}/base{base}/w{window}"] = e
        del lp, x, ck, cv, got, want

    # greedy logits: duplicated winning column -> the first copy, exactly
    for xdt in ("bfloat16", "float32"):
        x, scale, head = logits_inputs(torch, dev, getattr(torch, xdt), 2)
        tok, val = dl.logits_argmax_cuda(x, scale, head)
        ptok, pval = dl.logits_argmax_plain(x, scale, head)
        torch.cuda.synchronize()
        assert (tok == 5).all(), f"logits {xdt}: first occurrence broken: {tok.tolist()}"
        e = rel_err(val, pval)
        assert e <= TOL["float32"], f"logits val {xdt}: {e}"
        errs[f"logits/{xdt}/dup"] = e
        x, scale, head = logits_inputs(torch, dev, getattr(torch, xdt), 3, dup=False)
        tok, val = dl.logits_argmax_cuda(x, scale, head)
        ptok, pval = dl.logits_argmax_plain(x, scale, head)
        torch.cuda.synchronize()
        assert torch.equal(tok, ptok), f"logits {xdt}: tokens differ"
        errs[f"logits/{xdt}/rand"] = rel_err(val, pval)
        del head
        # hymba-1.5b: d 1600, odd vocab 32001 (the kernel's scalar loads)
        x, scale, head = logits_inputs(torch, dev, getattr(torch, xdt), 12, d=YD, v=YV)
        tok, val = dl.logits_argmax_cuda(x, scale, head)
        ptok, pval = dl.logits_argmax_plain(x, scale, head)
        torch.cuda.synchronize()
        assert (tok == 5).all() and torch.equal(tok, ptok), f"logits V={YV} {xdt}: {tok.tolist()}"
        e = rel_err(val, pval)
        assert e <= TOL["float32"], f"logits V={YV} val {xdt}: {e}"
        errs[f"logits/{xdt}/V{YV}/dup"] = e
        del head

    # chunk attention: empty / mid / full / wrapped caches; pin, window, sink
    offs = [0, 1, 17, 200, 500, 992, 1000, 1023, 1024, 1100, 1500, 2047, 5, 64, 300, 3000]
    for dtn, pin, window, sink in (("bfloat16", 0, 0, 0), ("bfloat16", 0, 256, 0),
                                   ("bfloat16", 4, 256, 4), ("float32", 0, 0, 0)):
        dt = getattr(torch, dtn)
        q, k, v, off = chunk_inputs(torch, dev, dt, 4, M, B, offs)
        if pin:
            off = off.clamp(min=pin)
        kw = dict(s_cache=S, pin=pin, window=window, sink=sink)
        want = cpa.chunk_prefill_attention_plain(q, k, v, off, **kw)
        got = cpa.chunk_prefill_attention_cuda(q, k, v, off, **kw)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        assert e <= TOL[dtn], f"chunk {dtn} pin={pin} window={window} sink={sink}: {e}"
        errs[f"chunk/{dtn}/pin{pin}/w{window}/s{sink}"] = e
    # chunk attention at the hymba-1.5b width (G=5): the SWA group (128
    # pinned meta slots, window, meta sink) and the global group
    yoffs = [0, 96, 128, 150, 700, 1100, 1151, 1152, 1200, 1500, 2000, 2303, 2304, 3000, 40, 64]
    for dtn, s_c, pin, window in (("bfloat16", YSWA, 128, 1024), ("float32", YSWA, 128, 1024),
                                  ("bfloat16", YS, 0, 1 << 30), ("float32", YS, 0, 1 << 30)):
        dt = getattr(torch, dtn)
        q, k, v, off = chunk_inputs(torch, dev, dt, 13, M, B, yoffs, s=s_c, h=YH, kvh=YKVH)
        kw = dict(s_cache=s_c, pin=pin, window=window, sink=128)
        want = cpa.chunk_prefill_attention_plain(q, k, v, off, **kw)
        got = cpa.chunk_prefill_attention_cuda(q, k, v, off, **kw)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        assert e <= TOL[dtn], f"chunk hymba {dtn} S={s_c} pin={pin} window={window}: {e}"
        errs[f"chunk/hymba/{dtn}/S{s_c}/pin{pin}/w{window}/s128"] = e
        del q, k, v

    # decode attention at the hymba-1.5b width: G=5, S=1536, mixed kv_len
    from repro_torch.kernels import decode_attn as da
    for dtn in ("bfloat16", "float32"):
        q, k, v, kv_len = decode_attn_inputs(torch, dev, getattr(torch, dtn), 14)
        want = da.decode_attention_plain(q, k, v, kv_len)
        got = da.decode_attention_cuda(q, k, v, kv_len)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        assert e <= TOL[dtn], f"decode_attention {dtn}: {e}"
        errs[f"decode_attention/{dtn}/S{YS}/G5"] = e
        del q, k, v

    # sLSTM cell at the xlstm-1.3b width: decode (S=1, M=4 x B=4 slots) and
    # prefill (S=32, 4 lanes); r in param_dtype (f32) or bf16; a padded chunk
    from repro_torch.kernels import slstm_cell as sc
    f32, bf16 = torch.float32, torch.bfloat16
    for dt, rdt, m, b, s, junk in ((f32, f32, M, B, 1, False), (bf16, f32, M, B, 1, False),
                                   (f32, f32, 4, 1, C, False), (bf16, f32, 4, 1, C, False),
                                   (bf16, f32, M, B, C, True), (bf16, bf16, 4, 1, C, True)):
        pre, r, state = slstm_inputs(torch, dev, dt, rdt, m, b, s, 8, junk)
        want = tuple(t.clone() for t in state)
        want_hs, _ = sc.slstm_cell_plain(pre, r, want, num_heads=XH)
        got = tuple(t.clone() for t in state)
        got_hs, _ = sc.slstm_cell_cuda(pre, r, got, num_heads=XH)
        torch.cuda.synchronize()
        dtn = str(dt).removeprefix("torch.")
        e = max(rel_err(got_hs, want_hs), *(rel_err(a, w) for a, w in zip(got, want)))
        key = f"slstm_cell/{dtn}/r_{str(rdt).removeprefix('torch.')}/S{s}/B{b}" + (
            "/padded" if junk else "")
        assert e <= TOL[dtn], f"{key}: {e}"
        errs[key] = e
        del pre, r
    errs.update(new_kernel_cases(torch, dev))
    errs.update(hopper_design_cases(torch, dev))
    errs.update(redesign_cases(torch, dev))
    errs.update(phase_kernel_cases(torch, dev))
    errs.update(ring_repeat_cases(torch, dev))
    errs.update(sharded_attn_cases(torch, dev))
    errs.update(sharded_matmul_cases(torch, dev))
    errs.update(attn_mlstm_cases(torch, dev))
    errs.update(lane_cases(torch, dev))
    groups, b32 = lane_group_cases(torch, dev)
    errs.update(groups)
    errs.update(vlm_width_cases(torch, dev))
    errs.update(whisper_width_cases(torch, dev))
    errs.update(xlstm_tp_width_cases(torch, dev))
    for key, e in errs.items():
        log("kernels", case=key, rel_err=f"{e:.3e}")
    log("kernels", cases=len(errs), tolerance_bf16=TOL["bfloat16"],
        tolerance_f32=TOL["float32"], status="ok")
    return b32


def ring_repeat_cases(torch, dev, calls=RING_REPEATS):
    """The decode layer's ring attention with every lane's ring ending
    mid-ring before it wraps (a split's tiles past pos are dead; the last
    one's -inf scores are written after the score loop), ``calls`` times
    on the same inputs at the tinyllama width while a thread keeps bf16
    matmuls running on a side stream: the attention phase and the whole
    layer, bf16 and f32.  Every call's outputs equal the first's bit for
    bit (without the barrier before the softmax a warp could read a stale
    score of a dead tile: on an idle card 64 calls never showed it; beside
    the side stream's matmuls the kernel without the barrier differed at
    its 13th and its 131st call in two runs), and the first is held
    against the plain version."""
    import threading

    side, busy = torch.cuda.Stream(dev), threading.Event()
    a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)

    def hammer():
        with torch.cuda.stream(side):
            while not busy.is_set():
                for _ in range(4):
                    a @ a
                side.synchronize()

    th = threading.Thread(target=hammer)
    th.start()
    try:
        return _ring_repeat(torch, dev, calls)
    finally:
        busy.set()
        th.join()


def _ring_repeat(torch, dev, calls):
    from repro_torch.kernels import decode_layer as dl

    errs = {}
    g = torch.Generator(device=dev).manual_seed(29)
    for dtn in ("bfloat16", "float32"):
        lp, x, ck, cv = layer_inputs(torch, dev, getattr(torch, dtn), 30)
        pos = torch.randint(1, S - 1, (M, B), generator=g, device=dev).to(torch.int32)
        kw = dict(num_heads=H, head_dim=HD, rope_theta=10000.0)
        for name, call, plain in (("attn", dl.decode_layer_attn_cuda, dl.decode_layer_attn_plain),
                                  ("layer", dl.decode_layer_cuda, dl.decode_layer_plain)):
            first = call(lp, x, ck.clone(), cv.clone(), pos, **kw)
            for i in range(1, calls):
                again = call(lp, x, ck.clone(), cv.clone(), pos, **kw)
                assert all(torch.equal(a, b) for a, b in zip(first, again)), \
                    f"ring attention {name} {dtn}: call {i} differs from call 0"
            want = plain(lp, x, ck.clone(), cv.clone(), pos, **kw)
            torch.cuda.synchronize()
            e = max(part_err(first[0], want[0]) if name == "attn" else rel_err(first[0], want[0]),
                    *(rel_err(a, b) for a, b in zip(first[1:], want[1:])))
            assert e <= TOL[dtn], f"ring attention {name} {dtn} mid-ring: {e}"
            errs[f"ring_repeat/{name}/{dtn}/mid_ring/x{calls}"] = e
        del lp, x, ck, cv
    return errs


def lane_cases(torch, dev):
    """A lane's result depends on its own inputs and the shapes only: one
    lane alone (M=1, B=1) equals, bit for bit in bf16, its row of an M=4
    x B=4 call, of an M=2 call and of an M=4 x B=12 call (wgmma N 16), for
    the decode layer (tinyllama-1.1b width, wrapped ring), its attention
    phase at the olmoe-1b-7b width (16 / 16 heads of 128), the chunk
    attention (both widths, one lane against 4 and 2) and the merged
    matmul (the tinyllama FFN and olmoe's experts, skinny; T = 32 / 64
    rows on the wide path against one instance, and 64 instances, whose
    wide tiles are 256 columns, against one, whose are 128).  Returns the
    cases (0 = equal)."""
    from repro_torch.kernels import chunk_prefill_attn as cpa
    from repro_torch.kernels import decode_layer as dl
    from repro_torch.kernels import fused_matmul as fm

    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(61)
    rn = lambda *shp, sc=1.0: (torch.randn(shp, generator=g, device=dev) * sc).to(bf16)
    cases = {}

    def same(key, got, want):
        assert torch.equal(got, want), f"{key}: a lane's bits depend on its call"
        cases[key] = 0.0

    m0, b0 = 1, 2                                 # the lane held against its rows
    for name, (d, h, kvh, hd, ff) in (("tinyllama", (D, H, KVH, HD, F)),
                                      ("olmoe", (2048, 16, 16, 128, 0))):
        lp = {"attn_norm": (1 + 0.1 * torch.randn(M, d, generator=g, device=dev)),
              "wq": rn(M, d, h * hd, sc=d ** -0.5), "wk": rn(M, d, kvh * hd, sc=d ** -0.5),
              "wv": rn(M, d, kvh * hd, sc=d ** -0.5), "wo": rn(M, h * hd, d, sc=(h * hd) ** -0.5)}
        if ff:
            lp.update(mlp_norm=1 + 0.1 * torch.randn(M, d, generator=g, device=dev),
                      w_gate=rn(M, d, ff, sc=d ** -0.5), w_up=rn(M, d, ff, sc=d ** -0.5),
                      w_down=rn(M, ff, d, sc=ff ** -0.5))
        x, ck, cv = rn(M, 12, d), rn(M, 12, S, kvh, hd), rn(M, 12, S, kvh, hd)
        pos = (S + torch.randint(0, S, (M, 12), generator=g, device=dev)).to(torch.int32)
        kw = dict(num_heads=h, head_dim=hd, rope_theta=10000.0)
        call = dl.decode_layer_cuda if ff else dl.decode_layer_attn_cuda

        def run(ms, bs):
            sub = {k: v[ms].contiguous() for k, v in lp.items()}
            k_, v_ = ck[ms, bs].contiguous(), cv[ms, bs].contiguous()
            out = call(sub, x[ms, bs].contiguous(), k_, v_, pos[ms, bs].contiguous(), **kw)
            return out[0], k_, v_

        one = run(slice(m0, m0 + 1), slice(b0, b0 + 1))
        for tag, ms, bs in (("M4xB4", slice(0, M), slice(0, B)), ("M2xB4", slice(0, 2), slice(0, B)),
                            ("M4xB12", slice(0, M), slice(0, 12))):
            got = run(ms, bs)
            for i, part in enumerate(("out", "k", "v")):
                same(f"lane/decode_layer{'' if ff else '_attn'}/{name}/{tag}/{part}",
                     one[i][0, 0], got[i][m0, b0])
        del lp, x, ck, cv

        # the chunk attention at this width: one lane against 4 and 2
        q, k, v = rn(M, 1, C, h, hd), rn(M, 1, S + C, kvh, hd), rn(M, 1, S + C, kvh, hd)
        off = torch.tensor([[40], [300], [1500], [2100]], dtype=torch.int32, device=dev)
        alone = cpa.chunk_prefill_attention_cuda(q[m0:m0 + 1], k[m0:m0 + 1], v[m0:m0 + 1],
                                                 off[m0:m0 + 1], s_cache=S)
        for tag, ms in (("lanes4", slice(0, M)), ("lanes2", slice(0, 2))):
            got = cpa.chunk_prefill_attention_cuda(q[ms], k[ms], v[ms], off[ms], s_cache=S)
            same(f"lane/chunk/{name}/{tag}", alone[0], got[m0])
        del q, k, v

    # the merged matmul: skinny (T <= 16: the tinyllama FFN, olmoe's 64
    # experts of an instance) against one row of one instance; wide (a
    # prefill chunk's 32 rows, 64 when two lanes share an instance)
    # against one instance's 32 rows
    for name, (mm, d, f, t_all, r0, t_one, calls) in (
            ("ffn", (M, D, F, 12, 2, 1, (("T4", M, 4), ("M2", 2, 4), ("T12", M, 12)))),
            ("experts", (64, 2048, 1024, 12, 2, 1, (("T4", 64, 4), ("M2", 2, 4), ("T12", 64, 12)))),
            ("wide", (M, 2048, 1024, 64, 20, 32, (("T32", M, 32), ("M2T32", 2, 32), ("T64", M, 64)))),
            ("wide_cols", (64, 2048, 1024, 32, 20, 32, (("M64T32", 64, 32), ("M2T32", 2, 32))))):
        if name == "wide_cols":
            # the wide tile's columns read m: 256 at 64 instances, 128 alone
            assert [fm.launch_plan(n, 32, d, f).cols for n in (1, 2, 64)] == [128, 128, 256]
        x, w = rn(mm, t_all, d), rn(mm, d, f, sc=d ** -0.5)
        lo = r0 if t_one == 1 else 0
        alone = fm.fused_matmul_cuda(x[m0:m0 + 1, lo:lo + t_one].contiguous(),
                                     w[m0:m0 + 1].contiguous())[0, r0 - lo]
        for tag, n_inst, t in calls:
            got = fm.fused_matmul_cuda(x[:n_inst, :t].contiguous(), w[:n_inst].contiguous())
            same(f"lane/fused_matmul/{name}/{tag}", alone, got[m0, r0])
        del x, w
    torch.cuda.synchronize()
    log("kernels", lane_checks=len(cases), bit_for_bit="equal")
    return cases


def lane_group_cases(torch, dev):
    """The decode layer past 16 lanes an instance (bf16, tinyllama-1.1b
    width, wrapped ring), where the wgmma path walks groups of 16 lanes:
    one lane alone equals, bit for bit, its row of an M=4 x B=24 and an
    M=1 x B=32 call, for the whole layer and for the attention and FFN
    phases; the whole layer at M=4 x B=32 against its plain version, and
    timed (CUDA events; device time queued behind a spin) on the lane
    groups and on the lanes matvec that ran there before them
    (``decode_layer._attn_phase`` / ``_ffn_phase`` with the residual),
    in turns (lanes matvec, groups, groups, lanes matvec).  Returns (cases,
    times)."""
    from repro_torch.kernels import decode_layer as dl

    bf16, nb = torch.bfloat16, 32
    g = torch.Generator(device=dev).manual_seed(62)
    rn = lambda *shp, sc=1.0: (torch.randn(shp, generator=g, device=dev) * sc).to(bf16)
    lp = {"attn_norm": 1 + 0.1 * torch.randn(M, D, generator=g, device=dev),
          "mlp_norm": 1 + 0.1 * torch.randn(M, D, generator=g, device=dev),
          "wq": rn(M, D, H * HD, sc=D ** -0.5), "wk": rn(M, D, KVH * HD, sc=D ** -0.5),
          "wv": rn(M, D, KVH * HD, sc=D ** -0.5), "wo": rn(M, H * HD, D, sc=(H * HD) ** -0.5),
          "w_gate": rn(M, D, F, sc=D ** -0.5), "w_up": rn(M, D, F, sc=D ** -0.5),
          "w_down": rn(M, F, D, sc=F ** -0.5)}
    x, ck, cv = rn(M, nb, D), rn(M, nb, S, KVH, HD), rn(M, nb, S, KVH, HD)
    pos = (S + torch.randint(0, S, (M, nb), generator=g, device=dev)).to(torch.int32)
    kw = dict(num_heads=H, head_dim=HD, rope_theta=10000.0)
    ffn = ("mlp_norm", "w_gate", "w_up", "w_down")
    plans = dl.layer_plans(M, nb, D, H, KVH, HD, F)
    assert plans is not None and all(p.groups == 2 and p.rows == 16 for p in plans.values())
    cases, m0, b0 = {}, 1, 2

    def run(kind, ms, bs):
        sub = {k: v[ms].contiguous() for k, v in lp.items()}
        xs = x[ms, bs].contiguous()
        if kind == "ffn":
            return (dl.ffn_cuda(xs, *(sub[k] for k in ffn)),)
        k_, v_ = ck[ms, bs].contiguous(), cv[ms, bs].contiguous()
        call = dl.decode_layer_cuda if kind == "layer" else dl.decode_layer_attn_cuda
        return call(sub, xs, k_, v_, pos[ms, bs].contiguous(), **kw)[0], k_, v_

    for kind in ("layer", "attn", "ffn"):
        one = run(kind, slice(m0, m0 + 1), slice(b0, b0 + 1))
        for tag, ms, bs in (("M4xB24", slice(0, M), slice(0, 24)),
                            ("M1xB32", slice(m0, m0 + 1), slice(0, nb))):
            got = run(kind, ms, bs)
            for i, part in enumerate(("out", "k", "v")[:len(got)]):
                key = f"lane_groups/{kind}/{tag}/{part}"
                assert torch.equal(one[i][0, 0], got[i][m0 - ms.start, b0]), (
                    f"{key}: a lane's bits depend on its call")
                cases[key] = 0.0

    def lanes_matvec(ck_, cv_):
        x2 = dl._attn_phase(lp, x, ck_, cv_, pos, x, window=0, eps=1e-5, alive=None, **kw)
        return dl._ffn_phase(x2, *(lp[k] for k in ffn), x2, eps=1e-5)

    want = dl.decode_layer_plain(lp, x, ck.clone(), cv.clone(), pos, **kw)
    got = dl.decode_layer_cuda(lp, x, ck.clone(), cv.clone(), pos, **kw)
    old = lanes_matvec(ck.clone(), cv.clone())
    torch.cuda.synchronize()
    e_new = max(rel_err(a, b) for a, b in zip(got, want))
    e_old = rel_err(old, want[0])
    assert e_new <= TOL["bfloat16"] and e_old <= TOL["bfloat16"], (e_new, e_old)
    cases[f"decode_layer/bfloat16/M{M}xB{nb}/lane_groups"] = e_new
    cases[f"decode_layer/bfloat16/M{M}xB{nb}/lanes_matvec"] = e_old
    times = {"lanes_matvec": [], "lane_groups": []}
    for which in ("lanes_matvec", "lane_groups", "lane_groups", "lanes_matvec"):
        fn = ((lambda: lanes_matvec(ck, cv)) if which == "lanes_matvec" else
              (lambda: dl.decode_layer_cuda(lp, x, ck, cv, pos, **kw)))
        times[which].append((time_ms(torch, fn), time_queued_ms(torch, fn)))
    n_w = D * (H + 2 * KVH) * HD + H * HD * D + 3 * D * F
    valid = (pos + 1).clamp(max=S).sum().item()
    nbytes = (M * n_w * 2 + 2 * M * D * 4 + 2 * M * nb * D * 2
              + valid * KVH * HD * 2 * 2 + M * nb * KVH * HD * 2 * 2 + M * nb * 4)
    bms, by = bound_ms(nbytes, 2 * M * nb * n_w + 4 * H * HD * valid, "bfloat16")
    out = {"b32_bound_ms": bms, "b32_bound_by": by}
    for which, ts in times.items():
        out[f"b32_{which}_ms"] = [t[0] for t in ts]
        out[f"b32_{which}_device_ms"] = [t[1] for t in ts]
        log("kernels", name="decode_layer", shape=f"M={M}, B={nb}, bf16, whole layer",
            path=which, ms=[f"{t[0]:.4f}" for t in ts],
            device_ms=[f"{t[1]:.4f}" for t in ts], bound_ms=f"{bms:.4f}", bound_by=by)
    log("kernels", lane_group_checks=sum(1 for k in cases if k.startswith("lane_groups")),
        bit_for_bit="equal", splits={k: p.split for k, p in plans.items()}, groups=2)
    return cases, out


def vlm_width_cases(torch, dev):
    """internvl2-26b's widths, which no kernel ran at before the vlm
    family: the whole decode layer (d 6144, 48 / 8 heads of 128 -- a GQA
    group of 6 --, d_ff 16384 -- the down product split 4 ways) at M=2 x
    B=4 over a wrapped ring, and the greedy logits at V=92553 (not a
    multiple of 8) with a duplicated winning column, bf16, against their
    plain versions; each product's plan in the log."""
    from repro_torch.configs import registry
    from repro_torch.kernels import decode_layer as dl

    cfg = registry.get_config("internvl2-26b")
    d, h, kvh, hd, ff, v = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                            cfg.d_ff, cfg.vocab_size)
    m, bf16 = 2, torch.bfloat16
    plans = dl.layer_plans(m, B, d, h, kvh, hd, ff)
    assert plans is not None, "internvl2-26b's layer left the wgmma path"
    log("kernels", arch=cfg.name, **{f"plan_{k}": f"{p.variant}/N{p.rows}/split{p.split}/"
                                     f"grid{p.grid}/smem{p.smem}".replace(" ", "")
                                     for k, p in plans.items()})
    g = torch.Generator(device=dev).manual_seed(63)
    rn = lambda *shp, sc=1.0: (torch.randn(shp, generator=g, device=dev) * sc).to(bf16)
    lp = {"attn_norm": 1 + 0.1 * torch.randn(m, d, generator=g, device=dev),
          "mlp_norm": 1 + 0.1 * torch.randn(m, d, generator=g, device=dev),
          "wq": rn(m, d, h * hd, sc=d ** -0.5), "wk": rn(m, d, kvh * hd, sc=d ** -0.5),
          "wv": rn(m, d, kvh * hd, sc=d ** -0.5), "wo": rn(m, h * hd, d, sc=(h * hd) ** -0.5),
          "w_gate": rn(m, d, ff, sc=d ** -0.5), "w_up": rn(m, d, ff, sc=d ** -0.5),
          "w_down": rn(m, ff, d, sc=ff ** -0.5)}
    x, ck, cv = rn(m, B, d), rn(m, B, S, kvh, hd), rn(m, B, S, kvh, hd)
    pos = (S + torch.randint(0, S, (m, B), generator=g, device=dev)).to(torch.int32)
    kw = dict(num_heads=h, head_dim=hd, rope_theta=cfg.rope_theta)
    want = dl.decode_layer_plain(lp, x, ck.clone(), cv.clone(), pos, **kw)
    got = dl.decode_layer_cuda(lp, x, ck.clone(), cv.clone(), pos, **kw)
    torch.cuda.synchronize()
    errs = {f"decode_layer/bfloat16/{cfg.name}/M{m}": max(rel_err(a, b)
                                                         for a, b in zip(got, want))}
    del lp, x, ck, cv, got, want
    xs, scale, head = logits_inputs(torch, dev, bf16, 64, d=d, v=v, m=m)
    tok, val = dl.logits_argmax_cuda(xs, scale, head)
    ptok, pval = dl.logits_argmax_plain(xs, scale, head)
    torch.cuda.synchronize()
    assert (tok == 5).all() and torch.equal(tok, ptok), f"logits V={v}: {tok.tolist()}"
    errs[f"logits/bfloat16/{cfg.name}/V{v}/dup"] = rel_err(val, pval)
    del head
    for key, e in errs.items():
        assert e <= TOL["bfloat16"], f"{key}: {e}"
    return errs


def whisper_width_cases(torch, dev):
    """whisper-small's widths, which no kernel ran at before the audio
    family (12 / 12 heads of 64, a GQA group of 1): the encoder's chunk
    attention (one chunk of F=1500 rows, no cache, ``causal=False``, the
    kernel's key positions ``off + j`` at S=0) at 4 lanes, one lane alone
    against its row bit for bit in bf16; the decoder's chunk attention over
    a 1024-slot cache at mixed offsets; the decode attention over the F
    cross frames (kv_len = F) and over the self ring at mixed kv_len; bf16
    and f32 against their plain versions."""
    from repro_torch.configs import registry
    from repro_torch.kernels import chunk_prefill_attn as cpa
    from repro_torch.kernels import decode_attn as da

    cfg = registry.get_config("whisper-small")
    fr, h, hd = cfg.num_audio_frames, cfg.num_heads, cfg.head_dim
    errs = {}
    for dtn in ("bfloat16", "float32"):
        dt = getattr(torch, dtn)
        g = torch.Generator(device=dev).manual_seed(71)
        q, k, v = (torch.randn((4, 1, fr, h, hd), generator=g, device=dev).to(dt)
                   for _ in range(3))
        off = torch.zeros((4, 1), dtype=torch.int32, device=dev)
        kw = dict(s_cache=0, causal=False)
        want = cpa.chunk_prefill_attention_plain(q, k, v, off, **kw)
        got = cpa.chunk_prefill_attention_cuda(q, k, v, off, **kw)
        one = cpa.chunk_prefill_attention_cuda(q[1:2].contiguous(), k[1:2].contiguous(),
                                               v[1:2].contiguous(), off[1:2], **kw)
        torch.cuda.synchronize()
        if dtn == "bfloat16":
            assert torch.equal(one, got[1:2]), "encoder chunk attention: a lane alone differs"
        errs[f"chunk/{cfg.name}/encoder/{dtn}/C{fr}/S0/noncausal"] = rel_err(got, want)
        plan = cpa.launch_plan(4, fr, h, h, hd, 0, dtn)
        log("kernels", arch=cfg.name, kernel="chunk_prefill_attention", call="encoder",
            dtype=dtn, plan=f"tiles{plan.tiles}/splits{plan.splits}/grid{plan.grid}".replace(
                " ", ""), lane_alone_bit_equal=dtn == "bfloat16" or "not held (f32)")
        del q, k, v, got, want, one
        q, k, v, off = chunk_inputs(torch, dev, dt, 72, 4, 1, [0, 96, 480, 991], h=h, kvh=h)
        want = cpa.chunk_prefill_attention_plain(q, k, v, off, s_cache=S)
        got = cpa.chunk_prefill_attention_cuda(q, k, v, off, s_cache=S)
        torch.cuda.synchronize()
        errs[f"chunk/{cfg.name}/decoder/{dtn}/S{S}"] = rel_err(got, want)
        del q, k, v
        for name, s, lens in (("cross", fr, (fr, fr + 1)), ("self", S, (1, S + 1))):
            q = torch.randn(M, B, h, hd, generator=g, device=dev).to(dt)
            k, v = (torch.randn(M, B, s, h, hd, generator=g, device=dev).to(dt)
                    for _ in range(2))
            kv_len = torch.randint(*lens, (M, B), generator=g, device=dev, dtype=torch.int32)
            want = da.decode_attention_plain(q, k, v, kv_len)
            got = da.decode_attention_cuda(q, k, v, kv_len)
            torch.cuda.synchronize()
            errs[f"decode_attention/{cfg.name}/{name}/{dtn}/S{s}"] = rel_err(got, want)
            del k, v
    for key, e in errs.items():
        assert e <= TOL[key.split("/")[3]], f"{key}: {e}"
    return errs


def xlstm_tp_width_cases(torch, dev):
    """xlstm-1.3b's kernels at a TP=2 rank's widths (the tp phase's cell):
    the sLSTM cell on 2 of the 4 heads of 512 (decode over M=4 x B=4
    slots; a prefill chunk of 4 lanes with padded tails), bf16 with r in
    f32; the mLSTM step's q C on the merged matmul in f32, one (1, 1024)
    @ (1024, 1024) product for each of M*B*2 (lane, head) pairs; the
    logits over a rank's V/2 = 25152 columns at D=2048 (f32 head), bf16
    and f32 residual.  Each against its plain version."""
    from repro_torch.kernels import decode_layer as dl
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.kernels import slstm_cell as sc

    errs, h = {}, XH // TP

    def check(key, e, dtn):
        assert e <= TOL[dtn], f"{key}: {e}"
        errs[key] = e

    for m, b, s, junk in ((M, B, 1, False), (4, 1, C, True)):
        pre, r, state = slstm_inputs(torch, dev, torch.bfloat16, torch.float32, m, b, s, 81,
                                     junk, h=h)
        want = tuple(t.clone() for t in state)
        want_hs, _ = sc.slstm_cell_plain(pre, r, want, num_heads=h)
        got = tuple(t.clone() for t in state)
        got_hs, _ = sc.slstm_cell_cuda(pre, r, got, num_heads=h)
        torch.cuda.synchronize()
        check(f"slstm_cell/tp{TP}/bfloat16/r_float32/H{h}/S{s}/B{b}",
              max(rel_err(got_hs, want_hs), *(rel_err(a, w) for a, w in zip(got, want))),
              "bfloat16")
        del pre, r
    g = torch.Generator(device=dev).manual_seed(82)
    hd = 2 * XHD
    q = torch.randn(M * B * h, 1, hd, generator=g, device=dev) * hd ** -0.5
    cst = torch.randn(M * B * h, hd, hd, generator=g, device=dev)
    got, want = fm.fused_matmul_cuda(q, cst), fm.fused_matmul_plain(q, cst)
    torch.cuda.synchronize()
    check(f"fused_matmul/tp{TP}/float32/mlstm_step/({M * B * h},1,{hd})@({hd},{hd})",
          rel_err(got, want), "float32")
    del q, cst
    for xdt in ("bfloat16", "float32"):
        x, scale, head = logits_inputs(torch, dev, getattr(torch, xdt), 83, dup=False,
                                       v=50304 // TP)
        tok, val = dl.logits_argmax_cuda(x, scale, head)
        ptok, pval = dl.logits_argmax_plain(x, scale, head)
        torch.cuda.synchronize()
        assert torch.equal(tok, ptok), f"logits V/{TP} {xdt}: tokens differ"
        check(f"logits/tp{TP}/{xdt}/V{50304 // TP}", rel_err(val, pval), "float32")
        del head
    return errs


def hopper_design_cases(torch, dev):
    """The edges of the two kernels redesigned for Hopper against their
    plain versions, bf16: the merged matmul at every row count its wgmma
    variants meet (skinny N = 8 / 16, wide in one, two and three block
    rows) with D and F off the 64 / 128 tiles, D split 2 and 8 ways over a
    cluster at a 2x2 rank's block of the serving shape, the 256-column wide
    tiles, bias on and off; the chunk attention with its 17 key tiles split
    over a cluster of 8 blocks (an all-junk lane, ranges across split
    boundaries, wrapped rings; hd 8, 64, 128) and at hymba's G = 5 in 5
    splits.  Each case twice, bit for bit."""
    from repro_torch.kernels import chunk_prefill_attn as cpa
    from repro_torch.kernels import fused_matmul as fm

    errs = {}
    g = torch.Generator(device=dev).manual_seed(41)
    bf16 = torch.bfloat16
    # (m, t, d, f, split forced on the plan or 0)
    shapes = [(3, t, 200, 200, 0) for t in (1, 8, 16, 17, 64, 127, 128, 129, 257)]
    shapes += [(M // 2, B, D, F // 2, 0), (M // 2, B, D, F // 2, 2), (M // 2, B, D, F // 2, 8),
               (16, 128, 768, 1536, 0), (10, 128, 256, 2504, 0)]
    for (m, t, d, f, split), bias in [(sh, b) for sh in shapes for b in (False, True)]:
        x = torch.randn(m, t, d, generator=g, device=dev).to(bf16)
        w = (torch.randn(m, d, f, generator=g, device=dev) * d ** -0.5).to(bf16)
        b = torch.randn(m, f, generator=g, device=dev) if bias else None
        plan = fm.launch_plan(m, t, d, f)
        if split:
            plan = dataclasses.replace(plan, split=split, grid=(plan.grid[0], split, m))
        got, again = fm.launch(x, w, b, plan), fm.launch(x, w, b, plan)
        want = fm.fused_matmul_plain(x, w, b)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        key = (f"fused_matmul/hopper/{plan.variant}{plan.cols}/split{plan.split}/({m},{t},{d},{f})"
               + ("/bias" if bias else ""))
        assert e <= TOL["bfloat16"] and torch.equal(got, again), f"{key}: {e}"
        errs[key] = e

    cases = [(4, 32, 8, 2, hd, 1024, pin, win, sink, [pin, 700, 1500, 5000])
             for hd in (8, 64, 128) for pin, win, sink in ((0, 0, 0), (16, 300, 16))]
    cases += [(4, C, YH, YKVH, HD, YSWA, 128, 1024, 128, [128, 600, 1300, 2900]),
              (4, C, YH, YKVH, HD, YS, 0, 1 << 30, 128, [0, 600, 1300, 2900])]
    for lanes, c, h, kvh, hd, s_c, pin, win, sink, offs in cases:
        q = torch.randn(lanes, 1, c, h, hd, generator=g, device=dev).to(bf16)
        k, v = (torch.randn(lanes, 1, s_c + c, kvh, hd, generator=g, device=dev).to(bf16)
                for _ in range(2))
        off = torch.tensor(offs, dtype=torch.int32, device=dev)[:, None]
        kw = dict(s_cache=s_c, pin=pin, window=win, sink=sink)
        plan = cpa.launch_plan(lanes, c, h, kvh, hd, s_c)
        assert plan.splits > 1, plan
        got = cpa.chunk_prefill_attention_cuda(q, k, v, off, **kw)
        again = cpa.chunk_prefill_attention_cuda(q, k, v, off, **kw)
        want = cpa.chunk_prefill_attention_plain(q, k, v, off, **kw)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        key = (f"chunk/hopper/H{h}/KVH{kvh}/hd{hd}/S{s_c}/splits{plan.splits}/pin{pin}/w{win}"
               f"/s{sink}")
        assert e <= TOL["bfloat16"] and torch.equal(got, again), f"{key}: {e}"
        errs[key] = e
    return errs


def redesign_cases(torch, dev):
    """The two kernels redesigned in the ninth slice against their plain
    versions, each case twice and bit for bit.  The sLSTM cell at the
    xlstm-1.3b width in every plan variant (f32 r: registers + shared
    memory + rows streamed from L2 at S = 32, all rows streamed at S = 1;
    bf16 r: resident at S = 32, streamed at S = 1), a prefill whose lanes
    read r's instances through ``rows`` (bit for bit against the gathered
    copy), and the card's count of co-resident clusters at both serve
    shapes.  The decode layer's wgmma path at the tinyllama-1.1b width:
    the whole layer at M = 4 x B = 4 and at B = 12 (the wgmma N of 16),
    and the weights' tensor maps encoded once over repeated calls."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_layer as dl
    from repro_torch.kernels import slstm_cell as sc

    errs = {}
    f32, bf16 = torch.float32, torch.bfloat16
    for dt, rdt, m, b, s in ((bf16, f32, 4, 1, C), (bf16, f32, M, B, 1), (f32, f32, M, B, 1),
                             (bf16, bf16, 4, 1, C), (bf16, bf16, M, B, 1)):
        rn = str(rdt).removeprefix("torch.")
        plan = sc.launch_plan(m, b, s, XH, XHD, rn)
        pre, r, state = slstm_inputs(torch, dev, dt, rdt, m, b, s, 9, junk=s > 1)
        want = tuple(t.clone() for t in state)
        want_hs, _ = sc.slstm_cell_plain(pre, r, want, num_heads=XH)
        runs = []
        for _ in range(2):
            st = tuple(t.clone() for t in state)
            runs.append((sc.slstm_cell_cuda(pre, r, st, num_heads=XH)[0], st))
        torch.cuda.synchronize()
        dtn = str(dt).removeprefix("torch.")
        e = max(rel_err(runs[0][0], want_hs), *(rel_err(a, w) for a, w in zip(runs[0][1], want)))
        key = (f"slstm_cell/plan/{dtn}/r_{rn}/S{s}/B{b}/regs{plan.reg_rows}/smem{plan.smem_rows}"
               f"/stream{plan.stream_rows}")
        same = torch.equal(runs[0][0], runs[1][0]) and all(
            torch.equal(a, w) for a, w in zip(runs[0][1], runs[1][1]))
        assert e <= TOL[dtn] and same, f"{key}: {e}, bit-identical {same}"
        errs[key] = e
        clusters = sc.max_active_clusters(plan, b, XHD, dtn, rn)
        log("kernels", slstm_plan=key, smem_bytes=plan.smem_bytes, stages=plan.stages,
            stream_mib_per_step=round(plan.stream_bytes_per_step / 2 ** 20, 2),
            clusters=m * XH, max_active_clusters=clusters)
        del pre, r, state, want, runs
    # a prefill chunk's 4 lanes reading instances 2, 0, 2, 1 of the merged r
    pre, r, state = slstm_inputs(torch, dev, bf16, f32, 4, 1, C, 10, junk=True)
    rows = torch.tensor([2, 0, 2, 1], dtype=torch.int32, device=dev)
    a, b_ = tuple(t.clone() for t in state), tuple(t.clone() for t in state)
    hs_map, _ = sc.slstm_cell_cuda(pre, r, a, num_heads=XH, rows=rows)
    hs_cat, _ = sc.slstm_cell_cuda(pre, r.index_select(0, rows.long()).contiguous(), b_,
                                   num_heads=XH)
    want = tuple(t.clone() for t in state)
    want_hs, _ = sc.slstm_cell_plain(pre, r, want, num_heads=XH, rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(hs_map, hs_cat) and all(torch.equal(u, v) for u, v in zip(a, b_))
    e = max(rel_err(hs_map, want_hs), *(rel_err(u, w) for u, w in zip(a, want)))
    assert e <= TOL["bfloat16"], f"slstm_cell rows: {e}"
    errs["slstm_cell/rows/bfloat16/r_float32/S32/mapped==gathered"] = e
    del pre, r, state

    g = torch.Generator(device=dev).manual_seed(23)
    for m, b in ((M, B), (2, 12)):
        lp = layer_inputs(torch, dev, bf16, 24, m=m)[0]
        x = torch.randn(m, b, D, generator=g, device=dev).to(bf16)
        ck, cv = (torch.randn(m, b, S, KVH, HD, generator=g, device=dev).to(bf16)
                  for _ in range(2))
        plans = dl.layer_plans(m, b, D, H, KVH, HD, F)
        assert plans is not None
        pos = (S + torch.randint(0, S, (m, b), generator=g, device=dev)).to(torch.int32)
        kw = dict(num_heads=H, head_dim=HD, rope_theta=10000.0)
        want = dl.decode_layer_plain(lp, x, ck.clone(), cv.clone(), pos, **kw)
        n0 = build.tensor_maps.encodes
        got = dl.decode_layer_cuda(lp, x, ck.clone(), cv.clone(), pos, **kw)
        n1 = build.tensor_maps.encodes
        again = dl.decode_layer_cuda(lp, x, ck.clone(), cv.clone(), pos, **kw)
        torch.cuda.synchronize()
        assert build.tensor_maps.encodes == n1 and n1 - n0 <= 7, (n0, n1)
        e = max(rel_err(u, w) for u, w in zip(got, want))
        key = f"decode_layer/wgmma/bfloat16/M{m}/B{b}/N{plans['qkv'].rows}"
        assert e <= TOL["bfloat16"] and all(torch.equal(u, v) for u, v in zip(got, again)), (
            f"{key}: {e}")
        errs[key] = e
        log("kernels", decode_layer_plans=key, tensor_maps_encoded=n1 - n0,
            splits={k: p.split for k, p in plans.items()})
        del lp, x, ck, cv, got, again, want
    return errs


def phase_kernel_cases(torch, dev):
    """The two halves of the sharded decode layer at a rank's widths of
    tinyllama-1.1b at TP=2 against their plain versions, bf16 and f32: the
    attention phase over a wrapped ring with lanes frozen by ``alive``
    (their ring rows compared bit for bit with the input), the FFN phase;
    at M instances (the tp phase) and at a data rank's M_L (the 2x2 mesh
    of the data phase).  The partials carry no residual and lie far below
    1, so they are held relative to their own largest magnitude
    (``part_err``).  Then the whole layer and the greedy logits at M_L
    (the 2x1 mesh; the logits also on a rank's vocab slice at 2x2): the
    shapes a data rank's calls take."""
    from repro_torch.kernels import decode_layer as dl

    errs = {}
    g = torch.Generator(device=dev).manual_seed(17)
    for m in (M, M_L):
        for dtn in ("bfloat16", "float32"):
            dt = getattr(torch, dtn)
            lp, x, ck, cv = layer_inputs(torch, dev, dt, 18, h=TH, kvh=TKVH, ff=TF, m=m)
            pos = (S + torch.randint(0, S, (m, B), generator=g, device=dev)).to(torch.int32)
            alive = torch.rand(m, B, generator=g, device=dev) < 0.75
            alive[0, 0] = False
            kw = dict(num_heads=TH, head_dim=HD, rope_theta=10000.0, alive=alive)
            want = dl.decode_layer_attn_plain(lp, x, ck.clone(), cv.clone(), pos, **kw)
            got = dl.decode_layer_attn_cuda(lp, x, ck.clone(), cv.clone(), pos, **kw)
            torch.cuda.synchronize()
            e = max(part_err(got[0], want[0]),
                    *(rel_err(a, b) for a, b in zip(got[1:], want[1:])))
            assert e <= TOL[dtn], f"decode_layer_attn {dtn} M={m}: {e}"
            assert torch.equal(got[1][~alive], ck[~alive])
            assert torch.equal(got[2][~alive], cv[~alive])
            errs[f"decode_layer_attn/{dtn}/M{m}/TP{TP}/wrapped/alive"] = e
            ffn = [lp[k] for k in ("mlp_norm", "w_gate", "w_up", "w_down")]
            e = part_err(dl.ffn_cuda(x, *ffn), dl.ffn_plain(x, *ffn))
            torch.cuda.synchronize()
            assert e <= TOL[dtn], f"decode_layer_ffn {dtn} M={m}: {e}"
            errs[f"decode_layer_ffn/{dtn}/M{m}/TP{TP}"] = e
            del lp, x, ck, cv, got, want

    for dtn, base, alive_share in (("bfloat16", 0, 1.0), ("bfloat16", S, 0.75),
                                   ("float32", S, 0.75)):
        dt = getattr(torch, dtn)
        lp, x, ck, cv = layer_inputs(torch, dev, dt, 19, m=M_L)
        pos = (base + torch.randint(0, S, (M_L, B), generator=g, device=dev)).to(torch.int32)
        alive = torch.rand(M_L, B, generator=g, device=dev) < alive_share
        kw = dict(num_heads=H, head_dim=HD, rope_theta=10000.0, alive=alive)
        want = dl.decode_layer_plain(lp, x, ck.clone(), cv.clone(), pos, **kw)
        got = dl.decode_layer_cuda(lp, x, ck.clone(), cv.clone(), pos, **kw)
        torch.cuda.synchronize()
        e = max(rel_err(a, b) for a, b in zip(got, want))
        assert e <= TOL[dtn], f"decode_layer {dtn} M={M_L} base={base}: {e}"
        assert torch.equal(got[1][~alive], ck[~alive])
        errs[f"decode_layer/{dtn}/M{M_L}/base{base}/alive{alive_share}"] = e
        del lp, x, ck, cv, got, want

    for xdt in ("bfloat16", "float32"):
        for v in (V, V // TP):
            x, scale, head = logits_inputs(torch, dev, getattr(torch, xdt), 20, v=v, m=M_L)
            tok, val = dl.logits_argmax_cuda(x, scale, head)
            ptok, pval = dl.logits_argmax_plain(x, scale, head)
            torch.cuda.synchronize()
            assert (tok == 5).all(), f"logits M={M_L} V={v} {xdt}: {tok.tolist()}"
            e = rel_err(val, pval)
            assert e <= TOL["float32"], f"logits M={M_L} V={v} val {xdt}: {e}"
            errs[f"logits/{xdt}/M{M_L}/V{v}/dup"] = e
            x, scale, head = logits_inputs(torch, dev, getattr(torch, xdt), 21, dup=False,
                                           v=v, m=M_L)
            tok, val = dl.logits_argmax_cuda(x, scale, head)
            ptok, pval = dl.logits_argmax_plain(x, scale, head)
            torch.cuda.synchronize()
            assert torch.equal(tok, ptok), f"logits M={M_L} V={v} {xdt}: tokens differ"
            e = rel_err(val, pval)
            assert e <= TOL["float32"], f"logits M={M_L} V={v} val {xdt}: {e}"
            errs[f"logits/{xdt}/M{M_L}/V{v}/rand"] = e
            del head
    return errs


def rank_blocks(torch, q, k, v, kv_len, n):
    """Every rank's output of ``decode_attention_sharded`` over ``n``
    ranks, each on its block: its q heads and the kv heads it reads (all
    heads under plan None).  Returns (plan, the outputs in rank order)."""
    from types import SimpleNamespace

    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_layer import tp_head_plan

    h, kvh = q.shape[2], k.shape[3]
    plan = tp_head_plan(h, kvh, n)
    outs = []
    for r in range(n):
        lo, hi, _ = da.rank_kv_heads(h, kvh, n, r) if plan else (0, kvh, None)
        outs.append(ops.decode_attention_sharded(
            q.chunk(n, 2)[r].contiguous() if plan else q, k[:, :, :, lo:hi].contiguous(),
            v[:, :, :, lo:hi].contiguous(), kv_len, plan=plan,
            tp=SimpleNamespace(rank=r, size=n), num_kv_heads=kvh))
    return plan, outs


def sharded_attn_cases(torch, dev):
    """``decode_attention_sharded`` at the hymba-1.5b width (25 q heads
    over 5 kv heads, S=1536, mixed kv_len) over each of HYBRID_TPS ranks,
    bf16 and f32: every rank's block through the wrapper in this process,
    the blocks concatenated over the heads against the plain version on
    the whole heads, and under "expand" also against the plain version on
    the reference's repeat form (KV repeated to one head per q head)."""
    from repro_torch.kernels import decode_attn as da

    errs = {}
    for dtn in ("bfloat16", "float32"):
        q, k, v, kv_len = decode_attn_inputs(torch, dev, getattr(torch, dtn), 15)
        want = da.decode_attention_plain(q, k, v, kv_len)
        for n in HYBRID_TPS:
            plan, outs = rank_blocks(torch, q, k, v, kv_len, n)
            got = torch.cat(outs, 2) if plan else outs[0]
            torch.cuda.synchronize()
            e = rel_err(got, want)
            assert e <= TOL[dtn], f"decode_attention_sharded {dtn} T={n} plan={plan}: {e}"
            errs[f"decode_attention_sharded/{dtn}/T{n}/{plan}"] = e
            if plan == "expand":
                g = YH // YKVH
                rep = da.decode_attention_plain(q, k.repeat_interleave(g, 3),
                                                v.repeat_interleave(g, 3), kv_len)
                e = rel_err(got, rep)
                assert e <= TOL[dtn], f"decode_attention_sharded {dtn} T={n} vs repeat: {e}"
                errs[f"decode_attention_sharded/{dtn}/T{n}/{plan}/vs_repeat"] = e
        del q, k, v, want
    return errs


def matmul_rank_outs(torch, x, w, b, d, t):
    """Every rank's output of ``fused_matmul_sharded`` on a (data=d,
    model=t) mesh, each on its block (``fused_matmul.rank_block``) in this
    process, each held against the plain version on its block.  Returns
    (the outputs in global rank order, the largest block error)."""
    from types import SimpleNamespace

    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.kernels import ops

    outs, err = [], 0.0
    for r in range(d * t):
        data, tp = SimpleNamespace(rank=r // t, size=d), SimpleNamespace(rank=r % t, size=t)
        xl, wl, bl = fm.rank_block(x, w, b, data.rank, d, tp.rank, t)
        out = ops.fused_matmul_sharded(xl, wl, bl, data=data, tp=tp)
        err = max(err, rel_err(out, fm.fused_matmul_plain(xl, wl, bl)))
        outs.append(out)
    return outs, err


def sharded_matmul_cases(torch, dev):
    """``fused_matmul_sharded`` on every rank's block of the meshes
    MATMUL_MESHES at the tinyllama serving shape and the BERT shape, with
    and without bias, and at M=3, F=77, which divide neither 2-way axis
    and replicate, bf16 and f32: each block against the plain version on
    it, and the blocks reassembled against the plain version on the whole
    arrays."""
    from repro_torch.kernels import fused_matmul as fm

    errs = {}
    g = torch.Generator(device=dev).manual_seed(23)
    for dtn in ("bfloat16", "float32"):
        dt = getattr(torch, dtn)
        for m, t, d, f, bias in ((M, B, D, F, False), (M, B, D, F, True),
                                 (32, 128, 768, 3072, False), (32, 128, 768, 3072, True),
                                 (3, B, 768, 77, True)):
            x = torch.randn(m, t, d, generator=g, device=dev).to(dt)
            w = (torch.randn(m, d, f, generator=g, device=dev) * d ** -0.5).to(dt)
            b = torch.randn(m, f, generator=g, device=dev) if bias else None
            want = fm.fused_matmul_plain(x, w, b)
            for dm, tm in MATMUL_MESHES:
                outs, e = matmul_rank_outs(torch, x, w, b, dm, tm)
                e = max(e, rel_err(fm.assemble(outs, m, f, dm, tm), want))
                torch.cuda.synchronize()
                key = f"fused_matmul_sharded/{dtn}/{dm}x{tm}/({m},{t},{d},{f})" + (
                    "/bias" if bias else "")
                assert e <= TOL[dtn], f"{key}: {e}"
                errs[key] = e
            del x, w, want, outs
    return errs


def attn_mlstm_cases(torch, dev):
    """The two kernels redesigned in the tenth slice against their plain
    versions, each case twice and bit for bit.  The decode attention at
    the hymba-1.5b width (S 1536, 8 splits over a cluster), bf16 and f32,
    with kv_len at 1, S and on both sides of every split boundary, and
    with NaN in every slot past kv_len (bit for bit: those slots are never
    read).  The chunkwise mLSTM at hd 1024: the profiler's one chunk of 32
    (64 lanes), xlstm-1.3b's reference chunk of 128 in one chunk and over
    two, four chunks of 64 (C kept in registers over the chunks, clusters
    of 8 blocks); bf16 and f32."""
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import mlstm_chunk as ml

    errs = {}
    for dtn in ("bfloat16", "float32"):
        dt = getattr(torch, dtn)
        q, k, v, kv_len = decode_attn_inputs(torch, dev, dt, 16)
        plan = da.launch_plan(M * B, YS, YH, YKVH, HD, dtn)
        starts = [a for a, _ in plan.ranges[1:]]
        edges = [1, YS, starts[-1]] + [x for a in starts[:4] for x in (a - 1, a, a + 1)]
        kv_len.view(-1)[:len(edges)] = torch.tensor(edges, dtype=torch.int32)
        got = da.decode_attention_cuda(q, k, v, kv_len)
        again = da.decode_attention_cuda(q, k, v, kv_len)
        want = da.decode_attention_plain(q, k, v, kv_len)
        mask = torch.arange(YS, device=dev) >= kv_len[..., None]
        k[mask], v[mask] = float("nan"), float("nan")
        poisoned = da.decode_attention_cuda(q, k, v, kv_len)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        key = f"decode_attention/tc/{dtn}/S{YS}/G5/splits{plan.splits}/edges"
        assert e <= TOL[dtn] and torch.equal(got, again), f"{key}: {e}"
        assert torch.equal(got, poisoned), f"{key}: NaN past kv_len changed the output"
        errs[key] = e
        errs[key + "/nan_past_kv_len_bit_identical"] = 0.0
        del q, k, v
    for i, (m, b, h, s, hd, chunk) in enumerate(((4, 4, 4, 32, 1024, 32), (1, 1, 4, 128, 1024, 128),
                                                 (1, 1, 4, 256, 1024, 128),
                                                 (1, 1, 4, 256, 1024, 64))):
        for dtn in ("bfloat16", "float32"):
            dt = getattr(torch, dtn)
            q, k, v, lf, li = mlstm_inputs(torch, dev, dt, m, b, h, s, hd, 25 + i)
            plan = ml.launch_plan(m * b * h, s, hd, ml.chunk_size(s, chunk), dtn)
            gh, gst = ml.mlstm_chunkwise_cuda(q, k, v, lf, li, chunk=chunk)
            gh2, gst2 = ml.mlstm_chunkwise_cuda(q, k, v, lf, li, chunk=chunk)
            wh, wst = ml.mlstm_chunkwise_plain(q, k, v, lf, li, chunk=chunk)
            torch.cuda.synchronize()
            e = max(rel_err(gh, wh), *(rel_err(a, w_) for a, w_ in zip(gst, wst)))
            same = torch.equal(gh, gh2) and all(torch.equal(a, b_) for a, b_ in zip(gst, gst2))
            key = (f"mlstm_chunkwise/tc/{dtn}/({m},{b},{h},{s},{hd})/chunk{chunk}"
                   f"/pass1x{plan.kcluster}/blocks{plan.grid2[0]}x{plan.grid2[1]}"
                   + ("/resident" if plan.resident else ""))
            assert gh.dtype == dt and e <= TOL[dtn] and same, f"{key}: {e}, bit-identical {same}"
            errs[key] = e
            del q, k, v, gh, gh2, wh, gst, gst2, wst
    return errs


def mlstm_inputs(torch, dev, dt, m, b, h, s, hd, seed, ends=None):
    """q, k, v (m,b,h,s,hd) and the f32 gates (log-forget from a
    log-sigmoid, input gate N(0,1)); lanes listed in ``ends`` take
    gate-neutral steps (input -1e30, forget 0) from there on, as the
    serving junk rule pads a final chunk."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(m, b, h, s, hd, generator=g, device=dev).to(dt) for _ in range(3))
    lf = torch.nn.functional.logsigmoid(2 + torch.randn(m, b, h, s, generator=g, device=dev))
    li = torch.randn(m, b, h, s, generator=g, device=dev)
    for (mi, bi, hi), e in (ends or {}).items():
        li[mi, bi, hi, e:] = -1e30
        lf[mi, bi, hi, e:] = 0.0
    return q, k, v, lf, li


def new_kernel_cases(torch, dev):
    """The merged matmul, the group RMS norm and the chunkwise mLSTM
    against their plain versions, bf16 and f32."""
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.kernels import group_norm as gn
    from repro_torch.kernels import mlstm_chunk as ml

    errs = {}
    g = torch.Generator(device=dev).manual_seed(21)
    # merged matmul: the tinyllama serving shape (skinny), the paper's BERT
    # MLP shape, an odd T; with and without bias
    for dtn in ("bfloat16", "float32"):
        dt = getattr(torch, dtn)
        for m, t, d, f, bias in ((4, 4, 2048, 5632, False), (4, 4, 2048, 5632, True),
                                 (32, 128, 768, 3072, False), (32, 128, 768, 3072, True),
                                 (3, 77, 768, 3072, True)):
            x = torch.randn(m, t, d, generator=g, device=dev).to(dt)
            w = (torch.randn(m, d, f, generator=g, device=dev) * d ** -0.5).to(dt)
            b = torch.randn(m, f, generator=g, device=dev) if bias else None
            got, want = fm.fused_matmul_cuda(x, w, b), fm.fused_matmul_plain(x, w, b)
            torch.cuda.synchronize()
            e = rel_err(got, want)
            key = f"fused_matmul/{dtn}/({m},{t},{d},{f})" + ("/bias" if bias else "")
            assert got.dtype == dt and e <= TOL[dtn], f"{key}: {e}"
            errs[key] = e
        # the scale in f32 and in x's dtype (the profiler's, at bert-base)
        scales = [((32, 128, 768), torch.float32), ((4, 128, 2048), torch.float32)]
        for (m, t, d), sdt in scales + ([((32, 128, 768), dt)] if dt != torch.float32 else []):
            x = (3 * torch.randn(m, t, d, generator=g, device=dev)).to(dt)
            scale = (1 + 0.1 * torch.randn(m, d, generator=g, device=dev)).to(sdt)
            got, want = gn.group_rms_norm_cuda(x, scale), gn.group_rms_norm_plain(x, scale)
            torch.cuda.synchronize()
            e = rel_err(got, want)
            key = f"group_rms_norm/{dtn}/({m},{t},{d})/scale_{str(sdt)[6:]}"
            assert got.dtype == dt and e <= TOL[dtn], f"{key}: {e}"
            errs[key] = e
        # mLSTM: the xlstm-1.3b profiler shape (one chunk of 32, hd 1024) and
        # four chunks of 64 with gate-neutral padded steps in 5 of 8 lanes
        ends = {(0, 0, 0): 100, (0, 0, 1): 1, (0, 1, 0): 64, (0, 1, 2): 255, (1, 1, 3): 130}
        for m, b, h, s, hd, chunk, pad in ((4, 4, 4, 32, 1024, 32, None),
                                           (2, 2, 4, 256, 128, 64, ends)):
            q, k, v, lf, li = mlstm_inputs(torch, dev, dt, m, b, h, s, hd, 22, pad)
            gh, gst = ml.mlstm_chunkwise_cuda(q, k, v, lf, li, chunk=chunk)
            wh, wst = ml.mlstm_chunkwise_plain(q, k, v, lf, li, chunk=chunk)
            torch.cuda.synchronize()
            e = max(rel_err(gh, wh), *(rel_err(a, w_) for a, w_ in zip(gst, wst)))
            key = f"mlstm_chunkwise/{dtn}/({m},{b},{h},{s},{hd})/chunk{chunk}" + (
                "/padded" if pad else "")
            assert gh.dtype == dt and e <= TOL[dtn], f"{key}: {e}"
            errs[key] = e
            if pad:
                # padded steps add exactly nothing: other junk in their q, k,
                # v leaves h at the valid steps and the final state bit for bit
                for (mi, bi, hi), e0 in pad.items():
                    for t_ in (q, k, v):
                        t_[mi, bi, hi, e0:] = 7 * torch.randn_like(t_[mi, bi, hi, e0:])
                gh2, gst2 = ml.mlstm_chunkwise_cuda(q, k, v, lf, li, chunk=chunk)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b_) for a, b_ in zip(gst, gst2)), f"{key}: state"
                for (mi, bi, hi), e0 in pad.items():
                    assert torch.equal(gh[mi, bi, hi, :e0], gh2[mi, bi, hi, :e0]), key
                errs[key + "/junk_invariant"] = 0.0
            del q, k, v, gh, wh, gst, wst
    return errs


def phase_paper(torch, dev, counts=(1, 8, 32), repeats=3):
    """The paper's evaluation at full width through benchmarks/torch_run.py:
    bert-base and xlnet-base at S=128, resnet50 and resnext50 at 224x224,
    bs=1, M in ``counts`` under sequential, concurrent (one CUDA stream per
    instance), hybrid (P=4, resnext) and netfuse; merged vs per-instance in
    f32 with TF32 off; peak memory per strategy and the merge time at
    M=32."""
    import torch_run as tr

    models = tr.bench_models(smoke=False)
    times = tr.fig5_inference_time(models, dev, counts=counts, repeats=repeats,
                                   hybrid={"resnext50": (4,)})
    top = max(counts)
    for name in models:
        t = {s: times[name, top, s] for (n, mm, s) in times if n == name and mm == top}
        assert all(v > 0 for v in t.values()), (name, t)
        log("paper", model=name, m=top, **{f"{s}_ms": f"{v / 1e3:.3f}" for s, v in t.items()},
            netfuse_speedup_vs_sequential=f"{t['sequential'] / t['netfuse']:.2f}x",
            netfuse_speedup_vs_concurrent=f"{t['concurrent'] / t['netfuse']:.2f}x")
    for name, (kind, cfg) in models.items():
        profile_paper_cell(torch, tr, name, tr.Bench(kind, cfg, dev), top)
    exact = tr.tab_exactness(models, dev)
    for name, (a, r) in exact.items():
        assert r <= PAPER_EXACT_TOL, f"tab_exact {name}: merged vs per-instance {r:.2e}"
        log("paper", model=name, tab_exact_max_abs_diff=f"{a:.2e}", rel=f"{r:.2e}",
            tolerance=PAPER_EXACT_TOL)
    for name in ("bert", "resnext50"):
        for (mm, s), (params_mb, peak_mb) in tr.fig7_memory(models, dev, counts=[top],
                                                            name=name).items():
            log("paper", model=name, m=mm, strategy=s, params_mb=f"{params_mb:.1f}",
                peak_allocated_mb=f"{peak_mb:.1f}")
    merge = tr.tab_merge_overhead(models, dev, counts=(top,))
    log("paper", model="resnext50", m=top, merge_ms=f"{merge[top] / 1e3:.3f}")
    return times


def profile_paper_cell(torch, tr, name, bench, m):
    """Where a paper cell's time goes: one sequential and one netfuse round
    at M=m under torch.profiler -- device busy share of the wall and the
    top kernels.  Then the multi-stream strategies (concurrent, hybrid
    P=4) are held element by element against sequential: the same kernels
    on the same inputs, so any gap beyond the dtype's tolerance is a
    missing wait or an early reuse of memory across streams."""
    from torch.profiler import ProfilerActivity, profile

    merged = bench.init(m)
    x = bench.inputs(m, 1)
    with torch.inference_mode():
        strat = tr.strategies(bench.apply, tr.instances(merged, m), merged, x, bench.dev,
                              hybrid=(4,))
        for s in ("sequential", "netfuse"):
            strat[s]()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                strat[s]()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            ev = [e for e in prof.key_averages() if device_us(e) > 0]
            busy = device_busy_s(prof)
            log("profile", run=f"paper/{name}/m{m}/{s}", wall_ms=round(1e3 * wall, 2),
                device_busy_ms=round(1e3 * busy, 2), device_idle_share=f"{1 - busy / wall:.1%}",
                kernels=sum(e.count for e in ev))
            for e in sorted(ev, key=device_us, reverse=True)[:3]:
                log("profile", run=f"paper/{name}/m{m}/{s}", kernel=e.key[:60], calls=e.count,
                    device_ms=round(device_us(e) / 1e3, 2))
        want = torch.stack(strat["sequential"]())
        for s in ("concurrent", "hybrid_4"):
            got = torch.stack(strat[s]())
            torch.cuda.synchronize()
            tol = TOL[str(want.dtype)[6:]]
            e = rel_err(got, want)
            assert got.shape == want.shape and e <= tol, f"paper {name} m{m} {s}: {e:.2e}"
            log("paper", model=name, m=m, strategy=s, vs_sequential_max_abs_diff=
                f"{abs_err(got, want):.2e}", rel=f"{e:.2e}", tolerance=tol)
    del merged, x, strat
    torch.cuda.empty_cache()


def phase_profile(torch, dev):
    """The port's kernel profiler (serving/obs/kernel_profile.py) on each
    kernel at the architecture that launches it, every launch counter set
    to 0 just before and read just after: the dense kernels at
    tinyllama-1.1b, the sLSTM and mLSTM at xlstm-1.3b, the decode attention
    at hymba-1.5b (M=4, the reference's serving geometry: 4 slots, context
    128, chunk 32, 4 lanes), the merged matmul and the group RMS norm at
    bert-base M=32 (bs 1, S 128)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.serving.obs import kernel_profile as kp

    plan = (("tinyllama-1.1b", M, ("decode_layer", "logits_sample", "chunk_prefill_attn",
                                   "fused_matmul")),
            ("xlstm-1.3b", M, ("slstm_cell", "mlstm_chunk")),
            ("hymba-1.5b", M, ("decode_attn",)))
    ops.reset_launches()
    rows = []
    for arch, m, kernels in plan:
        cfg = registry.get_config(arch).with_(num_instances=m)
        rows += [dict(r, arch=arch) for r in
                 kp.profile_serving_kernels(cfg, kernels=kernels, device=dev, repeats=5)]
    cfg = registry.get_config("bert-base").with_(num_instances=32)
    for k, shape in kp.paper_shapes(cfg).items():
        rows.append(dict(kp.profile_kernel(k, dtype=cfg.dtype, device=dev, repeats=5, **shape),
                         arch="bert-base"))
    launches = ops.launches()
    kp.validate_profile(rows)
    for r in rows:
        assert r["backend"] == "cuda" and not r["plain"], r
        log("profile", arch=r["arch"], kernel=r["kernel"], shape=repr(r["shape"]),
            ms=f"{1e3 * r['wall_s']:.4f}", bound_ms=f"{1e3 * r['bound_s']:.4f}",
            bound=r["bound"], of_roofline=f"{r['frac_of_roofline']:.1%}")
    for name in ("fused_matmul", "group_rms_norm", "mlstm_chunkwise"):
        assert launches[name] > 0, f"{name} was never launched by the profiler"
    log("profile", launches=json.dumps(launches).replace(" ", ""))
    # the tenth slice's kernels: the decode attention one kernel per wrapper
    # call (no combine pass), the mLSTM two (w and the gates, then the
    # state).  Counted by torch.profiler in a fresh process: in this one,
    # after the earlier phases' profiler sessions, a session has recorded
    # no device event for these calls (the serve and paper profiles above
    # do record them)
    out = subprocess.run([sys.executable, "-c", KERNELS_PER_CALL], capture_output=True,
                         text=True, timeout=300, cwd=HERE)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    again = json.loads(lines[-2])
    for name, names in json.loads(lines[-1]).items():
        want = 2 if name.startswith("mlstm") else 1
        log("profile", wrapper=name, kernels_per_call=len(names),
            names=",".join(sorted({n[:40] for n in names})) or "none recorded",
            sessions_profiled_again=again[name])
        assert len(names) in (0, want), f"{name}: {names}"
    return launches


# The device kernels one call of each tenth-slice wrapper runs:
# torch.profiler's per-kernel counts over 8 calls, after a warm-up call
# (a JSON object, wrapper -> kernel names, on the last line; before it,
# the sessions each wrapper profiled again).  A session whose counts are
# not a multiple of the 8 calls lost device events (a run on an H100 once
# recorded 7 of 8 decode-attention launches) and is profiled again, up to
# 3 sessions: a call's kernels do not vary, so a real extra or missing
# launch shows in every session and still fails.
KERNELS_PER_CALL = """
import json, os, sys
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
sys.path.insert(0, os.getcwd())
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import mlstm_chunk as ml
dev, bf16 = torch.device("cuda"), torch.bfloat16
attn_in = cs.decode_attn_inputs(torch, dev, bf16, 40, lens=(144, 673))
one = cs.mlstm_inputs(torch, dev, bf16, 4, 4, 4, 32, 1024, 41)
multi = cs.mlstm_inputs(torch, dev, bf16, 4, 1, 4, 256, 1024, 42)
calls = {"decode_attention": lambda: da.decode_attention_cuda(*attn_in),
         "mlstm_chunkwise": lambda: ml.mlstm_chunkwise_cuda(*one, chunk=32),
         "mlstm_chunkwise/4x64": lambda: ml.mlstm_chunkwise_cuda(*multi, chunk=64)}
res, again = {}, {}
for name, fn in calls.items():
    fn()
    torch.cuda.synchronize()
    for session in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if cs.device_us(e) > 0]
        if all(e.count % 8 == 0 for e in ev):
            break
    assert all(e.count % 8 == 0 for e in ev), [(e.key, e.count) for e in ev]
    res[name] = [e.key for e in ev for _ in range(e.count // 8)]
    again[name] = session
print(json.dumps(again))
print(json.dumps(res))
"""


def make_server(torch, dev, cfg, seed, **kw):
    """A server on M seeded random instances (``serve.random_merged``:
    each instance copied into the merged leaves as soon as it is drawn, or
    for moe and vlm drawn into them in place, so the card never holds the
    instances and their merge at once)."""
    from repro_torch.launch import serve
    from repro_torch.serving import MultiModelServer

    params = serve.random_merged(cfg, seed, dev)[0]
    return MultiModelServer(cfg, params, device=dev, **kw)


def requests(n, m, lo, hi, max_new, vocab, seed):
    import numpy as np
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    return [Request(i % m, rng.integers(1, vocab, int(rng.integers(lo, hi + 1))).tolist(),
                    max_new) for i in range(n)]


def ok_streams(out, n, new):
    """The streams of a serve (``serve.serve_rank``'s dict) once every one
    of its ``n`` requests ended ``ok`` with ``new`` tokens.  The engine ends
    the requests of a failed chunk call or scatter as ``error`` with no
    tokens, so two runs that failed alike would compare equal on their
    streams alone."""
    assert out["statuses"] == ["ok"] * n, out["statuses"]
    assert all(len(t) == new for t in out["streams"].values()), \
        [len(t) for t in out["streams"].values()]
    return out["streams"]


def drained(srv, n, new):
    """``ok_streams`` of draining the local server ``srv``."""
    res = srv.run_until_drained()
    return ok_streams({"statuses": [r.status for r in res],
                       "streams": {r.request_id: r.tokens for r in res}}, n, new)


def serve_path(torch, dev, arch, kernels, max_context=S, m=M, layers=None):
    """One main path: the full config of ``arch`` at ``m`` instances
    (``layers``: its depth cut), 16 requests with prompts of 16-512 tokens
    and 32 new tokens each, greedy, K=8.  Every launch counter is set to 0
    just before the run and read just after; each kernel in ``kernels``
    must have launched."""
    from repro_torch.configs import registry
    from repro_torch.kernels import build, ops

    cfg = registry.get_config(arch).with_(num_instances=m)
    if layers:
        cfg = cfg.with_(num_layers=layers)
    maps0 = build.tensor_maps.encodes
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = make_server(torch, dev, cfg, 0, slots_per_instance=B, max_context=max_context,
                      prefill_chunk=C, prefill_lanes=4, decode_steps=8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    reqs = requests(16, m, 16, 512, 32, cfg.vocab_size, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    results = srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    snap = srv.metrics.snapshot()
    assert len(results) == 16 and all(r.status == "ok" for r in results)
    assert all(len(r.tokens) == 32 for r in results), [len(r.tokens) for r in results]
    assert all(0 <= t < cfg.vocab_size for r in results for t in r.tokens)
    for name in kernels:
        assert launches[name] > 0, f"{name} was never launched on the {arch} path"
    log("serve", arch=cfg.name, instances=m, layers=cfg.num_layers, slots=B,
        requests=len(results),
        tokens=snap["generated_tokens"], wall_s=round(wall, 3),
        tok_per_s=round(snap["generated_tokens"] / wall, 1),
        decode_steps=snap["decode_steps"], decode_blocks=snap["decode_device_calls"],
        ms_per_decode_step=round(snap["decode_ms_per_step"], 3),
        decode_tok_per_s=round(snap["decode_tok_per_s"], 1),
        prefill_ms=round(1e3 * snap["prefill_wall_s"], 1),
        prefill_chunk_calls=snap["prefill_batches"],
        prefill_tokens=snap["prefill_tokens"],
        launches=json.dumps(launches).replace(" ", ""),
        max_memory_allocated_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2),
        setup_peak_gib=round(setup_peak / 2 ** 30, 2), setup_s=round(setup_s, 1),
        tensor_maps_encoded=build.tensor_maps.encodes - maps0)
    profile_serve(torch, srv, requests(16, m, 16, 512, 32, cfg.vocab_size, 5), arch)
    # the server holds a reference cycle (its step is a bound method): free
    # it now, or the next path's memory peak counts this path's weights
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, snap, launches, {r.request_id: r.tokens for r in results}


def phase_serve(torch, dev):
    from repro_torch.models import ssm

    cfg, snap, dense, dense_streams = serve_path(
        torch, dev, "tinyllama-1.1b", ("decode_layer", "chunk_prefill_attention", "logits_sample"))
    steps = snap["decode_steps"]
    log("serve", arch=cfg.name,
        decode_layer_launches_per_step=round(dense["decode_layer"] / steps, 2),
        logits_launches_per_step=round(dense["logits_sample"] / steps, 2),
        cuda_kernels_per_decode_step=10 * cfg.num_layers + 2)

    cfg, snap, xlstm, xlstm_streams = serve_path(torch, dev, "xlstm-1.3b",
                                                 ("slstm_cell", "logits_sample",
                                                  "fused_matmul"))
    n_slstm = len(ssm.mlstm_runs(cfg)) - 1
    n_mlstm, steps = cfg.num_layers - n_slstm, snap["decode_steps"]
    calls = snap["prefill_batches"] + steps
    assert xlstm["slstm_cell"] == n_slstm * calls, (xlstm, n_slstm, calls)
    # the mLSTM decode step's state product (q C) is the merged matmul in f32
    assert xlstm["fused_matmul"] == n_mlstm * steps, (xlstm, n_mlstm, steps)
    assert xlstm["decode_layer"] == xlstm["chunk_prefill_attention"] == 0, xlstm
    log("serve", arch=cfg.name, slstm_layers=n_slstm, chunk_calls_plus_decode_steps=calls,
        slstm_launches=xlstm["slstm_cell"],
        slstm_launches_check=f"{n_slstm}x{calls}=={xlstm['slstm_cell']}",
        fused_matmul_check=f"{n_mlstm}x{steps}=={xlstm['fused_matmul']}")

    from repro_torch.models import hybrid
    cfg, snap, hymba, hymba_streams = serve_path(torch, dev, "hymba-1.5b",
                                                 ("chunk_prefill_attention",
                                                  "decode_attention", "logits_sample"),
                                                 max_context=YS)
    steps, chunks, n = snap["decode_steps"], snap["prefill_batches"], cfg.num_layers
    # every layer's decode attention, global and SWA, is the kernel
    assert hymba["decode_attention"] == n * steps, (hymba, n, steps)
    assert hymba["chunk_prefill_attention"] == n * chunks, (hymba, chunks)
    assert hymba["logits_sample"] == steps, (hymba, steps)
    assert hymba["decode_layer"] == hymba["slstm_cell"] == hymba["fused_matmul"] == 0, hymba
    log("serve", arch=cfg.name, global_layers=len(hybrid.global_layers(cfg)),
        decode_steps=steps, decode_attention_launches=hymba["decode_attention"],
        decode_attention_check=f"{n}x{steps}=={hymba['decode_attention']}",
        chunk_launches_check=f"{cfg.num_layers}x{chunks}=={hymba['chunk_prefill_attention']}")

    # the moe family: 64 experts top-8 at full width and depth, M=4 (57 GB
    # of weights); the attention phase and the merged matmul carry decode,
    # the chunk attention and the merged matmul prefill
    cfg, snap, olmoe, olmoe_streams = serve_path(torch, dev, "olmoe-1b-7b",
                                                 ("chunk_prefill_attention", "decode_layer_attn",
                                                  "logits_sample", "fused_matmul"))
    steps, chunks, n = snap["decode_steps"], snap["prefill_batches"], cfg.num_layers
    assert olmoe["decode_layer_attn"] == n * steps, (olmoe, steps)
    assert olmoe["chunk_prefill_attention"] == n * chunks, (olmoe, chunks)
    assert olmoe["logits_sample"] == steps, (olmoe, steps)
    assert olmoe["fused_matmul"] == 3 * n * (steps + chunks), (olmoe, steps, chunks)
    assert olmoe["decode_layer"] == olmoe["decode_layer_ffn"] == 0, olmoe
    log("serve", arch=cfg.name, experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
        decode_steps=steps, chunk_calls=chunks,
        attn_phase_check=f"{n}x{steps}=={olmoe['decode_layer_attn']}",
        chunk_launches_check=f"{n}x{chunks}=={olmoe['chunk_prefill_attention']}",
        fused_matmul_check=f"3x{n}x({steps}+{chunks})=={olmoe['fused_matmul']}",
        logits_check=f"{steps}=={olmoe['logits_sample']}")

    # the vlm family: internvl2-26b at M=2 cut to VLM_LAYERS of 48 layers
    # (d 6144, 48 / 8 heads of 128, d_ff 16384, V 92553), the 256 zero
    # patch positions before every prompt; the whole decode layer, the
    # chunk attention and the logits
    cfg, snap, vlm, _ = serve_path(torch, dev, "internvl2-26b",
                                   ("decode_layer", "chunk_prefill_attention", "logits_sample"),
                                   m=VLM_M, layers=VLM_LAYERS)
    steps, chunks, n = snap["decode_steps"], snap["prefill_batches"], cfg.num_layers
    assert vlm["decode_layer"] == n * steps, (vlm, steps)
    assert vlm["chunk_prefill_attention"] == n * chunks, (vlm, chunks)
    assert vlm["logits_sample"] == steps, (vlm, steps)
    assert vlm["fused_matmul"] == vlm["decode_layer_attn"] == 0, vlm
    log("serve", arch=cfg.name, instances=VLM_M, layers=n, image_patches=cfg.num_image_patches,
        decode_steps=steps, chunk_calls=chunks,
        decode_layer_check=f"{n}x{steps}=={vlm['decode_layer']}",
        chunk_launches_check=f"{n}x{chunks}=={vlm['chunk_prefill_attention']}",
        logits_check=f"{steps}=={vlm['logits_sample']}",
        merged_gb_from_shapes=round(vlm_shard_bytes(cfg, 1)[0] / 1e9, 2))

    # the audio family: whisper-small at full width and depth, M=4; every
    # chunk call reruns the 12-layer encoder over the 1500 zero frames of
    # each lane (12 chunk-attention launches) before the 12 decoder layers
    # (12 more); a decode step runs 12 self- and 12 cross-attention
    # launches of the decode-attention kernel; no logits kernel (layer norm,
    # f32 tied head, argmax)
    cfg, snap, audio, audio_streams = serve_path(
        torch, dev, "whisper-small", ("chunk_prefill_attention", "decode_attention",
                                      "fused_matmul"))
    steps, chunks, n = snap["decode_steps"], snap["prefill_batches"], cfg.num_layers
    n_enc = cfg.encoder_layers
    assert audio["chunk_prefill_attention"] == (n_enc + n) * chunks, (audio, chunks)
    assert audio["decode_attention"] == 2 * n * steps, (audio, steps)
    # the prefill's cross-attention: two merged matmuls per decoder layer
    assert audio["fused_matmul"] == 2 * n * chunks, (audio, chunks)
    assert not any(v for k, v in audio.items()
                   if k not in ("chunk_prefill_attention", "decode_attention",
                                "fused_matmul")), audio
    log("serve", arch=cfg.name, encoder_layers=n_enc, decoder_layers=n,
        audio_frames=cfg.num_audio_frames, decode_steps=steps, chunk_calls=chunks,
        chunk_launches_check=f"({n_enc}+{n})x{chunks}=={audio['chunk_prefill_attention']}",
        decode_attention_check=f"2x{n}x{steps}=={audio['decode_attention']}",
        fused_matmul_check=f"2x{n}x{chunks}=={audio['fused_matmul']}",
        params_gb_from_shapes=round(audio_bytes(cfg) / 1e9, 2),
        cross_cache_gb_from_shapes=round(2 * n * M * B * cfg.num_audio_frames * cfg.d_model
                                         * 2 / 1e9, 3))
    return ({"tinyllama-1.1b": dense, "xlstm-1.3b": xlstm, "hymba-1.5b": hymba,
             "olmoe-1b-7b": olmoe, "internvl2-26b": vlm, "whisper-small": audio},
            {"tinyllama-1.1b": dense_streams, "xlstm-1.3b": xlstm_streams,
             "hymba-1.5b": hymba_streams, "whisper-small": audio_streams}, olmoe_streams)


def periphery_streams(torch, srv, reqs, *, plan=None, watchdog_s=None, trace=False,
                      http_idx=()):
    """Serve ``reqs`` through an ``AsyncEngine`` under a ``Supervisor``
    (``plan``: a fault plan armed just before; ``trace``: tracing and
    accounting on for the run; ``http_idx``: those requests are sent as
    SSE completions over HTTP on 127.0.0.1 instead, with the scrape
    routes read after).  Returns (Results in request order, supervisor,
    seconds, what HTTP answered)."""
    import asyncio

    from repro_torch.serving import (AsyncEngine, FaultInjector, Supervisor,
                                     start_http_server)

    async def client(engine, r):
        s = await engine.submit(r)
        toks = [t async for t in s]
        res = await s.result()
        assert res.tokens == toks, (res.request_id, res.status)
        return res

    async def sse(port, r):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        body = json.dumps({"model": r.instance, "prompt": r.prompt,
                           "max_tokens": r.max_new_tokens, "stream": True}).encode()
        writer.write(f"POST /v1/completions HTTP/1.1\r\nHost: t\r\nContent-Length: "
                     f"{len(body)}\r\n\r\n".encode() + body)
        await writer.drain()
        raw = await reader.read()
        writer.close()
        head, _, rest = raw.partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 200"), head
        ev = [json.loads(x[6:]) for x in rest.split(b"\n\n")
              if x.startswith(b"data: ") and x != b"data: [DONE]"]
        return [e["choices"][0]["token"] for e in ev if e["choices"][0]["token"] is not None]

    async def get(port, path, accept="application/json"):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\nAccept: {accept}\r\n\r\n".encode())
        await writer.drain()
        raw = await reader.read()
        writer.close()
        head, _, rest = raw.partition(b"\r\n\r\n")
        return int(head.split()[1]), rest.decode()

    async def main():
        engine = AsyncEngine(srv)
        sup = Supervisor(engine, watchdog_s=watchdog_s, max_retries=8, seed=0)
        sup.start()
        if trace:
            await engine.set_tracing(True)
            await engine.set_accounting(True)
        if plan is not None:
            srv.faults = FaultInjector(plan["faults"], seed=plan.get("seed", 0)).arm()
        t0 = time.perf_counter()
        if http_idx:
            http = await start_http_server(engine, "127.0.0.1", 0)
            port = http.sockets[0].getsockname()[1]
            toks = await asyncio.gather(*(sse(port, reqs[i]) for i in http_idx))
            wall = time.perf_counter() - t0
            got = {"sse": toks, "metrics": await get(port, "/metrics", "text/plain"),
                   "healthz": await get(port, "/healthz")}
            http.close()
            await http.wait_closed()
            await engine.aclose()
            return [], sup, wall, got
        out = await asyncio.gather(*(client(engine, r) for r in reqs))
        wall = time.perf_counter() - t0
        await engine.aclose()
        return out, sup, wall, None

    out = asyncio.run(asyncio.wait_for(main(), 600))
    torch.cuda.synchronize()
    return out


PROM_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
                         r'(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*",?)*\})?'
                         r' (NaN|[+-]Inf|[+-]?[0-9.eE+-]+)$')


def phase_periphery(torch, dev, single_streams):
    """The serving periphery around the tinyllama-1.1b serve cell (module
    docstring, phase 4b).  Returns the launch counts of gate (a)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import FaultInjector, HealthMonitor, MultiModelServer

    cfg = registry.get_config("tinyllama-1.1b").with_(num_instances=M)
    t0 = time.perf_counter()
    params = serve.random_merged(cfg, 0, dev)[0]
    kw = dict(slots_per_instance=B, max_context=S, prefill_chunk=C, prefill_lanes=4,
              decode_steps=8)
    mix = lambda: requests(16, M, 16, 512, 32, cfg.vocab_size, 0)
    want = [single_streams["tinyllama-1.1b"][i] for i in range(16)]
    servers = []

    def server(**k):
        # one server at a time beside the shared params: free the last
        servers.clear()
        gc.collect()
        torch.cuda.empty_cache()
        servers.append(MultiModelServer(cfg, params, device=dev, **kw, **k))
        return servers[-1]

    def equal(results, idx=range(16)):
        return sum(results[i].tokens == want[i] for i in idx)

    def clean(name, results, sup):
        assert all(r.status == "ok" for r in results), \
            (name, [(r.request_id, r.status, r.error) for r in results if r.status != "ok"])
        assert sup.restarts == 0, (name, sup.snapshot())

    warm = server()
    for r in mix():
        warm.submit(r)
    res = warm.run_until_drained()
    torch.cuda.synchronize()
    assert [r.tokens for r in sorted(res, key=lambda r: r.request_id)] == want, "warm drain"
    log("periphery", gate="warm", setup_and_warm_s=round(time.perf_counter() - t0, 1))

    # (a) async streams; the path's launch counts
    srv = server()
    ops.reset_launches()
    out, sup, wall_a, _ = periphery_streams(torch, srv, mix())
    launches = ops.launches()
    clean("a", out, sup)
    n = equal(out)
    assert n == 16, f"async streams equal to the serve phase's: {n} of 16"
    for name in ("decode_layer", "chunk_prefill_attention", "logits_sample"):
        assert launches[name] > 0, f"{name} was never launched on the periphery path"
    log("periphery", gate="a_async", equal=f"{n}/16", restarts=sup.restarts,
        tok_per_s=round(512 / wall_a, 1), wall_s=round(wall_a, 3),
        launches=json.dumps(launches).replace(" ", ""))

    # (b) supervised crash recovery, exactly once
    plan = {"seed": 0, "faults": [{"site": "driver", "kind": "raise", "at_call": 3},
                                  {"site": "decode", "kind": "raise", "at_call": 7},
                                  {"site": "prefill", "kind": "raise", "at_call": 2}]}
    srv = server()
    out, sup, wall_b, _ = periphery_streams(torch, srv, mix(), plan=plan)
    fired = list(srv.faults.fired)
    crashes = [f for f in fired if f[2] == "raise"]
    assert all(r.status == "ok" for r in out), [(r.request_id, r.status, r.error)
                                                for r in out if r.status != "ok"]
    n = equal(out)
    assert n == 16, f"crash-replay streams equal: {n} of 16"
    assert srv.metrics.replay_mismatches == 0, srv.metrics.replay_mismatches
    assert len(crashes) == 3, fired
    assert sup.restarts == len(crashes), (sup.snapshot(), fired)
    recov = sup.snapshot()["recoveries"]
    log("periphery", gate="b_crash_replay", equal=f"{n}/16", fired=json.dumps(fired),
        restarts=sup.restarts, replay_mismatches=srv.metrics.replay_mismatches,
        replayed_tokens=srv.metrics.replayed_tokens, wall_s=round(wall_b, 3),
        time_to_recover_ms=[round(1e3 * r["time_to_recover_s"], 3) for r in recov],
        reasons=[r["reason"].rsplit(":", 1)[-1].strip() for r in recov])

    # (d) tracing and accounting on; tok/s with tracing off, then on
    srv = server()
    out_off, sup, wall_off, _ = periphery_streams(torch, srv, mix())
    clean("d_off", out_off, sup)
    srv = server()
    out, sup, wall_on, _ = periphery_streams(torch, srv, mix(), trace=True)
    clean("d", out, sup)
    n = equal(out)
    assert n == 16 and equal(out_off) == 16, f"traced streams equal: {n} of 16"
    cons = srv.accounting.conservation()
    assert cons["settled_s"] > 0 and cons["rel_err"] < 1e-6, cons
    summ = srv.tracer.summary()
    gap = summ["dispatch_overhead_ms"]
    log("periphery", gate="d_traced", equal=f"{n}/16", conservation_rel_err=cons["rel_err"],
        settled_s=round(cons["settled_s"], 4),
        dispatch_gap_ms_p50_p95_p99=[round(gap[k], 3) for k in ("p50", "p95", "p99")],
        mean_grid_occupancy=round(summ["mean_grid_occupancy"], 4),
        mean_lane_occupancy=round(summ["mean_prefill_lane_occupancy"], 4),
        device_calls=summ["device_calls"],
        tok_per_s_tracing_off=round(512 / wall_off, 1),
        tok_per_s_tracing_on=round(512 / wall_on, 1))

    # (e) HTTP: two SSE completions, the Prometheus scrape, /healthz
    srv = server()
    _, sup, wall_e, got = periphery_streams(torch, srv, mix(), http_idx=(0, 1))
    assert sup.restarts == 0 and srv.metrics.snapshot()["failed"] == 0, sup.snapshot()
    assert got["sse"] == want[:2], "SSE streams differ from (a)"
    st, text = got["metrics"]
    lines = text.strip().split("\n")
    bad = [l for l in lines if not l.startswith("# ") and not PROM_SAMPLE.match(l)]
    assert st == 200 and not bad, (st, bad[:3])
    assert got["healthz"][0] == 200, got["healthz"]
    log("periphery", gate="e_http", sse_equal="2/2", prometheus_lines=len(lines),
        healthz=got["healthz"][0], wall_s=round(wall_e, 3))

    # (f) the watchdog on a decode stall, soft recovery
    plan = {"faults": [{"site": "decode", "kind": "stall", "stall_s": PERIPHERY_STALL_S,
                        "at_call": 3}]}
    srv = server()
    out, sup, wall_f, _ = periphery_streams(torch, srv, mix(), plan=plan,
                                            watchdog_s=PERIPHERY_WATCHDOG_S)
    assert all(r.status == "ok" for r in out), [r.status for r in out]
    n = equal(out)
    assert sup.watchdog_timeouts == 1 and sup.restarts == 1, sup.snapshot()
    assert n == 16, f"streams after the watchdog's soft recovery: {n} of 16"
    log("periphery", gate="f_watchdog", equal=f"{n}/16", watchdog_timeouts=sup.watchdog_timeouts,
        restarts=sup.restarts, wall_s=round(wall_f, 3),
        time_to_recover_ms=[round(1e3 * r["time_to_recover_s"], 3)
                            for r in sup.snapshot()["recoveries"]])

    # (c) a NaN on instance 2 quarantines instance 2 alone
    quarantined = []
    hm = HealthMonitor(M)
    srv = server(health=hm, faults=FaultInjector([{"site": "decode", "kind": "nan",
                                                   "instance": 2, "at_call": 4}]))
    hm.on_quarantine = quarantined.append
    for r in mix():
        srv.submit(r)
    srv.faults.arm()
    res = sorted(srv.run_until_drained(), key=lambda r: r.request_id)
    torch.cuda.synchronize()
    others = [i for i in range(16) if i % M != 2]
    n = equal(res, others)
    errors = [r.request_id for r in res if r.status == "error"]
    assert quarantined == [2] and errors and all(i % M == 2 for i in errors), \
        (quarantined, errors)
    assert n == len(others), f"other instances' streams: {n} of {len(others)}"
    per = hm.snapshot()["per_instance"]
    assert [p["quarantines"] for p in per] == [0, 0, 1, 0], per
    log("periphery", gate="c_quarantine", quarantined=quarantined, failed=errors,
        others_equal=f"{n}/{len(others)}", states_after=hm.states())
    servers.clear()
    del params
    gc.collect()
    return launches


def device_us(e):
    """An event's own device time in us (an op's total would count its
    kernels a second time under the op)."""
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0.0))


def device_busy_s(prof):
    """Seconds in which at least one kernel ran: the union of the device
    events' time ranges, so overlapping streams count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def profile_serve(torch, srv, reqs, arch):
    """Where the serve time goes: the cell's mix (``reqs``, 16 requests)
    served again, engine step by engine step, with the
    ``PROFILE_STEPS`` steps that follow the first decode block traced by
    torch.profiler -- the device busy share of that window's wall, the
    chunk calls and decode blocks in it, and the top kernels.  The window
    bounds the trace (its stop and read took 343 s of an H100 serve phase
    over four cells when it held whole 16-request runs); the profiler's
    own overhead stretches the window's wall."""
    from torch.profiler import ProfilerActivity, profile

    n0 = srv.metrics.snapshot()
    for r in reqs:
        srv.submit(r)
    results = []
    while srv.busy() and srv.metrics.snapshot()["decode_device_calls"] == n0["decode_device_calls"]:
        results += srv.step()
    before = srv.metrics.snapshot()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 0
        while srv.busy() and steps < PROFILE_STEPS:
            results += srv.step()
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
    after = srv.metrics.snapshot()
    read_s = time.perf_counter() - t0
    results += srv.run_until_drained()
    assert len(results) == len(reqs) and all(r.status == "ok" for r in results)
    ev = [e for e in prof.key_averages() if device_us(e) > 0]
    busy = device_busy_s(prof)
    delta = {k: after[k] - before[k] for k in ("prefill_batches", "decode_device_calls",
                                               "decode_steps")}
    log("profile", run=f"serve/{arch}", requests=len(reqs), window_engine_steps=steps,
        window_chunk_calls=delta["prefill_batches"],
        window_decode_blocks=delta["decode_device_calls"],
        window_decode_steps=delta["decode_steps"], wall_s=round(wall, 3),
        device_busy_s=round(busy, 3), device_idle_share=f"{1 - busy / wall:.1%}",
        profiler_stop_and_read_s=round(read_s, 1))
    if arch == "tinyllama-1.1b":
        # the whole decode layer's kernels against its launches in this run:
        # the wgmma path is six a layer (QKV, ring attention, its combine,
        # out-projection, gate/up, down)
        layer = {e.key: e.count for e in ev
                 if re.search(r"tc_matvec|ring_attn_kernel|ring_combine_kernel", e.key)}
        layers = delta["decode_steps"] * srv.cfg.num_layers
        per_layer = sum(layer.values()) / layers
        log("profile", run=f"serve/{arch}", decode_layer_kernels_per_layer=per_layer)
        assert per_layer <= 6, (per_layer, layer)
    for e in sorted(ev, key=device_us, reverse=True)[:8]:
        log("profile", run=f"serve/{arch}", kernel=e.key[:60], calls=e.count,
            device_ms=round(device_us(e) / 1e3, 2))


def chunk_decode_cpu(cfg, params, tok, width, ctx):
    """The single-device plain path on the CPU: prefill ``tok`` in chunks
    of ``width``, a greedy decode step and a decode step (the reference of
    ``tp_parity.chunk_decode_rank``)."""
    import torch

    from repro_torch import api
    from repro_torch.models.common import tree_map

    m, b, n = tok.shape
    carry = api.init_chunk_carry(cfg, m, b, ctx, device="cpu")
    for start in range(0, n, width):
        api.prefill_chunk(cfg, params, {"tokens": tok[:, :, start:start + width]}, carry,
                          torch.full((m, b), start, dtype=torch.int32))
    cache = carry["cache"]
    out = {"k": cache.k.clone(), "v": cache.v.clone()}
    pos = torch.full((m, b), n, dtype=torch.int32)
    nxt, _ = api.decode_step_sample(cfg, params, tree_map(lambda t: t.clone(), cache),
                                    tok[:, :, -1:], pos)
    logits, _ = api.decode_step(cfg, params, cache, tok[:, :, -1:], pos)
    return dict(out, logits=logits, tokens=nxt)


def phase_tp(torch, dev):
    """Tensor-parallel serving over TP=2 ranks, one process each, sharing
    the card (``mesh.spawn``; gloo, since NCCL refuses two ranks on one
    card).  Every rank, in one spawn: the full tinyllama-1.1b (M=4,
    TP_REQUESTS requests of 16-512 tokens, 32 new, K=8), every launch
    counter set to 0 just before and read just after; the same model cut
    to 4 layers at K=1 and K=8; the f32 smoke config (vocab 256, so that
    it splits) through prefill chunks and a decode step.  Checked here:
    the sharded kernels launched (22 attention and 22 FFN phases per
    decode step) and the whole-layer kernel never; the ranks' streams
    identical; K=1 == K=8; the f32 config's cache shards, gathered logits
    and greedy tokens equal to the single-device plain path on the CPU.
    The ssm family in the same spawn: xlstm-1.3b cut to XLSTM_TP_LAYERS
    (the serve mix; ``check_xlstm_rank``, ranks equal, and how many
    streams equal a one-device serve of the same cut, served here first),
    cut to XLSTM_CHECK_LAYERS at K=1 and K=8, and xlstm-smoke in f32 (V
    256, so that the head splits) against the CPU.  Returns rank 0's
    launches by path."""
    import numpy as np

    from repro_torch import api
    from repro_torch.configs import registry
    from repro_torch.launch import mesh, serve, tp_parity
    from repro_torch.serving import MultiModelServer

    xcfg = registry.get_config("xlstm-1.3b").with_(num_instances=M,
                                                   num_layers=XLSTM_TP_LAYERS)
    xcut = xcfg.with_(num_layers=XLSTM_CHECK_LAYERS)
    xsmall = registry.get_smoke_config("xlstm-1.3b").with_(num_instances=2, vocab_size=256)
    xsmall_params = api.init(xsmall, torch.Generator().manual_seed(0), "cpu")
    xsmall_kw = dict(slots_per_instance=2, max_context=64, prefill_chunk=8, decode_steps=4)
    xmix = lambda: requests(TP_REQUESTS, M, 16, 512, 32, xcfg.vocab_size, 0)
    xcheck = requests(8, M, 16, 120, 16, xcut.vocab_size, 1)
    xsmall_reqs = requests(8, 2, 1, 48, 8, xsmall.vocab_size, 3)
    cpu = MultiModelServer(xsmall, xsmall_params, device="cpu", **xsmall_kw)
    for q in xsmall_reqs:
        cpu.submit(q)
    want_xsmall = drained(cpu, len(xsmall_reqs), 8)
    t0 = time.perf_counter()
    one = serve.serve(xcfg, 0, xmix(), device=dev, slots_per_instance=B, max_context=S,
                      prefill_chunk=C, prefill_lanes=4, decode_steps=8)
    one_streams = ok_streams({"statuses": [r.status for r in one["results"]],
                              "streams": {r.request_id: r.tokens for r in one["results"]}},
                             TP_REQUESTS, 32)
    log("tp", arch=xcfg.name, layers=xcfg.num_layers, reference="one device, bf16",
        tok_per_s=round(one["snapshot"]["generated_tokens"] / one["wall_s"], 1),
        ms_per_decode_step=round(one["snapshot"]["decode_ms_per_step"], 3),
        seconds=round(time.perf_counter() - t0, 1))
    del one
    gc.collect()
    torch.cuda.empty_cache()

    cfg = registry.get_config("tinyllama-1.1b").with_(num_instances=M)
    cut = cfg.with_(num_layers=4)
    small = registry.get_smoke_config("tinyllama-1.1b").with_(num_instances=2, vocab_size=256)
    small_params = api.init(small, torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(np.random.default_rng(2).integers(1, 256, (2, 2, 24)).astype(np.int32))
    serve_kw = dict(slots_per_instance=B, max_context=S, prefill_chunk=C, prefill_lanes=4,
                    decode_steps=8)
    check_kw = dict(slots_per_instance=2, max_context=S, prefill_chunk=C)
    check_reqs = requests(12, M, 16, 200, 16, cut.vocab_size, 1)
    log("tp", ranks=TP, cards=torch.cuda.device_count(), rule=repr(mesh.describe(TP, "cuda")))
    t0 = time.perf_counter()
    ranks = mesh.spawn(
        mesh.in_turn, TP,
        (serve.serve_rank, cfg, 0, requests(TP_REQUESTS, M, 16, 512, 32, cfg.vocab_size, 0),
         serve_kw),
        (serve.serve_rank, cut, 1, check_reqs, dict(check_kw, decode_steps=1)),
        (serve.serve_rank, cut, 1, check_reqs, dict(check_kw, decode_steps=8)),
        (tp_parity.chunk_decode_rank, small, small_params, tok, 8, 64),
        (tp_parity.all_reduce_rank, (M, B, D), 50),
        (tp_parity.all_reduce_rank, (4, 1, C, D), 20),
        (serve.serve_rank, xcfg, 0, xmix(), serve_kw),
        (serve.serve_rank, xcut, 1, xcheck, dict(check_kw, decode_steps=1)),
        (serve.serve_rank, xcut, 1, xcheck, dict(check_kw, decode_steps=8)),
        (serve.serve_rank, xsmall, xsmall_params, xsmall_reqs, xsmall_kw),
        device="cuda")
    log("tp", spawn_and_run_s=round(time.perf_counter() - t0, 1))
    full = [r[0] for r in ranks]
    for rank, out in enumerate(full):
        la, snap = out["launches"], out["snapshot"]
        steps, chunks = snap["decode_steps"], snap["prefill_batches"]
        assert out["statuses"] == ["ok"] * TP_REQUESTS, out["statuses"]
        assert all(len(t) == 32 for t in out["streams"].values())
        assert la["decode_layer"] == 0, la
        assert la["decode_layer_attn"] == la["decode_layer_ffn"] == cfg.num_layers * steps, la
        assert la["logits_sample"] == steps, (la, steps)
        assert la["chunk_prefill_attention"] == cfg.num_layers * chunks, (la, chunks)
        log("tp", arch=cfg.name, rank=rank, device=out["device"], backend=out["backend"],
            requests=TP_REQUESTS, tokens=snap["generated_tokens"], wall_s=round(out["wall_s"], 3),
            tok_per_s=round(snap["generated_tokens"] / out["wall_s"], 1),
            ms_per_decode_step=round(snap["decode_ms_per_step"], 3), decode_steps=steps,
            decode_blocks=snap["decode_device_calls"],
            prefill_ms=round(1e3 * snap["prefill_wall_s"], 1), prefill_chunk_calls=chunks,
            attn_phase_launches_per_step=round(la["decode_layer_attn"] / steps, 2),
            ffn_phase_launches_per_step=round(la["decode_layer_ffn"] / steps, 2),
            serve_peak_gib_on_card=round(out["peak_gib"], 2),
            setup_peak_gib_on_card=round(out["setup_peak_gib"], 2),
            launches=json.dumps(la).replace(" ", ""))
    assert all(o["streams"] == full[0]["streams"] for o in full), "the ranks' streams differ"
    k1 = [ok_streams(r[1], len(check_reqs), 16) for r in ranks]
    k8 = [ok_streams(r[2], len(check_reqs), 16) for r in ranks]
    assert all(s_ == k1[0] for s_ in k1 + k8), "greedy streams differ between K=1 and K=8"
    log("tp", arch=cut.name, layers=cut.num_layers, streams="K1==K8, ranks equal",
        requests=len(k1[0]), tokens=sum(len(t) for t in k1[0].values()))
    want = chunk_decode_cpu(small, small_params, tok, 8, 64)
    got = [r[3] for r in ranks]
    e_cache = max(rel_err(torch.cat([g[leaf] for g in got], 4), want[leaf]) for leaf in "kv")
    e_logits = max(rel_err(g["logits"], want["logits"]) for g in got)
    assert e_cache <= TOL["float32"] and e_logits <= TOL["float32"], (e_cache, e_logits)
    assert all(torch.equal(g["tokens"], want["tokens"]) for g in got), "greedy tokens differ"
    steps = full[0]["snapshot"]["decode_steps"]
    for rank, r in enumerate(ranks):
        # 2 sums per layer: their share of the decode step on this rank
        share = 2 * cfg.num_layers * r[4] / full[rank]["snapshot"]["decode_ms_per_step"]
        log("tp", rank=rank, all_reduce_ms_decode=round(r[4], 4),
            all_reduce_ms_prefill_chunk=round(r[5], 4),
            sums_per_decode_step=2 * cfg.num_layers, sum_share_of_decode_step=f"{share:.1%}")
    log("tp", reference="cpu-plain single device", config=small.name, vocab=small.vocab_size,
        kv_heads_per_rank=got[0]["k"].shape[4], cache_rel_err=f"{e_cache:.2e}",
        logits_rel_err=f"{e_logits:.2e}", tokens="equal")

    xfull = [r[6] for r in ranks]
    for rank, out in enumerate(xfull):
        steps, chunks, sums, gathers = check_xlstm_rank(xcfg, out, TP_REQUESTS, 32, TP)
        snap = out["snapshot"]
        log("tp", arch=xcfg.name, layers=xcfg.num_layers, rank=rank, device=out["device"],
            backend=out["backend"], requests=TP_REQUESTS, tokens=snap["generated_tokens"],
            wall_s=round(out["wall_s"], 3),
            tok_per_s=round(snap["generated_tokens"] / out["wall_s"], 1),
            ms_per_decode_step=round(snap["decode_ms_per_step"], 3), decode_steps=steps,
            decode_blocks=snap["decode_device_calls"],
            prefill_ms=round(1e3 * snap["prefill_wall_s"], 1), prefill_chunk_calls=chunks,
            slstm_per_layer_pass=out["launches"]["slstm_cell"] / (steps + chunks),
            fused_matmul_per_step=round(out["launches"]["fused_matmul"] / steps, 2),
            sums_per_pass=sums, gathers_per_pass=gathers,
            serve_peak_gib_on_card=round(out["peak_gib"], 2),
            setup_peak_gib_on_card=round(out["setup_peak_gib"], 2),
            host_param_gib=round(out["host_param_gib"], 2), setup_s=round(out["setup_s"], 1),
            launches=json.dumps(out["launches"]).replace(" ", ""))
    assert all(o["streams"] == xfull[0]["streams"] for o in xfull), "xlstm: ranks differ"
    same = sum(xfull[0]["streams"][i] == one_streams[i] for i in one_streams)
    # how far each stream runs with one device's before the rounding of the
    # row-split sums turns a token (information, not a gate)
    common = [next((j for j, (a, b) in enumerate(zip(xfull[0]["streams"][i], one_streams[i]))
                    if a != b), 32) for i in one_streams]
    log("tp", arch=xcfg.name, layers=xcfg.num_layers,
        streams_equal_to_one_device=f"{same}/{TP_REQUESTS}",
        first_tokens_equal=f"{sum(c > 0 for c in common)}/{TP_REQUESTS}",
        mean_common_prefix_tokens=round(sum(common) / len(common), 2))
    xk1 = [ok_streams(r[7], len(xcheck), 16) for r in ranks]
    xk8 = [ok_streams(r[8], len(xcheck), 16) for r in ranks]
    assert all(s_ == xk1[0] for s_ in xk1 + xk8), "xlstm: streams differ between K=1 and K=8"
    for r in ranks:
        check_xlstm_rank(xcut, r[8], len(xcheck), 16, TP)
    log("tp", arch=xcut.name, layers=xcut.num_layers, streams="K1==K8, ranks equal",
        requests=len(xk1[0]), tokens=sum(len(t) for t in xk1[0].values()),
        wall_s=[round(ranks[0][i]["wall_s"], 1) for i in (7, 8)],
        setup_s=[round(ranks[0][i]["setup_s"], 1) for i in (7, 8)])
    for r in ranks:
        check_xlstm_rank(xsmall, r[9], len(xsmall_reqs), 8, TP)
        assert r[9]["streams"] == want_xsmall, "xlstm-smoke TP=2: streams differ from the CPU"
    log("tp", reference="cpu-plain single device", config=xsmall.name, vocab=xsmall.vocab_size,
        requests=len(want_xsmall), tokens=sum(len(t) for t in want_xsmall.values()),
        streams="equal")
    return {f"tinyllama-1.1b/tp{TP}-rank0": full[0]["launches"],
            f"xlstm-1.3b/tp{TP}-rank0": xfull[0]["launches"]}


def check_xlstm_rank(cfg, out, n_req, new, t):
    """One xlstm TP rank's serve over ``t`` ranks whose heads split: every
    request done with ``new`` tokens; per layer pass (each decode step
    and each chunk call) the sLSTM cell once per sLSTM layer, a sum per
    sLSTM layer and two per mLSTM layer, a gather per sLSTM layer; per
    decode step the merged matmul once per mLSTM layer (q C) and the
    logits kernel once, over the rank's vocab slice where V divides
    (then combined by two small all-reduces); no attention or
    decode-layer kernel.  Returns (decode steps, chunk calls, sums and
    gathers a pass)."""
    from repro_torch.models import shardings, ssm

    la, snap, col = out["launches"], out["snapshot"], out["collectives"]
    steps, chunks = snap["decode_steps"], snap["prefill_batches"]
    n_s = len(ssm.mlstm_runs(cfg)) - 1
    n_m, passes = cfg.num_layers - n_s, steps + chunks
    ok_streams(out, n_req, new)
    assert la["slstm_cell"] == n_s * passes, (la, n_s, passes)
    assert la["fused_matmul"] == n_m * steps, (la, n_m, steps)
    assert la["logits_sample"] == steps, (la, steps)
    assert not any(v for k, v in la.items()
                   if k not in ("slstm_cell", "fused_matmul", "logits_sample")), la
    assert col["all_reduce_sum"] == (2 * n_m + n_s) * passes, (col, passes)
    assert col["all_gather"] == n_s * passes, (col, passes)
    vocab = shardings.vocab_split(cfg, t)
    assert col.get("all_reduce", 0) == (2 * steps if vocab else 0), (col, steps)
    return steps, chunks, col["all_reduce_sum"] // passes, col["all_gather"] // passes


def check_hybrid_rank(cfg, out, n_req, new):
    """One hybrid TP rank's serve: every request done with ``new`` tokens;
    decode_attention_sharded once per layer and decode step, the
    plain-device decode_attention and the dense and ssm kernels never,
    the chunk kernel once per layer and chunk call, the logits once per
    step.  Returns (decode steps, chunk calls)."""
    from repro_torch.models import hybrid

    la, snap = out["launches"], out["snapshot"]
    steps, chunks = snap["decode_steps"], snap["prefill_batches"]
    n = cfg.num_layers
    assert out["statuses"] == ["ok"] * n_req, out["statuses"]
    assert all(len(t) == new for t in out["streams"].values())
    assert la["decode_attention_sharded"] == n * steps, (la, n, steps)
    assert la["chunk_prefill_attention"] == cfg.num_layers * chunks, (la, chunks)
    assert la["logits_sample"] == steps, (la, steps)
    assert la["decode_attention"] == la["decode_layer"] == la["decode_layer_attn"] == 0, la
    assert la["slstm_cell"] == 0, la
    return steps, chunks


def phase_tp_hybrid(torch, dev):
    """Tensor-parallel hybrid serving over ranks sharing the card
    (``mesh.spawn``, gloo).  TP=2, in one spawn: the full hymba-1.5b
    (M=4, TP_REQUESTS requests of 16-512 tokens, 32 new, K=8,
    max_context 1536), every launch counter set to 0 just before and
    read just after; the same model cut to 4 layers at K=1 and K=8; the
    f32 smoke config (4 layers); the cost of one cross-rank sum at the
    decode and prefill-chunk shapes.  TP=5: the "kv" plan end to end (4
    layers, M=2, the widths kept).  TP=4: the f32 smoke config under
    "expand", and in the same spawn xlstm-smoke widened to 4 heads
    (d_model 128) in f32.  Checked here: the launches of every rank
    (``check_hybrid_rank``, ``check_xlstm_rank``), the ranks' streams
    identical, K=1 == K=8, and the smoke configs' streams equal to the
    single-device plain path on the CPU."""
    from types import SimpleNamespace

    from repro_torch import api
    from repro_torch.configs import registry
    from repro_torch.launch import mesh, serve, tp_parity
    from repro_torch.models import shardings
    from repro_torch.serving import MultiModelServer

    cfg = registry.get_config("hymba-1.5b").with_(num_instances=M)
    cut = cfg.with_(num_layers=4)
    kv_cut = cfg.with_(num_instances=2, num_layers=4)
    small = registry.get_smoke_config("hymba-1.5b").with_(num_instances=2, num_layers=4)
    small_params = api.init(small, torch.Generator().manual_seed(0), "cpu")
    small_reqs = requests(8, 2, 1, 48, 8, small.vocab_size, 3)
    small_kw = dict(slots_per_instance=2, max_context=192, prefill_chunk=16, decode_steps=4)
    # the sLSTM kernel steps hd by 32: xlstm-smoke over 4 ranks needs 4
    # heads at d_model 128
    wide = registry.get_smoke_config("xlstm-1.3b").with_(num_instances=2, d_model=128,
                                                         num_heads=4, num_kv_heads=4)
    wide_params = api.init(wide, torch.Generator().manual_seed(0), "cpu")
    wide_reqs = requests(8, 2, 1, 48, 8, wide.vocab_size, 3)
    wide_kw = dict(slots_per_instance=2, max_context=64, prefill_chunk=8, decode_steps=4)
    serve_kw = dict(slots_per_instance=B, max_context=YS, prefill_chunk=C, prefill_lanes=4,
                    decode_steps=8)
    check_kw = dict(slots_per_instance=2, max_context=YS, prefill_chunk=C)
    check_reqs = requests(12, M, 16, 200, 16, cut.vocab_size, 1)
    kv_reqs = requests(8, 2, 16, 200, 16, kv_cut.vocab_size, 2)
    for n, c in ((TP, cfg), (5, kv_cut), (4, small)):
        sp = shardings.hybrid_split(c, SimpleNamespace(rank=0, size=n))
        log("tp_hybrid", ranks=n, config=c.name, plan=sp.plan,
            heads_split=sp.heads is not None, ffn_split=sp.ffn is not None,
            ssm_split=sp.ssm is not None, rule=repr(mesh.describe(n, "cuda")))
    t0 = time.perf_counter()
    ranks = mesh.spawn(
        mesh.in_turn, TP,
        (serve.serve_rank, cfg, 0, requests(TP_REQUESTS, M, 16, 512, 32, cfg.vocab_size, 0),
         serve_kw),
        (serve.serve_rank, cut, 1, check_reqs, dict(check_kw, decode_steps=1)),
        (serve.serve_rank, cut, 1, check_reqs, dict(check_kw, decode_steps=8)),
        (serve.serve_rank, small, small_params, small_reqs, small_kw),
        (tp_parity.all_reduce_rank, (M, B, YD), 50),
        (tp_parity.all_reduce_rank, (4, 1, C, YD), 20),
        device="cuda")
    log("tp_hybrid", ranks=TP, spawn_and_run_s=round(time.perf_counter() - t0, 1))
    full = [r[0] for r in ranks]
    sp = shardings.hybrid_split(cfg, SimpleNamespace(rank=0, size=TP))
    sums = cfg.num_layers * sum(g is not None for g in (sp.heads, sp.ffn, sp.ssm))
    for rank, (out, r) in enumerate(zip(full, ranks)):
        steps, chunks = check_hybrid_rank(cfg, out, TP_REQUESTS, 32)
        snap, la = out["snapshot"], out["launches"]
        log("tp_hybrid", arch=cfg.name, rank=rank, device=out["device"],
            backend=out["backend"], requests=TP_REQUESTS, tokens=snap["generated_tokens"],
            wall_s=round(out["wall_s"], 3),
            tok_per_s=round(snap["generated_tokens"] / out["wall_s"], 1),
            ms_per_decode_step=round(snap["decode_ms_per_step"], 3), decode_steps=steps,
            decode_blocks=snap["decode_device_calls"],
            prefill_ms=round(1e3 * snap["prefill_wall_s"], 1), prefill_chunk_calls=chunks,
            decode_attention_sharded_per_step=round(la["decode_attention_sharded"] / steps, 2),
            chunk_launches_check=f"{cfg.num_layers}x{chunks}=={la['chunk_prefill_attention']}",
            serve_peak_gib_on_card=round(out["peak_gib"], 2),
            setup_peak_gib_on_card=round(out["setup_peak_gib"], 2),
            launches=json.dumps(la).replace(" ", ""))
        share = sums * r[4] / snap["decode_ms_per_step"]
        log("tp_hybrid", rank=rank, all_reduce_ms_decode=round(r[4], 4),
            all_reduce_ms_prefill_chunk=round(r[5], 4), sums_per_decode_step=sums,
            sum_share_of_decode_step=f"{share:.1%}")
    assert all(o["streams"] == full[0]["streams"] for o in full), "the ranks' streams differ"
    k1, k8 = [r[1]["streams"] for r in ranks], [r[2]["streams"] for r in ranks]
    assert all(s_ == k1[0] for s_ in k1 + k8), "greedy streams differ between K=1 and K=8"
    for r in ranks:
        check_hybrid_rank(cut, r[1], len(check_reqs), 16)
    log("tp_hybrid", arch=cut.name, layers=cut.num_layers, streams="K1==K8, ranks equal",
        requests=len(k1[0]), tokens=sum(len(t) for t in k1[0].values()))

    cpu = MultiModelServer(small, small_params, device="cpu", **small_kw)
    for q in requests(8, 2, 1, 48, 8, small.vocab_size, 3):
        cpu.submit(q)
    want = drained(cpu, 8, 8)
    cpu = MultiModelServer(wide, wide_params, device="cpu", **wide_kw)
    for q in wide_reqs:
        cpu.submit(q)
    want_wide = drained(cpu, len(wide_reqs), 8)
    t0 = time.perf_counter()
    kv_ranks = mesh.spawn(
        mesh.in_turn, 5, (serve.serve_rank, kv_cut, 2, kv_reqs,
                          dict(check_kw, decode_steps=8)), device="cuda")
    expand_ranks = mesh.spawn(mesh.in_turn, 4,
                              (serve.serve_rank, small, small_params, small_reqs, small_kw),
                              (serve.serve_rank, wide, wide_params, wide_reqs, wide_kw),
                              device="cuda")
    log("tp_hybrid", ranks="5 and 4", spawn_and_run_s=round(time.perf_counter() - t0, 1))
    kv = [r[0] for r in kv_ranks]
    for out in kv:
        check_hybrid_rank(kv_cut, out, len(kv_reqs), 16)
    assert all(o["streams"] == kv[0]["streams"] for o in kv), "the kv-plan ranks differ"
    log("tp_hybrid", arch=kv_cut.name, ranks=5, plan=shardings.head_plan(kv_cut, 5),
        layers=kv_cut.num_layers,
        instances=kv_cut.num_instances, streams="ranks equal",
        tokens=sum(len(t) for t in kv[0]["streams"].values()),
        ms_per_decode_step=round(kv[0]["snapshot"]["decode_ms_per_step"], 3),
        launches=json.dumps(kv[0]["launches"]).replace(" ", ""))
    for n, outs in ((TP, [r[3] for r in ranks]), (4, [r[0] for r in expand_ranks])):
        for out in outs:
            check_hybrid_rank(small, out, len(small_reqs), 8)
            assert out["streams"] == want, f"smoke TP={n}: streams differ from the CPU path"
        log("tp_hybrid", reference="cpu-plain single device", config=small.name, ranks=n,
            plan=shardings.head_plan(small, n), requests=len(want),
            tokens=sum(len(t) for t in want.values()), streams="equal")
    for r in expand_ranks:
        check_xlstm_rank(wide, r[1], len(wide_reqs), 8, 4)
        assert r[1]["streams"] == want_wide, "xlstm-smoke 4 heads TP=4: streams differ"
    log("tp_hybrid", reference="cpu-plain single device", config=wide.name, ranks=4,
        heads=wide.num_heads, d_model=wide.d_model, requests=len(want_wide),
        tokens=sum(len(t) for t in want_wide.values()), streams="equal",
        launches=json.dumps(expand_ranks[0][1]["launches"]).replace(" ", ""))
    return full[0]["launches"]


def check_dense_rank(cfg, out, n_req, new, split_layers):
    """One dense rank's serve on a mesh: every request done with ``new``
    tokens; per decode step the whole-layer kernel once per layer where
    the layers are whole on the rank, else the attention and FFN phases
    once each per layer; the chunk kernel once per layer and chunk call;
    the logits once per step.  Returns (decode steps, chunk calls)."""
    la, snap = out["launches"], out["snapshot"]
    steps, chunks = snap["decode_steps"], snap["prefill_batches"]
    n_layers = cfg.num_layers * steps
    assert out["statuses"] == ["ok"] * n_req, out["statuses"]
    assert all(len(t) == new for t in out["streams"].values())
    if split_layers:
        assert la["decode_layer"] == 0, la
        assert la["decode_layer_attn"] == la["decode_layer_ffn"] == n_layers, (la, steps)
    else:
        assert la["decode_layer"] == n_layers, (la, steps)
        assert la["decode_layer_attn"] == la["decode_layer_ffn"] == 0, la
    assert la["chunk_prefill_attention"] == cfg.num_layers * chunks, (la, chunks)
    assert la["logits_sample"] == steps, (la, steps)
    return steps, chunks


def check_audio_rank(cfg, out):
    """One whisper rank's serve: per chunk call the chunk attention once
    per encoder and decoder layer and the merged matmul twice per decoder
    layer (the cross K/V), per decode step the decode attention twice per
    decoder layer (self and cross); no other kernel."""
    la, snap = out["launches"], out["snapshot"]
    steps, chunks, n = snap["decode_steps"], snap["prefill_batches"], cfg.num_layers
    assert la["chunk_prefill_attention"] == (cfg.encoder_layers + n) * chunks, (la, chunks)
    assert la["decode_attention"] == 2 * n * steps, (la, steps)
    assert la["fused_matmul"] == 2 * n * chunks, (la, chunks)
    assert not any(v for k, v in la.items() if k not in (
        "chunk_prefill_attention", "decode_attention", "fused_matmul")), la


def phase_data(torch, dev, single_streams):
    """Serving on (data=D, model=T) meshes, the D*T ranks sharing the card
    over gloo (``mesh.spawn(..., data=D)``): the data axis splits the
    grid's instance rows over the D groups, each group splits its model
    over T.  For each mesh of DATA_MESHES, in one spawn: the full
    tinyllama-1.1b (M=4, TP_REQUESTS requests of 16-512 tokens, 32 new,
    K=8), every launch counter set to 0 just before and read just after on
    each rank; the f32 smoke config (M=4, vocab 256); the cost of the data
    gather of one K-step block and of one model-group sum.  At 2x2 also:
    the same model cut to 4 layers at K=1 and K=8, and
    ``fused_matmul_sharded`` on each rank's block of a seeded (4, 4, 2048,
    5632) problem with bias, bf16 and f32.  At 2x1 also: the full
    xlstm-1.3b and hymba-1.5b (M=4, the serve phase's mix of TP_REQUESTS
    requests, K=8; hymba at context 1536) and whisper-small (M=4, the
    same mix; each data rank holds 2 instances and their cross caches).
    Checked here: the launches of
    every rank (``check_dense_rank``: whole layers at 2x1, the phase
    kernels at 2x2), the ranks' streams identical, K=1 == K=8, the smoke
    config's streams equal to the single-device plain path on the CPU, the
    reassembled matmul blocks against the
    plain version on the whole problem, each rank's wrapper launched once
    per call, and the 2x1 streams of all four models equal to the serve
    phase's single-device streams at M (``single_streams``, by arch): a
    lane's bf16 result does not depend on how many instances its call
    holds; whisper-small's launches on each rank (``check_audio_rank``).
    Returns each mesh's rank 0 launches (and at 2x1 xlstm's, hymba's and
    whisper's) and the matmul wrapper's launches summed over the ranks."""
    from types import SimpleNamespace

    from repro_torch import api
    from repro_torch.configs import registry
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.launch import mesh, serve, tp_parity
    from repro_torch.models import shardings
    from repro_torch.serving import MultiModelServer

    cfg = registry.get_config("tinyllama-1.1b").with_(num_instances=M)
    cut = cfg.with_(num_layers=4)
    # served at 2x1 beside tinyllama, each against the serve phase's streams
    others = [registry.get_config(a).with_(num_instances=M)
              for a in ("xlstm-1.3b", "hymba-1.5b", "whisper-small")]
    small = registry.get_smoke_config("tinyllama-1.1b").with_(num_instances=M, vocab_size=256)
    small_params = api.init(small, torch.Generator().manual_seed(0), "cpu")
    small_reqs = requests(8, M, 1, 48, 8, small.vocab_size, 3)
    small_kw = dict(slots_per_instance=2, max_context=64, prefill_chunk=8, decode_steps=4)
    serve_kw = dict(slots_per_instance=B, max_context=S, prefill_chunk=C, prefill_lanes=4,
                    decode_steps=8)
    check_kw = dict(slots_per_instance=2, max_context=S, prefill_chunk=C)
    check_reqs = requests(12, M, 16, 200, 16, cut.vocab_size, 1)
    problems = [(5, M, B, D, F, dt, True) for dt in (torch.bfloat16, torch.float32)]
    cpu = MultiModelServer(small, small_params, device="cpu", **small_kw)
    for q in small_reqs:
        cpu.submit(q)
    want_small = drained(cpu, len(small_reqs), 8)
    out, matmul_launches = {}, 0
    for d, t in DATA_MESHES:
        rows = shardings.data_rows(M, B, SimpleNamespace(rank=0, size=d))
        # at T=1 the model gets no handle and runs whole layers
        split_layers = t > 1 and shardings.layers_split(cfg, t)
        log("data", mesh=f"{d}x{t}", ranks=d * t, split=rows.split,
            instances_per_group=rows.m, layers_split=split_layers,
            rule=repr(mesh.describe(d * t, "cuda")))
        m_l = rows.m
        calls = [(serve.serve_rank, cfg, 0,
                  requests(TP_REQUESTS, M, 16, 512, 32, cfg.vocab_size, 0), serve_kw),
                 (serve.serve_rank, small, small_params, small_reqs, small_kw),
                 (tp_parity.data_gather_rank, (2, 8, m_l, B), 50),
                 (tp_parity.all_reduce_rank, (m_l, B, D), 50)]
        if t > 1:
            calls += [(serve.serve_rank, cut, 1, check_reqs, dict(check_kw, decode_steps=1)),
                      (serve.serve_rank, cut, 1, check_reqs, dict(check_kw, decode_steps=8))]
            calls += [(tp_parity.fused_matmul_rank, p) for p in problems]
        else:
            calls += [(serve.serve_rank, fcfg, 0,
                       requests(TP_REQUESTS, M, 16, 512, 32, fcfg.vocab_size, 0),
                       dict(serve_kw, max_context=YS if fcfg.family == "hybrid" else S))
                      for fcfg in others]
        t0 = time.perf_counter()
        ranks = mesh.spawn(mesh.in_turn, t, *calls, device="cuda", data=d)
        log("data", mesh=f"{d}x{t}", spawn_and_run_s=round(time.perf_counter() - t0, 1))
        full = [r[0] for r in ranks]
        for rank, (o, r) in enumerate(zip(full, ranks)):
            steps, chunks = check_dense_rank(cfg, o, TP_REQUESTS, 32, split_layers)
            snap, la = o["snapshot"], o["launches"]
            assert snap["mesh"] == {"shape": {"data": d, "model": t}, "devices": d * t}, snap
            sums = 2 * cfg.num_layers if split_layers else 0
            log("data", mesh=f"{d}x{t}", rank=rank, data_index=rank // t, model_index=rank % t,
                device=o["device"], backend=o["backend"], requests=TP_REQUESTS,
                tokens=snap["generated_tokens"], wall_s=round(o["wall_s"], 3),
                tok_per_s=round(snap["generated_tokens"] / o["wall_s"], 1),
                ms_per_decode_step=round(snap["decode_ms_per_step"], 3), decode_steps=steps,
                decode_blocks=snap["decode_device_calls"],
                prefill_ms=round(1e3 * snap["prefill_wall_s"], 1), prefill_chunk_calls=chunks,
                decode_layer_per_step=round(la["decode_layer"] / steps, 2),
                attn_phase_per_step=round(la["decode_layer_attn"] / steps, 2),
                ffn_phase_per_step=round(la["decode_layer_ffn"] / steps, 2),
                data_gather_ms=round(r[2], 4), sums_per_decode_step=sums,
                ms_per_sum=round(r[3], 4) if sums else "n/a",
                serve_peak_gib_on_card=round(o["peak_gib"], 2),
                setup_peak_gib_on_card=round(o["setup_peak_gib"], 2),
                host_param_gib=round(o["host_param_gib"], 2),
                launches=json.dumps(la).replace(" ", ""))
        assert all(o["streams"] == full[0]["streams"] for o in full), f"{d}x{t}: ranks differ"
        for r in ranks:
            assert r[1]["streams"] == want_small, f"smoke {d}x{t}: streams differ from the CPU"
        log("data", mesh=f"{d}x{t}", reference="cpu-plain single device", config=small.name,
            requests=len(want_small), tokens=sum(len(v) for v in want_small.values()),
            streams="equal")
        if t == 1:
            for j, arch in enumerate(["tinyllama-1.1b"] + [c.name for c in others]):
                runs = [r[0] if j == 0 else r[3 + j] for r in ranks]
                one = single_streams[arch]
                assert all(o["statuses"] == ["ok"] * TP_REQUESTS for o in runs), arch
                assert all(o["streams"] == runs[0]["streams"] for o in runs), f"{arch}: ranks"
                same = sum(runs[0]["streams"][i] == one[i] for i in one)
                if arch == "whisper-small":
                    for o in runs:
                        check_audio_rank(others[j - 1], o)
                if j:
                    o = runs[0]
                    snap = o["snapshot"]
                    log("data", mesh=f"{d}x{t}", arch=arch, rank=0,
                        tokens=snap["generated_tokens"], wall_s=round(o["wall_s"], 3),
                        tok_per_s=round(snap["generated_tokens"] / o["wall_s"], 1),
                        ms_per_decode_step=round(snap["decode_ms_per_step"], 3),
                        decode_steps=snap["decode_steps"],
                        prefill_ms=round(1e3 * snap["prefill_wall_s"], 1),
                        prefill_chunk_calls=snap["prefill_batches"],
                        serve_peak_gib_on_card=round(o["peak_gib"], 2),
                        launches=json.dumps(o["launches"]).replace(" ", ""))
                    out[f"{arch}/data{d}x{t}-rank0"] = o["launches"]
                log("data", mesh=f"{d}x{t}", arch=arch,
                    streams_equal_to_single_device_at_M=f"{same}/{TP_REQUESTS}")
                assert same == TP_REQUESTS, (
                    f"{arch}: 2x1 streams differ from one device at M={M}: {same}")
        else:
            k1, k8 = [r[4]["streams"] for r in ranks], [r[5]["streams"] for r in ranks]
            assert all(s_ == k1[0] for s_ in k1 + k8), "greedy streams differ between K=1 and K=8"
            for r in ranks:
                check_dense_rank(cut, r[4], len(check_reqs), 16, split_layers)
            log("data", mesh=f"{d}x{t}", arch=cut.name, layers=cut.num_layers,
                streams="K1==K8, ranks equal", requests=len(k1[0]))
            for i, p in enumerate(problems):
                blocks = [r[6 + i] for r in ranks]
                assert all(b_["launches"] == 1 for b_ in blocks), [b_["launches"] for b_ in blocks]
                matmul_launches += sum(b_["launches"] for b_ in blocks)
                x, w, b = tp_parity.matmul_problem(*p)
                want = fm.fused_matmul_plain(x.to(dev), w.to(dev), b.to(dev))
                got = fm.assemble([b_["out"].to(dev) for b_ in blocks], M, F, d, t)
                dtn = str(p[5]).removeprefix("torch.")
                e = rel_err(got, want)
                assert e <= TOL[dtn], f"fused_matmul_sharded in ranks {dtn}: {e}"
                log("data", mesh=f"{d}x{t}", kernel="fused_matmul_sharded", dtype=dtn,
                    shape=f"({M},{B},{D})@({M},{D},{F})+bias",
                    block=f"({M // d},{B},{D})@({M // d},{D},{F // t})",
                    launches_per_rank=[b_["launches"] for b_ in blocks], rel_err=f"{e:.3e}")
                del x, w, b, want, got
        out[f"{d}x{t}"] = full[0]["launches"]
    return out, matmul_launches


def _size(dtype_name):
    return 4 if dtype_name == "float32" else 2


def audio_bytes(cfg):
    """Bytes of an audio model's merged params in the port's storage
    dtypes, from shapes."""
    import math

    import torch

    from repro_torch.models import audio

    total = 0
    for group, leaf in audio._shapes(cfg).items():
        items = leaf.items() if isinstance(leaf, dict) else [(group, leaf)]
        for name, (shape, _) in items:
            total += math.prod(shape) * (4 if audio._dtype(cfg, name) == torch.float32 else 2)
    return total


def moe_shard_bytes(cfg, n):
    """A moe rank's shard over ``n`` model ranks in the port's storage
    dtypes, from shapes (``shardings.moe_layer_dims``), and the largest
    one-instance layer of a leaf in f32 (what a rank's draw holds beside
    its shard, twice: the normal draw and its scaled copy)."""
    import math

    import torch

    from repro_torch.models import moe, shardings

    dims = shardings.moe_layer_dims(cfg, n)
    total, leaf = 0, 0
    for name, (shape, _) in moe._layer_shapes(cfg).items():
        size = 4 if moe._leaf_dtype(cfg, name) == torch.float32 else 2
        total += math.prod(shape) * size // (n if name in dims else 1)
        leaf = max(leaf, math.prod(shape[2:]) * 4)
    par = _size(cfg.param_dtype)
    m, d, v = cfg.num_instances, cfg.d_model, cfg.vocab_size
    head = m * d * v * par // (n if shardings.vocab_split(cfg, n) else 1)
    return total + (m * v * d + m * d) * par + head, leaf


def cache_bytes(cfg, m, slots, lanes, ctx, kvh):
    """The decode cache, the prefill carry and its one-lane initial rows
    of a KV-cache family in cfg.dtype (the counts of moe are small)."""
    per_lane = 2 * cfg.num_layers * ctx * kvh * cfg.head_dim * _size(cfg.dtype)
    return per_lane * (m * slots + lanes + 1)


def moe_mesh_rank_log(cfg, out, d, t, rank, n_req, new, sums):
    """Check one moe rank's serve on a mesh and log it: every request done
    with ``new`` tokens; per decode step the attention phase once per
    layer, the merged matmul three times per layer (gate, up, down), the
    whole-layer kernel never; per chunk call the chunk kernel once and the
    merged matmul three times per layer; the logits once per step.
    Returns (decode steps, chunk calls)."""
    la, snap = out["launches"], out["snapshot"]
    steps, chunks, n = snap["decode_steps"], snap["prefill_batches"], cfg.num_layers
    assert out["statuses"] == ["ok"] * n_req, out["statuses"]
    assert all(len(x) == new for x in out["streams"].values())
    assert snap["mesh"] == {"shape": {"data": d, "model": t}, "devices": d * t}, snap
    assert la["decode_layer"] == la["decode_layer_ffn"] == 0, la
    assert la["decode_layer_attn"] == n * steps, (la, steps)
    assert la["fused_matmul"] == 3 * n * (steps + chunks), (la, steps, chunks)
    assert la["chunk_prefill_attention"] == n * chunks, (la, chunks)
    assert la["logits_sample"] == steps, (la, steps)
    log("moe_mesh", mesh=f"{d}x{t}", arch=cfg.name, layers=n, rank=rank,
        data_index=rank // t, model_index=rank % t, device=out["device"],
        backend=out["backend"], requests=n_req, tokens=snap["generated_tokens"],
        wall_s=round(out["wall_s"], 3),
        tok_per_s=round(snap["generated_tokens"] / out["wall_s"], 1),
        ms_per_decode_step=round(snap["decode_ms_per_step"], 3), decode_steps=steps,
        decode_blocks=snap["decode_device_calls"],
        prefill_ms=round(1e3 * snap["prefill_wall_s"], 1), prefill_chunk_calls=chunks,
        attn_phase_per_step=round(la["decode_layer_attn"] / steps, 2),
        fused_matmul_per_step=3 * n, sums_per_decode_step=sums,
        serve_peak_gib_on_card=round(out["peak_gib"], 2),
        setup_peak_gib_on_card=round(out["setup_peak_gib"], 2),
        launches=json.dumps(la).replace(" ", ""))
    return steps, chunks


def phase_moe_mesh(torch, dev, single_streams, meshes=MOE_MESHES):
    """Merged MoE on (data=D, model=T) meshes, the D*T ranks sharing the
    card over gloo, each rank drawing only its shard on the card
    (``serve.random_merged`` with ``shardings.moe_cut``).  1x2: the full
    olmoe-1b-7b (M=4, TP_REQUESTS requests of 16-512 tokens, 32 new, K=8;
    a rank holds 8 of 16 heads, 32 of 64 experts an instance and half of
    the vocab), every launch counter set to 0 just before and read just
    after on each rank; the cost of one sum.  2x1: the same model, each
    rank holding 2 instances whole.  2x2: qwen3-moe-30b-a3b cut to
    QWEN_LAYERS layers (M=4; 128 experts in windows of 64, 32 / 4 heads),
    at K=8 on the serve mix and at K=1 and K=8 on a shorter mix.  On every
    mesh: the f32 olmoe-smoke config (vocab 256, so that it splits).
    Checked here: every rank's launches (``moe_mesh_rank_log``), the
    ranks' streams identical, the smoke config's streams equal to the
    single-device plain path on the CPU, the 2x1 streams equal to the
    serve phase's one-device streams (``single_streams``) in 16 of 16,
    K=1 == K=8 at 2x2, and no 1x2 rank's setup peak above its shard, its
    caches and one layer of a leaf drawn in f32 (twice).  Reported: how
    many of the 1x2 streams equal one device's (bf16 partials summed over
    the ranks: equality is not expected).  Returns each full serve's rank
    0 launches by path name."""
    from repro_torch import api
    from repro_torch.configs import registry
    from repro_torch.launch import mesh, serve, tp_parity
    from repro_torch.models import shardings
    from repro_torch.serving import MultiModelServer

    olmoe = registry.get_config("olmoe-1b-7b").with_(num_instances=M)
    qwen = registry.get_config("qwen3-moe-30b-a3b").with_(num_instances=M,
                                                          num_layers=QWEN_LAYERS)
    small = registry.get_smoke_config("olmoe-1b-7b").with_(num_instances=2, vocab_size=256)
    small_params = api.init(small, torch.Generator().manual_seed(0), "cpu")
    small_reqs = requests(8, 2, 1, 48, 8, small.vocab_size, 3)
    small_kw = dict(slots_per_instance=2, max_context=64, prefill_chunk=8, decode_steps=4)
    serve_kw = dict(slots_per_instance=B, max_context=S, prefill_chunk=C, prefill_lanes=4,
                    decode_steps=8)
    check_kw = dict(slots_per_instance=2, max_context=S, prefill_chunk=C)
    cpu = MultiModelServer(small, small_params, device="cpu", **small_kw)
    for q in small_reqs:
        cpu.submit(q)
    want_small = drained(cpu, len(small_reqs), 8)
    out = {}
    for d, t in meshes:
        cfg = qwen if (d, t) == (2, 2) else olmoe
        reqs = requests(TP_REQUESTS, M, 16, 512, 32, cfg.vocab_size, 0)
        check_reqs = requests(12, M, 16, 200, 16, cfg.vocab_size, 1)
        calls = [(serve.serve_rank, cfg, 0, reqs, serve_kw),
                 (serve.serve_rank, small, small_params, small_reqs, small_kw),
                 (tp_parity.all_reduce_rank, (M // d, B, cfg.d_model), 50)]
        if (d, t) == (2, 2):
            calls += [(serve.serve_rank, cfg, 1, check_reqs, dict(check_kw, decode_steps=k))
                      for k in (1, 8)]
        log("moe_mesh", mesh=f"{d}x{t}", arch=cfg.name, layers=cfg.num_layers,
            attn_split=shardings.attn_split(cfg, t), expert_window=cfg.num_experts // t,
            vocab_split=shardings.vocab_split(cfg, t), rule=repr(mesh.describe(d * t, "cuda")))
        t0 = time.perf_counter()
        ranks = mesh.spawn(mesh.in_turn, t, *calls, device="cuda", data=d)
        log("moe_mesh", mesh=f"{d}x{t}", spawn_and_run_s=round(time.perf_counter() - t0, 1))
        full = [r[0] for r in ranks]
        sums = 2 * cfg.num_layers if t > 1 else 0
        for rank, (o, r) in enumerate(zip(full, ranks)):
            steps, _ = moe_mesh_rank_log(cfg, o, d, t, rank, TP_REQUESTS, 32, sums)
            if sums:
                share = sums * r[2] / o["snapshot"]["decode_ms_per_step"]
                log("moe_mesh", mesh=f"{d}x{t}", rank=rank, ms_per_sum=round(r[2], 4),
                    sums_per_decode_step=f"{cfg.num_layers} attention + {cfg.num_layers} "
                    f"expert + the logits combine (2 small)",
                    sum_share_of_decode_step=f"{share:.1%}")
        assert all(o["streams"] == full[0]["streams"] for o in full), f"{d}x{t}: ranks differ"
        if (d, t) == (1, 2):
            shard, leaf = moe_shard_bytes(cfg, t)
            caches = cache_bytes(cfg, M, B, 4, S, cfg.num_kv_heads // t)
            limit = shard + caches + 2 * leaf + 2 ** 28     # 256 MiB for small tensors
            for rank, o in enumerate(full):
                peak = o["setup_peak_gib"] * 2 ** 30
                log("moe_mesh", mesh=f"{d}x{t}", rank=rank,
                    shard_gib_from_shapes=round(shard / 2 ** 30, 2),
                    caches_gib=round(caches / 2 ** 30, 2),
                    one_layer_leaf_f32_gib=round(leaf / 2 ** 30, 3),
                    setup_peak_gib_on_card=round(o["setup_peak_gib"], 2),
                    limit_gib=round(limit / 2 ** 30, 2))
                assert peak <= limit, f"rank {rank} drew more than its shard: {peak} > {limit}"
        if cfg is olmoe:
            same = sum(full[0]["streams"][i] == single_streams[i] for i in single_streams)
            if d > 1:
                assert same == TP_REQUESTS, f"{d}x{t} streams differ from one device: {same}"
            log("moe_mesh", mesh=f"{d}x{t}",
                streams_equal_to_single_device_at_M=f"{same}/{TP_REQUESTS}")
        else:
            k1 = [ok_streams(r[3], len(check_reqs), 16) for r in ranks]
            k8 = [ok_streams(r[4], len(check_reqs), 16) for r in ranks]
            assert all(x == k1[0] for x in k1 + k8), "greedy streams differ between K=1 and K=8"
            log("moe_mesh", mesh=f"{d}x{t}", arch=cfg.name, streams="K1==K8, ranks equal",
                requests=len(k1[0]))
        for r in ranks:
            assert r[1]["streams"] == want_small, f"smoke {d}x{t}: streams differ from the CPU"
        log("moe_mesh", mesh=f"{d}x{t}", reference="cpu-plain single device",
            config=small.name, requests=len(want_small),
            tokens=sum(len(v) for v in want_small.values()), streams="equal")
        out[f"{cfg.name}/mesh{d}x{t}-rank0"] = full[0]["launches"]
    return out


def vlm_shard_bytes(cfg, n):
    """A vlm rank's shard over ``n`` model ranks in the port's storage
    dtypes, from shapes (dense's rules: ``shardings.layers_split`` /
    ``vocab_split``; the projector whole; n = 1: the merged model), and
    the largest one-instance leaf in f32 (what a rank's draw holds beside
    its shard, twice: the normal draw and its scaled copy)."""
    import math

    import torch

    from repro_torch.models import shardings, vlm

    split = n > 1 and shardings.layers_split(cfg, n)
    total, leaf = 0, 0
    for group, sub in vlm._shapes(cfg).items():
        items = sub.items() if isinstance(sub, dict) else [(group, sub)]
        for name, (shape, _) in items:
            dt = vlm._dtype(cfg, group, name) if isinstance(sub, dict) else torch.float32
            cut = (group == "layers" and split and name in shardings.LAYER_SPLIT_DIM) or (
                name == "lm_head" and shardings.vocab_split(cfg, n))
            total += math.prod(shape) * (4 if dt == torch.float32 else 2) // (n if cut else 1)
            one = shape[2:] if group == "layers" else shape[1:]
            leaf = max(leaf, math.prod(one) * 4)
    return total, leaf


def phase_vlm_mesh(torch, dev):
    """The vlm family on a model-parallel mesh, the ranks sharing the card
    over gloo, each rank drawing only its shard on the card
    (``serve.random_merged`` with ``shardings.vlm_cut``): internvl2-26b at
    VLM_M instances cut to VLM_LAYERS layers on 1x2 (a rank: 24 / 48 q
    heads, 4 / 8 kv heads, 8192 of d_ff; the projector, the embedding and
    the odd-vocab head whole), the serve phase's mix (TP_REQUESTS requests
    of 16-512 tokens after the 256 patch positions, 32 new, K=8), every
    launch counter set to 0 just before and read just after on each rank;
    the cost of one sum.  The f32 internvl2-smoke config on 1x2 (its
    layers split) and 1x4 (its 4 / 2 heads do not split "kv" over 4
    ranks: layers whole).  Checked here: every rank's launches
    (``check_dense_rank``: the attention and FFN phases once a layer and
    step, the whole layer never), the ranks' streams identical, the smoke
    streams equal to the single-device plain path on the CPU, and no 1x2
    rank's setup peak above its shard, its caches and one drawn leaf of an
    instance in f32 (twice).  Reported: tok/s, ms per decode step, sums
    per step and ms per sum, each rank's setup and serving peaks.
    Returns the full serve's rank 0 launches."""
    from repro_torch import api
    from repro_torch.configs import registry
    from repro_torch.launch import mesh, serve, tp_parity
    from repro_torch.models import shardings
    from repro_torch.serving import MultiModelServer

    t = 2
    cfg = registry.get_config("internvl2-26b").with_(num_instances=VLM_M, num_layers=VLM_LAYERS)
    small = registry.get_smoke_config("internvl2-26b").with_(num_instances=2)
    small_params = api.init(small, torch.Generator().manual_seed(0), "cpu")
    small_reqs = requests(8, 2, 1, 48, 8, small.vocab_size, 3)
    small_kw = dict(slots_per_instance=2, max_context=64, prefill_chunk=8, decode_steps=4)
    serve_kw = dict(slots_per_instance=B, max_context=S, prefill_chunk=C, prefill_lanes=4,
                    decode_steps=8)
    cpu = MultiModelServer(small, small_params, device="cpu", **small_kw)
    for q in small_reqs:
        cpu.submit(q)
    want_small = drained(cpu, len(small_reqs), 8)
    split = shardings.layers_split(cfg, t)
    assert split and not shardings.vocab_split(cfg, t)
    log("vlm_mesh", mesh=f"1x{t}", arch=cfg.name, instances=VLM_M, layers=cfg.num_layers,
        layers_split=split, vocab_split=False, rule=repr(mesh.describe(t, "cuda")))
    reqs = requests(TP_REQUESTS, VLM_M, 16, 512, 32, cfg.vocab_size, 0)
    t0 = time.perf_counter()
    ranks = mesh.spawn(mesh.in_turn, t,
                       (serve.serve_rank, cfg, 0, reqs, serve_kw),
                       (serve.serve_rank, small, small_params, small_reqs, small_kw),
                       (tp_parity.all_reduce_rank, (VLM_M, B, cfg.d_model), 50), device="cuda")
    log("vlm_mesh", mesh=f"1x{t}", spawn_and_run_s=round(time.perf_counter() - t0, 1))
    full = [r[0] for r in ranks]
    sums = 2 * cfg.num_layers
    shard, leaf = vlm_shard_bytes(cfg, t)
    caches = cache_bytes(cfg, VLM_M, B, 4, S, cfg.num_kv_heads // t)
    limit = shard + caches + 2 * leaf + 2 ** 28     # 256 MiB for small tensors
    for rank, (o, r) in enumerate(zip(full, ranks)):
        steps, chunks = check_dense_rank(cfg, o, TP_REQUESTS, 32, split)
        snap, la = o["snapshot"], o["launches"]
        assert snap["mesh"] == {"shape": {"data": 1, "model": t}, "devices": t}, snap
        share = sums * r[2] / snap["decode_ms_per_step"]
        log("vlm_mesh", mesh=f"1x{t}", rank=rank, device=o["device"], backend=o["backend"],
            requests=TP_REQUESTS, tokens=snap["generated_tokens"],
            wall_s=round(o["wall_s"], 3),
            tok_per_s=round(snap["generated_tokens"] / o["wall_s"], 1),
            ms_per_decode_step=round(snap["decode_ms_per_step"], 3), decode_steps=steps,
            decode_blocks=snap["decode_device_calls"],
            prefill_ms=round(1e3 * snap["prefill_wall_s"], 1), prefill_chunk_calls=chunks,
            attn_phase_per_step=round(la["decode_layer_attn"] / steps, 2),
            ffn_phase_per_step=round(la["decode_layer_ffn"] / steps, 2),
            chunk_attention_per_chunk_call=round(la["chunk_prefill_attention"] / chunks, 2),
            logits_per_step=round(la["logits_sample"] / steps, 2),
            sums_per_decode_step=sums, ms_per_sum=round(r[2], 4),
            sum_share_of_decode_step=f"{share:.1%}",
            shard_gib_from_shapes=round(shard / 2 ** 30, 2),
            caches_gib=round(caches / 2 ** 30, 2),
            one_instance_leaf_f32_gib=round(leaf / 2 ** 30, 3),
            setup_peak_gib_on_card=round(o["setup_peak_gib"], 2),
            serve_peak_gib_on_card=round(o["peak_gib"], 2), limit_gib=round(limit / 2 ** 30, 2),
            launches=json.dumps(la).replace(" ", ""))
        assert o["setup_peak_gib"] * 2 ** 30 <= limit, (
            f"rank {rank} drew more than its shard: {o['setup_peak_gib']} GiB")
    assert all(o["streams"] == full[0]["streams"] for o in full), f"1x{t}: ranks differ"
    log("vlm_mesh", mesh=f"1x{t}", streams="ranks identical", requests=len(full[0]["streams"]))
    smoke = [r[1] for r in ranks]
    t0 = time.perf_counter()
    smoke += mesh.spawn(serve.serve_rank, 4, small, small_params, small_reqs, small_kw,
                        device="cuda")
    log("vlm_mesh", mesh="1x4", config=small.name,
        layers_split=shardings.layers_split(small, 4),
        spawn_and_run_s=round(time.perf_counter() - t0, 1))
    for o in smoke:
        assert o["streams"] == want_small, f"smoke {len(smoke)}: streams differ from the CPU"
    log("vlm_mesh", meshes="1x2,1x4", reference="cpu-plain single device", config=small.name,
        requests=len(want_small), tokens=sum(len(v) for v in want_small.values()),
        streams="equal")
    return full[0]["launches"]


def phase_check(torch, dev):
    import numpy as np

    from repro_torch import api
    from repro_torch.configs import registry
    from repro_torch.models import moe
    from repro_torch.models.common import _leaves, tree_map

    # greedy K=1 vs K=8 on the card at full widths, depth cut: tinyllama to
    # 4 layers, xlstm to 8 (7 mLSTM layers and the sLSTM layer at 3),
    # hymba to 4 (global layers 0, 2, 3 and the SWA layer 1), olmoe and
    # qwen3-moe (GQA 32/4, 128 experts) to 4, internvl2 (its 256 patch
    # positions before each prompt) to 4; whisper-small at its full depth
    # (12 encoder and 12 decoder layers)
    for arch, layers, ctx in (("tinyllama-1.1b", 4, S), ("xlstm-1.3b", 8, S),
                              ("hymba-1.5b", 4, YS), ("olmoe-1b-7b", 4, S),
                              ("qwen3-moe-30b-a3b", 4, S), ("internvl2-26b", 4, S),
                              ("whisper-small", 12, S)):
        cfg = registry.get_config(arch).with_(num_instances=M, num_layers=layers)
        streams = []
        for k in (1, 8):
            srv = make_server(torch, dev, cfg, 1, slots_per_instance=2, max_context=ctx,
                              prefill_chunk=C, decode_steps=k)
            for r in requests(12, M, 16, 200, 16, cfg.vocab_size, 1):
                srv.submit(r)
            streams.append(drained(srv, 12, 16))
            del srv
            gc.collect()
        assert streams[0] == streams[1], f"{arch}: greedy streams differ between K=1 and K=8"
        log("check", arch=arch, streams="K1==K8", requests=len(streams[0]), layers=layers,
            tokens=sum(len(t) for t in streams[0].values()))

    # kernel path (card) against the plain path (CPU), small f32 configs:
    # prefill chunks (three of 8; hymba: eleven of 16 over the 128 meta
    # positions and 48 prompt tokens, wrapping its 32-slot SWA ring at
    # context 256), a decode step and a greedy decode step; whisper-smoke
    # with random frames (its 16-frame encoder, the cross K/V in the cache)
    for arch, layers, n_pos, width, ctx in (("tinyllama-1.1b", None, 24, 8, 64),
                                            ("xlstm-1.3b", None, 24, 8, 64),
                                            ("hymba-1.5b", 4, 176, 16, 256),
                                            ("olmoe-1b-7b", None, 24, 8, 64),
                                            ("internvl2-26b", None, 24, 8, 64),
                                            ("whisper-small", None, 24, 8, 64)):
        small = registry.get_smoke_config(arch).with_(num_instances=2)
        if layers:
            small = small.with_(num_layers=layers)
        params = api.init(small, torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(2)
        tok = torch.from_numpy(rng.integers(1, small.vocab_size, (2, 2, n_pos)).astype(np.int32))
        # vlm: random patch embeddings over its 8 prefix positions
        img = torch.from_numpy(rng.standard_normal(
            (2, 2, small.num_image_patches, small.vision_embed_dim)).astype(np.float32))
        frames = torch.from_numpy(rng.standard_normal(
            (2, 2, small.num_audio_frames, small.d_model)).astype(np.float32))
        outs = {}
        for d in ("cpu", dev):
            p = params.to(d) if d != "cpu" else params
            carry = api.init_chunk_carry(small, 2, 2, ctx, device=d)
            for start in range(0, n_pos, width):
                off = torch.full((2, 2), start, dtype=torch.int32, device=d)
                batch = {"tokens": tok[:, :, start:start + width].to(d)}
                if small.family == "moe":
                    batch["moe_limit"] = torch.full((2, 2), moe.capacity(small, n_pos),
                                                    dtype=torch.int32, device=d)
                if small.family == "vlm":
                    batch["image_embeds"] = img.to(d)
                if small.family == "audio":
                    batch["frames"] = frames.to(d)
                api.prefill_chunk(small, p, batch, carry, off)
            cache = carry["cache"]
            pos = torch.full((2, 2), n_pos, dtype=torch.int32, device=d)
            nxt, _ = api.decode_step_sample(small, p, tree_map(lambda t: t.clone(), cache),
                                            tok[:, :, -1:].to(d), pos)
            logits, _ = api.decode_step(small, p, cache, tok[:, :, -1:].to(d), pos)
            outs[str(d)] = ([t.cpu() for t in _leaves(cache)], logits.cpu(), nxt.cpu())
        (c0, lg0, n0), (c1, lg1, n1) = outs["cpu"], outs[str(dev)]
        e_cache = max(rel_err(a, b) for a, b in zip(c1, c0))
        e_logits = rel_err(lg1, lg0)
        assert torch.isfinite(lg1).all() and lg1.shape == (2, 2, small.vocab_size)
        assert e_cache <= TOL["float32"] and e_logits <= TOL["float32"], (arch, e_cache,
                                                                          e_logits)
        assert torch.equal(n1, n0) and torch.equal(n1, lg0.argmax(-1).to(torch.int32)), (
            f"{arch}: greedy tokens differ")
        log("check", reference="cpu-plain", config=small.name, layers=small.num_layers,
            prefilled_positions=n_pos, state_leaves=len(c0),
            cache_rel_err=f"{e_cache:.2e}", logits_rel_err=f"{e_logits:.2e}", tokens="equal")


def graph_cases():
    """The graphs of the graph phase (the tests' FFNN and residual CNN at
    bert-base's FFN and a resnet50 stage's widths): (name, graph builder,
    weights of one instance from a numpy generator, its input)."""
    import numpy as np

    f32 = np.float32
    r = lambda rng, *shp, sc=0.1: (rng.standard_normal(shp) * sc).astype(f32)

    def ffnn(g):
        g.add("x", "input")
        g.add("fc1", "matmul", ["x"])
        g.add("ln", "layernorm", ["fc1"])
        g.add("act", "gelu", ["ln"])
        g.add("fc2", "matmul", ["act"])
        g.outputs = ["fc2"]
        return g

    def ffnn_w(rng, d=768, hid=3072):
        return {"fc1": {"w": r(rng, d, hid, sc=d ** -0.5), "b": r(rng, hid)},
                "ln": {"scale": 1 + r(rng, hid), "bias": r(rng, hid)},
                "fc2": {"w": r(rng, hid, d, sc=hid ** -0.5), "b": r(rng, d)}}

    def cnn(g):
        g.add("img", "input")
        g.add("conv1", "conv2d", ["img"], stride=1, padding="SAME")
        g.add("bn1", "batchnorm", ["conv1"])
        g.add("relu1", "relu", ["bn1"])
        g.add("conv2", "conv2d", ["relu1"], stride=1, padding="SAME")
        g.add("res", "add", ["conv2", "relu1"])
        g.add("pool", "maxpool2d", ["res"], kernel=2)
        g.add("gap", "global_avgpool", ["pool"])
        g.add("fc", "matmul", ["gap"])
        g.outputs = ["fc"]
        return g

    def cnn_w(rng, c=256, n_class=1000):
        sc = (9 * c) ** -0.5
        return {"conv1": {"w": r(rng, 3, 3, c, c, sc=sc), "b": r(rng, c)},
                "bn1": {"mean": r(rng, c), "var": np.abs(r(rng, c)) + 0.5,
                        "scale": 1 + r(rng, c), "bias": r(rng, c)},
                "conv2": {"w": r(rng, 3, 3, c, c, sc=sc)},
                "fc": {"w": r(rng, c, n_class, sc=c ** -0.5)}}

    return (("ffnn/bert-base-ffn", ffnn, ffnn_w, lambda rng: {"x": r(rng, 128, 768, sc=1.0)}),
            ("cnn/resnet50-stage", cnn, cnn_w,
             lambda rng: {"img": r(rng, 1, 56, 56, 256, sc=1.0)}))


def phase_graph(torch, dev):
    """``repro_torch.core.graph`` on the card: each graph of
    ``graph_cases`` merged (``merge_graph``) at M in {1, 8, 32} and run
    once (``execute_merged``) against its M per-instance runs
    (``execute``), f32 with TF32 off, held to PAPER_EXACT_TOL relative to
    the largest output magnitude; the merged round and the M
    per-instance runs timed (CUDA events, the mean of 5 after a warm-up)."""
    import numpy as np

    from repro_torch.core import graph as G

    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    for name, build, make_w, make_x in graph_cases():
        g = build(G.Graph())
        for m in (1, 8, 32):
            rng = np.random.default_rng(71 + m)
            weights = [make_w(rng) for _ in range(m)]
            inputs = [make_x(rng) for _ in range(m)]
            t0 = time.perf_counter()
            merged, mw, dims = G.merge_graph(g, weights, device=dev)
            torch.cuda.synchronize()
            merge_s = time.perf_counter() - t0
            # the per-instance weights and inputs on the card once, as tensors
            w_dev = [{op: {k: torch.from_numpy(v).to(dev) for k, v in w.items()}
                      for op, w in wi.items()} for wi in weights]
            x_dev = [{k: torch.from_numpy(v).to(dev) for k, v in xi.items()} for xi in inputs]
            fused = G.execute_merged(merged, mw, dims, x_dev, device=dev)
            per = [G.execute(g, x_dev[i], w_dev[i], device=dev) for i in range(m)]
            err = max(part_err(fused[i][o], per[i][o]) for i in range(m) for o in g.outputs)
            shapes = {tuple(fused[i][o].shape) for i in range(m) for o in g.outputs}
            assert all(torch.isfinite(fused[i][o]).all() for i in range(m) for o in g.outputs)
            assert err <= PAPER_EXACT_TOL, f"graph {name} M={m}: merged vs per-instance {err}"
            merged_ms = time_ms(torch, lambda: G.execute_merged(merged, mw, dims, x_dev,
                                                                device=dev), reps=5, warmup=1)
            per_ms = time_ms(torch, lambda: [G.execute(g, x_dev[i], w_dev[i], device=dev)
                                             for i in range(m)], reps=5, warmup=1)
            log("graph", graph=name, instances=m, output_shape=sorted(shapes),
                merged_ops=len(merged.ops), reshapes=sum(op.op_type == "merge_reshape"
                                                        for op in merged.ops.values()),
                rel_err=f"{err:.3e}", tol=PAPER_EXACT_TOL, merge_s=round(merge_s, 3),
                merged_ms=f"{merged_ms:.4f}", per_instance_ms=f"{per_ms:.4f}",
                speedup=f"{per_ms / merged_ms:.2f}x")
            del weights, w_dev, x_dev, fused, per, merged, mw


def train_cell(torch, dev, cfg, b, s, steps=TRAIN_STEPS, lr=TRAIN_LR):
    """``steps`` AdamW steps of ``train/loop.make_train_step`` (cosine
    schedule, warm-up 1, remat per layer) on one fixed batch of
    ``pipeline.make_batch`` ((M, b, s) positions; vlm's patch embeddings,
    audio's frames), the parameters f32 masters drawn from a seed on the
    card.  Every launch counter is set to 0 just before the steps and read
    just after.  Gates: every loss finite, the last below the first, every
    grad norm finite and above 0, and no parameter left without a gradient
    (``loop`` raises).  Returns (launches, the log)."""
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.optim import cosine_with_warmup
    from repro_torch.train import loop

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = loop.init_state(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in state.params.parameters())
    batch = pipeline.make_batch(cfg, 0, b, s, device=dev)
    step_fn = loop.make_train_step(cfg, lr_schedule=cosine_with_warmup(lr, 1, steps))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, norms, aux, ms = [], [], [], []
    ops.reset_launches()
    for _ in range(steps):
        t = time.perf_counter()
        state, met = step_fn(state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        aux.append(float(met["aux"]))
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = all(bool(torch.isfinite(p).all()) for p in state.params.parameters())
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    out = dict(arch=cfg.name, instances=cfg.num_instances, layers=cfg.num_layers, batch=b,
               seq=s, params=n_params, losses=[round(x, 4) for x in losses],
               grad_norms=[round(x, 3) for x in norms],
               **({"aux": [round(x, 5) for x in aux]} if cfg.family == "moe" else {}),
               first_step_ms=round(ms[0], 1),
               step_ms=round(steady, 1),
               tok_per_s=round(cfg.num_instances * b * s / steady * 1e3, 1),
               peak_gib=round(peak, 2), setup_s=round(setup_s, 1),
               params_finite=finite,
               launches=json.dumps({k: v for k, v in launches.items() if v}).replace(" ", ""))
    log("train", **out)
    assert all(math.isfinite(x) for x in losses) and finite, losses
    assert losses[-1] < losses[0], f"{cfg.name}: loss did not fall: {losses}"
    assert all(math.isfinite(x) and x > 0 for x in norms), norms
    del state, batch, met
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def train_matmul_check(torch, dev):
    """``fused_matmul.Merged`` on the card at TRAIN_MATMUL: x bf16, w the
    f32 master.  The output, dx (bf16) and dw (f32, the master's gradient)
    against autograd through the plain version on the same inputs, within
    bf16's TOL; the Function's forward + backward and the plain version's
    timed (CUDA events).  Its launches are not on the main path's count."""
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.kernels import ops

    m, t, d, f = TRAIN_MATMUL
    g = torch.Generator(device=dev).manual_seed(26)
    x = torch.randn(m, t, d, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(m, d, f, generator=g, device=dev) * d ** -0.5
    dy = torch.randn(m, t, f, generator=g, device=dev).to(torch.bfloat16)

    def run(fwd):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fwd(xs, ws)
        y.backward(dy)
        return y.detach(), xs.grad, ws.grad

    kernel = lambda a, b: fm.fused_matmul_grad(ops._fused_matmul.cuda, a, b)
    got, want = run(kernel), run(fm.fused_matmul_plain)
    errs = {n: rel_err(a, b) for n, a, b in zip(("y", "dx", "dw"), got, want)}
    assert got[1].dtype == torch.bfloat16 and got[2].dtype == torch.float32
    assert all(e <= TOL["bfloat16"] for e in errs.values()), errs
    del got, want
    ms = time_ms(torch, lambda: run(kernel), reps=5, warmup=1)
    plain = time_ms(torch, lambda: run(fm.fused_matmul_plain), reps=5, warmup=1)
    log("train", check="merged-matmul-function", shape=f"({m},{t},{d})@({m},{d},{f})",
        x="bf16", w="f32 master", **{f"{n}_rel_err": f"{e:.2e}" for n, e in errs.items()},
        fwd_bwd_ms=f"{ms:.4f}", plain_fwd_bwd_ms=f"{plain:.4f}")


def _grads_of(torch, cfg, params, batch):
    """(loss, {name: grad}) of ``api.loss_fn`` on a trainable model."""
    from repro_torch import api

    params.zero_grad(set_to_none=True)
    loss, _ = api.loss_fn(cfg, params, batch)
    loss.backward()
    return loss.item(), {n: p.grad.detach().cpu() for n, p in params.named_parameters()}


def phase_train(torch, dev):
    """Training on the card (``train/loop.py``, ``launch/train.py``):

    (a) tinyllama-1.1b at full depth and width, M=2, B=2, S=512, bf16
        compute with f32 master weights, remat, AdamW, TRAIN_STEPS steps;
    (b) xlstm-1.3b likewise at M=2, B=1, S=256: the mLSTM kernel 42 times
        and the sLSTM kernel 6 times a forward, each again in remat's
        recompute;
    (g) olmoe-1b-7b at 4 of its 16 layers (M=2, B=1, S=512): the merged
        matmul under ``fused_matmul.Merged`` MOE_TRAIN_LAUNCHES times a
        layer and step; internvl2-26b at 1 of its 48 layers (M=2, B=1,
        256 patches + 256 tokens) and whisper-small at full depth (M=2,
        B=2, S=256), launching no kernel; then ``train_matmul_check``;
    (c) one step's loss and every gradient on the card (the kernels under
        their autograd Functions) against the CPU (plain versions) on the
        f32 smoke configs of the six families, TF32 off;
    (d) instance isolation (``examples/train_merged.py``, AdamW's clip
        off): tinyllama-smoke f32 (V=64), M=3 trained fused for 10 steps
        at a constant lr of 1e-3; instance 0 against the same run with the
        other instances on other streams, and against instance 0 trained
        alone on its stream;
    (e) ``python -m repro_torch.launch.train`` at full tinyllama-1.1b
        width (M=2, 2 steps, B=2, S=256, ``--save``), the checkpoint read
        by ``checkpoint.store.restore_params`` and served (4 greedy
        requests, each ``ok``);
    (f) ``api.prefill`` against the chunked path's last logits (chunk
        calls over the prompt but its last token, then a decode step on
        it) at the full tinyllama-1.1b width in bf16; on the f32 smoke
        configs of the three families (hymba's at 4 layers, its 40-token
        prompt longer than the SWA ring) the last logits and 4 greedy
        decode steps continuing from each path's cache, tokens equal; on
        the moe, vlm and audio smokes the whole prefill's cache against
        the chunked path's over the whole prompt, then 4 greedy steps from
        each, tokens equal.
    Returns the launches of (a), (b) and (g) by path."""
    import pathlib
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import api
    from repro_torch.checkpoint import store
    from repro_torch.configs import registry
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import common as Cm
    from repro_torch.models import hybrid, moe, ssm
    from repro_torch.optim import adamw, constant
    from repro_torch.serving import MultiModelServer
    from repro_torch.train import loop

    by_path = {}
    # (a), (b), (g): full width, full depth but where TRAIN_CELLS cuts it
    for arch, m, b, s, layers in TRAIN_CELLS:
        cfg = registry.get_config(arch).with_(num_instances=m)
        if layers:
            cfg = cfg.with_(num_layers=layers)
        la, out = train_cell(torch, dev, cfg, b, s)
        with_grad = ()
        if cfg.family == "ssm":
            n_s = len(ssm.mlstm_runs(cfg)) - 1
            n_m = cfg.num_layers - n_s
            # a forward, and remat's recompute of it in the backward
            assert la["mlstm_chunkwise"] == 2 * n_m * TRAIN_STEPS, la
            assert la["slstm_cell"] == 2 * n_s * TRAIN_STEPS, la
            with_grad = ("mlstm_chunkwise", "slstm_cell")
        if cfg.family == "moe":
            # the experts' products under fused_matmul.Merged
            assert la["fused_matmul"] == MOE_TRAIN_LAUNCHES * cfg.num_layers * TRAIN_STEPS, la
            with_grad = ("fused_matmul",)
        others = {k: v for k, v in la.items() if v and k not in with_grad}
        assert not others, f"{arch}: kernels without a backward launched in training: {others}"
        by_path[f"{arch}/train"] = la
    train_matmul_check(torch, dev)

    # (c) the card against the CPU on f32 smoke configs
    for arch in ("tinyllama-1.1b", "xlstm-1.3b", "hymba-1.5b", "olmoe-1b-7b", "internvl2-26b",
                 "whisper-small"):
        small = registry.get_smoke_config(arch).with_(num_instances=2)
        cpu_p = api.init(small, torch.Generator().manual_seed(0), "cpu", train=True)
        dev_p = Cm.training_params(small, Cm.tree_map(lambda t: t.to(dev), cpu_p.tree()))
        batch = pipeline.make_batch(small, 0, 2, 32, seed=1)
        l_cpu, g_cpu = _grads_of(torch, small, cpu_p, batch)
        ops.reset_launches()
        l_dev, g_dev = _grads_of(torch, small, dev_p, {k: v.to(dev) for k, v in batch.items()})
        la = {k: v for k, v in ops.launches().items() if v}
        e_loss = abs(l_dev - l_cpu) / abs(l_cpu)
        e_grad = max(part_err(g_dev[n], g_cpu[n]) for n in g_cpu)
        assert math.isfinite(l_dev) and e_loss <= TRAIN_LOSS_TOL, (arch, l_dev, l_cpu)
        assert e_grad <= TRAIN_GRAD_TOL, (arch, e_grad)
        if small.family == "ssm":
            assert la.get("mlstm_chunkwise") and la.get("slstm_cell"), la
        if small.family == "moe":
            assert la.get("fused_matmul"), la
        log("train", check="card-vs-cpu", config=small.name, loss=f"{l_dev:.6f}",
            loss_rel_err=f"{e_loss:.2e}", grad_leaves=len(g_cpu),
            worst_grad_err=f"{e_grad:.2e}", launches=json.dumps(la).replace(" ", ""))

    # (d) instance isolation, the clip off: instance 0 of M=3 fused against
    # the same run with the others on other streams, and against it alone
    cfg1 = registry.get_smoke_config("tinyllama-1.1b").with_(vocab_size=64)
    cfg3 = cfg1.with_(num_instances=3)
    kw = dict(steps=10, batch_size=4, seq_len=32, lr_schedule=constant(1e-3), log_every=9,
              print_fn=lambda *_: None, max_grad_norm=math.inf)

    def singles():
        return [api.init(cfg1, torch.Generator(device=dev).manual_seed(i), dev, train=True)
                for i in range(3)]

    def fused(seeds):
        merged = Cm.training_params(cfg3, Cm.merge_instances([p.tree() for p in singles()]))
        streams = [pipeline.SyntheticLM(64, 1, seed=sd, device=dev) for sd in seeds]
        st, losses = loop.train_loop(
            cfg3, lambda step: {k: torch.cat([x.batch(step, 4, 32)[k] for x in streams])
                                for k in ("tokens", "labels")},
            state=loop.TrainState(merged, adamw.adamw_init(merged)), **kw)
        return Cm._leaves(Cm.instance_views(st.params, 0).tree()), losses

    def worst(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    inst0, f_losses = fused((50, 51, 52))
    e_others = worst(inst0, fused((50, 61, 62))[0])
    solo0 = Cm.training_params(cfg1, singles()[0].tree())
    solo, s_losses = loop.train_loop(cfg1, pipeline.SyntheticLM(64, 1, seed=50, device=dev),
                                     state=loop.TrainState(solo0, adamw.adamw_init(solo0)), **kw)
    e_solo = worst(inst0, Cm._leaves(solo.params.tree()))
    log("train", check="isolation", instances=3, steps=10, clip="off",
        fused_loss=f"{f_losses[0][1]:.3f}->{f_losses[-1][1]:.3f}",
        solo_loss=f"{s_losses[0][1]:.3f}->{s_losses[-1][1]:.3f}",
        max_diff_other_streams=f"{e_others:.2e}", max_diff_solo=f"{e_solo:.2e}")
    assert e_others < ISOLATION_OTHERS_TOL, e_others
    assert e_solo < ISOLATION_SOLO_TOL, e_solo
    del inst0, solo, solo0

    # (e) the CLI at full width, its checkpoint restored and served
    tmp = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "tinyllama-1.1b",
             "--num-instances", "2", "--steps", "2", "--batch", "2", "--seq", "256",
             "--save", tmp], cwd=HERE, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": os.path.join(HERE, "src")})
        assert r.returncode == 0, r.stderr[-3000:]
        cli_s = time.perf_counter() - t0
        cfg = registry.get_config("tinyllama-1.1b").with_(num_instances=2)
        t0 = time.perf_counter()
        params = store.restore_params(tmp, cfg, api.init(cfg, None, "meta"), dev)
        restore_s = time.perf_counter() - t0
        srv = MultiModelServer(cfg, params, device=dev, slots_per_instance=2, max_context=S,
                               prefill_chunk=C, decode_steps=8)
        for q in requests(4, 2, 16, 200, 16, cfg.vocab_size, 3):
            srv.submit(q)
        served = drained(srv, 4, 16)
        log("train", check="cli-save-serve", cli_s=round(cli_s, 1),
            cli_tail=r.stdout.strip().splitlines()[-2].replace(",", ";"),
            checkpoint_gib=round(sum(f.stat().st_size for f in pathlib.Path(tmp).iterdir())
                                 / 2 ** 30, 2), restore_s=round(restore_s, 1),
            requests_ok=len(served))
        del srv, params
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (f) whole-sequence prefill against the chunked path
    def chunked(cfg, params, tok, d, cache_len):
        """(last logits, cache) of chunk calls over the prompt but its last
        token, then a decode step on it."""
        m, b, n = tok.shape
        pre = api.prefill_prefix_len(cfg)
        carry = api.init_chunk_carry(cfg, m, b, cache_len, device=d)
        ctx = tok[:, :, :-1]
        if pre:
            # the learned prefix's positions come first; their ids are ignored
            ctx = torch.cat([torch.zeros(m, b, pre, dtype=tok.dtype, device=d), ctx], dim=2)
        for start in range(0, ctx.shape[2], C):
            off = torch.full((m, b), start, dtype=torch.int32, device=d)
            api.prefill_chunk(cfg, params, {"tokens": ctx[:, :, start:start + C]}, carry, off)
        pos = torch.full((m, b), ctx.shape[2], dtype=torch.int32, device=d)
        return api.decode_step(cfg, params, carry["cache"], tok[:, :, -1:], pos)

    def greedy(cfg, params, cache, t, pos0, steps=4):
        """``steps`` greedy decode steps from the token t (M, B) on
        ``cache``: tokens (steps, M, B) and each step's logits."""
        toks, outs = [], []
        for k in range(steps):
            toks.append(t)
            logits, cache = api.decode_step(cfg, params, cache, t[..., None],
                                            torch.full_like(t, pos0 + k))
            outs.append(logits)
            t = logits.argmax(-1).to(torch.int32)
        return torch.stack(toks), outs

    def chunked_cache(cfg, params, batch, d, cache_len):
        """The cache of chunk calls of C positions over the whole prompt
        (the learned prefix's positions first) with the family's stub
        inputs in every call; moe routes at the whole prompt's capacity."""
        tok = batch["tokens"]
        m, b, n = tok.shape
        pre = api.prefill_prefix_len(cfg)
        ctx = torch.cat([torch.zeros(m, b, pre, dtype=tok.dtype, device=d), tok], dim=2)
        carry = api.init_chunk_carry(cfg, m, b, cache_len, device=d)
        extra = {k: batch[k] for k in ("image_embeds", "frames") if k in batch}
        if cfg.family == "moe":
            extra["moe_limit"] = torch.full((m, b), moe.capacity(cfg, n), dtype=torch.int32,
                                            device=d)
        for start in range(0, ctx.shape[2], C):
            off = torch.full((m, b), start, dtype=torch.int32, device=d)
            api.prefill_chunk(cfg, params, {"tokens": ctx[:, :, start:start + C], **extra},
                              carry, off)
        return carry["cache"]

    rng = np.random.default_rng(4)
    cfg = registry.get_config("tinyllama-1.1b").with_(num_instances=2)
    params = serve.random_merged(cfg, 0, dev)[0]
    tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 2, 256)).astype(np.int32)).to(dev)
    with torch.no_grad():
        whole = api.prefill(cfg, params, {"tokens": tok})[0]
        chunk_last = chunked(cfg, params, tok, dev, 256 + 8)[0]
    e_bf16 = rel_err(whole, chunk_last)
    assert torch.isfinite(whole).all() and e_bf16 <= TOL["bfloat16"], e_bf16
    del params
    smokes = {}
    for arch, layers in (("tinyllama-1.1b", None), ("xlstm-1.3b", None), ("hymba-1.5b", 4)):
        small = registry.get_smoke_config(arch).with_(num_instances=2)
        if layers:
            small = small.with_(num_layers=layers)
        n, pre = 40, api.prefill_prefix_len(small)
        # equal caches: the dense cache with room for the decode steps; the
        # hybrid global groups sized to the prompt, as the whole prefill does
        cache_len = pre + n + (8 if small.family == "dense" else 0)
        assert small.family != "hybrid" or n > hybrid.swa_window(small)
        p = api.init(small, torch.Generator().manual_seed(0), "cpu").to(dev)
        t = torch.from_numpy(rng.integers(1, small.vocab_size, (2, 2, n)).astype(np.int32))
        ops.reset_launches()
        with torch.no_grad():
            w, w_cache = api.prefill(small, p, {"tokens": t.to(dev)}, cache_len=cache_len)
            la = {k: v for k, v in ops.launches().items() if v}
            c_, c_cache = chunked(small, p, t.to(dev), dev, cache_len)
            w_tok, w_out = greedy(small, p, w_cache, w.argmax(-1).to(torch.int32), pre + n)
            c_tok, c_out = greedy(small, p, c_cache, c_.argmax(-1).to(torch.int32), pre + n)
        e_last = rel_err(w, c_)
        e_dec = max(rel_err(a, b) for a, b in zip(w_out, c_out))
        assert e_last <= TOL["float32"] and e_dec <= TOL["float32"], (arch, e_last, e_dec)
        assert torch.equal(w_tok, c_tok), f"{arch}: greedy tokens after the prefill differ"
        smokes[small.name] = dict(layers=small.num_layers, last_rel_err=f"{e_last:.2e}",
                                  decode_rel_err=f"{e_dec:.2e}", prefill_launches=la)
    # moe, vlm and audio: the whole prefill's cache against the chunked
    # path's over the whole prompt (moe routing at the whole prompt's
    # capacity, vlm's patch positions first, audio's frames in every call),
    # then 4 greedy steps from each cache from the whole prefill's token
    for arch in ("olmoe-1b-7b", "internvl2-26b", "whisper-small"):
        small = registry.get_smoke_config(arch).with_(num_instances=2)
        n, pre = 40, api.prefill_prefix_len(small)
        cache_len = pre + n + 8
        p = api.init(small, torch.Generator().manual_seed(0), "cpu").to(dev)
        batch = {k: v.to(dev) for k, v in
                 pipeline.make_batch(small, 0, 2, pre + n, seed=4).items() if k != "labels"}
        ops.reset_launches()
        with torch.no_grad():
            w, w_cache = api.prefill(small, p, batch, cache_len=cache_len)
            la = {k: v for k, v in ops.launches().items() if v}
            c_cache = chunked_cache(small, p, batch, dev, cache_len)
            e_cache = max(rel_err(a, b) for a, b in zip(Cm._leaves(w_cache),
                                                        Cm._leaves(c_cache)))
            t0_ = w.argmax(-1).to(torch.int32)
            w_tok, w_out = greedy(small, p, w_cache, t0_, pre + n)
            c_tok, c_out = greedy(small, p, c_cache, t0_, pre + n)
        e_dec = max(rel_err(a, b) for a, b in zip(w_out, c_out))
        assert torch.isfinite(w).all() and e_cache <= TOL["float32"], (arch, e_cache)
        assert e_dec <= TOL["float32"], (arch, e_dec)
        assert torch.equal(w_tok, c_tok), f"{arch}: greedy tokens after the prefill differ"
        if small.family == "moe":
            assert la.get("fused_matmul"), la
        smokes[small.name] = dict(layers=small.num_layers, cache_rel_err=f"{e_cache:.2e}",
                                  decode_rel_err=f"{e_dec:.2e}", prefill_launches=la)
    log("train", check="whole-prefill", config=cfg.name, prompt=256,
        bf16_rel_err=f"{e_bf16:.2e}", smoke_prompt=40, smoke_greedy_tokens="4 equal",
        smoke=json.dumps(smokes).replace(" ", ""))
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


def time_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_queued_ms(torch, fn, reps=20):
    """Device time per call of a kernel too short to outrun its host-side
    launch: the calls are queued behind a spin kernel (~10 ms), so the
    device runs them back to back however slowly the host enqueues them."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_times(torch, dev, by_path, profile_launches, b32):
    import torch.nn.functional as Fn

    from repro_torch.kernels import chunk_prefill_attn as cpa
    from repro_torch.kernels import decode_layer as dl

    rows = []
    g = torch.Generator(device=dev).manual_seed(11)
    # launches on the main paths: each kernel's count summed over the paths
    # (set to 0 before each path and read after it), and split per path
    launches = {k: sum(p[k] for p in by_path.values()) for k in by_path["xlstm-1.3b"]}
    per_path = lambda k: {a: p[k] for a, p in by_path.items() if p[k]}

    # decode layer at the serve shapes: bf16, positions inside the prompts' range
    lp, x, ck, cv = layer_inputs(torch, dev, torch.bfloat16, 5)
    pos = torch.randint(16, 545, (M, B), generator=g, device=dev).to(torch.int32)
    kw = dict(num_heads=H, head_dim=HD, rope_theta=10000.0)
    got = dl.decode_layer_cuda(lp, x, ck.clone(), cv.clone(), pos, **kw)
    want = dl.decode_layer_plain(lp, x, ck.clone(), cv.clone(), pos, **kw)
    err = abs_err(got[0], want[0])
    ms = time_ms(torch, lambda: dl.decode_layer_cuda(lp, x, ck, cv, pos, **kw))
    device_ms = time_queued_ms(torch, lambda: dl.decode_layer_cuda(lp, x, ck, cv, pos, **kw))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            dl.decode_layer_cuda(lp, x, ck, cv, pos, **kw)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if device_us(e) > 0]
    for e in sorted(kern, key=device_us, reverse=True)[:8]:
        log("profile", run="decode_layer", kernel=e.key[:60], calls=e.count,
            device_us_per_call=round(device_us(e) / e.count, 1))
    log("times", name="decode_layer", shape=f"M={M}, B={B}, bf16, whole layer",
        kernels_per_call=sum(e.count for e in kern) / 20 if kern else "not measured",
        device_ms=f"{device_ms:.4f}", ms=f"{ms:.4f}",
        splits={k: p.split for k, p in dl.layer_plans(M, B, D, H, KVH, HD, F).items()})
    plain = time_ms(torch, lambda: dl.decode_layer_plain(lp, x, ck, cv, pos, **kw))
    n_w = D * (H + 2 * KVH) * HD + H * HD * D + 3 * D * F
    valid = (pos + 1).clamp(max=S).sum().item()
    nbytes = (M * n_w * 2 + 2 * M * D * 4 + 2 * M * B * D * 2
              + valid * KVH * HD * 2 * 2 + M * B * KVH * HD * 2 * 2 + M * B * 4)
    flops = 2 * M * B * n_w + 4 * H * HD * valid
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    rows.append(dict(name="decode_layer", route="cuda",
                     source="src/repro_torch/csrc/decode_layer.cu",
                     replaces="src/repro/kernels/decode_layer.py:144",
                     launches=launches["decode_layer"],
                     launches_by_path=per_path("decode_layer"), max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                     device_ms=device_ms, **b32))
    del lp, x, ck, cv

    # greedy logits at the serve shapes: bf16 residual, f32 head (param_dtype)
    x, scale, head = logits_inputs(torch, dev, torch.bfloat16, 6, dup=False)
    tok, val = dl.logits_argmax_cuda(x, scale, head)
    ptok, pval = dl.logits_argmax_plain(x, scale, head)
    assert torch.equal(tok, ptok)
    err = abs_err(val, pval)
    ms = time_ms(torch, lambda: dl.logits_argmax_cuda(x, scale, head))
    plain = time_ms(torch, lambda: dl.logits_argmax_plain(x, scale, head))
    nbytes = M * D * V * 4 + M * B * D * 2 + M * D * 4 + M * B * 8
    bms, by = bound_ms(nbytes, 2 * M * B * D * V, "float32")
    rows.append(dict(name="logits_sample", route="cuda",
                     source="src/repro_torch/csrc/decode_layer.cu",
                     replaces="src/repro/kernels/decode_layer.py:414",
                     launches=launches["logits_sample"],
                     launches_by_path=per_path("logits_sample"), max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None))
    del head

    # chunk attention at the serve shapes: 4 prefill lanes (M=4, B=1), bf16;
    # 16 input copies rotate so K/V come from HBM, not L2, as in prefill
    offs = [0, 96, 256, 480]
    sets = [chunk_inputs(torch, dev, torch.bfloat16, 20 + i, 4, 1, offs) for i in range(16)]
    q, k, v, off = sets[0]
    got = cpa.chunk_prefill_attention_cuda(q, k, v, off, s_cache=S)
    want = cpa.chunk_prefill_attention_plain(q, k, v, off, s_cache=S)
    err = abs_err(got, want)
    it = iter(range(10 ** 9))
    ms = time_ms(torch, lambda: cpa.chunk_prefill_attention_cuda(
        *sets[next(it) % 16], s_cache=S))
    plain = time_ms(torch, lambda: cpa.chunk_prefill_attention_plain(
        *sets[next(it) % 16], s_cache=S), reps=5)
    # the same function as one library call: SDPA with the boolean mask
    from repro_torch.models.layers import cache_positions_after
    positions = off[..., None] + torch.arange(C, device=dev, dtype=torch.int32)
    kv_pos = torch.cat([cache_positions_after(off - 1, S), positions], -1)  # (4,1,T)
    mask = (kv_pos[:, :, None, :] >= 0) & (kv_pos[:, :, None, :] <= positions[..., None])
    lib_in = [(s_[0][:, 0].transpose(1, 2), s_[1][:, 0].transpose(1, 2),
               s_[2][:, 0].transpose(1, 2)) for s_ in sets]
    lib = lambda i: Fn.scaled_dot_product_attention(
        *lib_in[i % 16], attn_mask=mask, enable_gqa=True)
    lib_out = lib(0).transpose(1, 2)[:, None]
    assert abs_err(lib_out, want) < 0.05
    library = time_ms(torch, lambda: lib(next(it)))
    # device time of kernel and SDPA alike: calls queued behind a spin
    device_ms = time_queued_ms(torch, lambda: cpa.chunk_prefill_attention_cuda(
        *sets[next(it) % 16], s_cache=S))
    library_device = time_queued_ms(torch, lambda: lib(next(it)))
    vis_keys = mask.any(dim=2).sum().item()              # keys any query sees
    pairs = mask.sum().item()                            # visible (query, key) pairs
    nbytes = 2 * 4 * C * H * HD * 2 + vis_keys * KVH * HD * 2 * 2 + 4 * 4
    bms, by = bound_ms(nbytes, 4 * H * HD * pairs, "bfloat16")
    log("times", name="chunk_prefill_attention", shape="4 lanes, C=32, S=1024, 32/4 heads, hd 64",
        ms=f"{ms:.4f}", device_ms=f"{device_ms:.4f}", library_ms=f"{library:.4f}",
        library_device_ms=f"{library_device:.4f}", bound_ms=f"{bms:.4f}",
        splits=cpa.launch_plan(4, C, H, KVH, HD, S).splits)
    rows.append(dict(name="chunk_prefill_attention", route="cuda",
                     source="src/repro_torch/csrc/chunk_prefill_attn.cu",
                     replaces="src/repro/kernels/chunk_prefill_attn.py:35",
                     launches=launches["chunk_prefill_attention"],
                     launches_by_path=per_path("chunk_prefill_attention"), max_abs_err=err,
                     ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=library, device_ms=device_ms,
                     library_device_ms=library_device, library="SDPA, the same mask"))

    # sLSTM cell: prefill (S=32 over 4 lanes) in the row; decode (S=1 over
    # M=4 x B=4 slots) beside it.  bf16 activations, r in param_dtype (f32).
    from repro_torch.kernels import slstm_cell as sc

    def slstm_time(m, b, s):
        # two copies of (pre, r) rotate, so every call loads r from HBM as
        # a serve does (a decode step streams 48 layers between two calls)
        sets = [slstm_inputs(torch, dev, torch.bfloat16, torch.float32, m, b, s, 12 + i)
                for i in range(2)]
        pre, r, state = sets[0]
        got = tuple(t.clone() for t in state)
        want = tuple(t.clone() for t in state)
        ghs, _ = sc.slstm_cell_cuda(pre, r, got, num_heads=XH)
        whs, _ = sc.slstm_cell_plain(pre, r, want, num_heads=XH)
        err = max(abs_err(a, w) for a, w in zip((ghs,) + got, (whs,) + want))
        it = iter(range(10 ** 9))
        call = lambda: (lambda s_: sc.slstm_cell_cuda(s_[0], s_[1], s_[2], num_heads=XH))(
            sets[next(it) % 2])
        ms = time_ms(torch, call)
        dev_ms = time_queued_ms(torch, call)
        plain = time_ms(torch, lambda: sc.slstm_cell_plain(pre, r, want, num_heads=XH), reps=5)
        d = XH * XHD
        # each input read once, each output written once: pre, r, the state
        # (c, n, m f32 and h bf16) in and out, hs; the recurrent matvec in f32
        nbytes = (pre.numel() * 2 + r.numel() * 4 + 2 * m * b * d * (3 * 4 + 2)
                  + m * b * s * d * 2)
        flops = 2 * m * b * s * 4 * d * XHD
        plan = sc.launch_plan(m, b, s, XH, XHD, "float32")
        log("times", name="slstm_cell", shape=f"S={s}, {m} x {b} lanes, f32 r, bf16 pre",
            ms=f"{ms:.4f}", device_ms=f"{dev_ms:.4f}", regs_rows=plan.reg_rows,
            smem_rows=plan.smem_rows, stream_rows=plan.stream_rows,
            stream_mib_per_step=round(plan.stream_bytes_per_step / 2 ** 20, 2))
        del sets
        return err, ms, dev_ms, plain, bound_ms(nbytes, flops, "float32")

    err, ms, dev_ms, plain, (bms, by) = slstm_time(4, 1, C)
    d_err, d_ms, d_dev_ms, d_plain, (d_bms, d_by) = slstm_time(M, B, 1)
    # the train phase's shape: xlstm-1.3b at M=2, B=1, S=256
    t_err, t_ms, t_dev_ms, t_plain, (t_bms, t_by) = slstm_time(2, 1, 256)
    rows.append(dict(name="slstm_cell", route="cuda",
                     source="src/repro_torch/csrc/slstm_cell.cu",
                     replaces="src/repro/kernels/slstm_cell.py:37",
                     launches=launches["slstm_cell"],
                     launches_by_path=per_path("slstm_cell"), max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                     shape="prefill S=32, 4 lanes", device_ms=dev_ms, decode_ms=d_ms,
                     decode_device_ms=d_dev_ms, decode_plain_ms=d_plain,
                     decode_bound_ms=d_bms, decode_bound_by=d_by, decode_max_abs_err=d_err,
                     train_ms=t_ms, train_device_ms=t_dev_ms, train_plain_ms=t_plain,
                     train_bound_ms=t_bms, train_bound_by=t_by, train_max_abs_err=t_err))
    log("times", name="slstm_cell", shape="decode S=1, M=4 x B=4", ms=f"{d_ms:.4f}",
        device_ms=f"{d_dev_ms:.4f}", plain_ms=f"{d_plain:.4f}", bound_ms=f"{d_bms:.4f}",
        bound_by=d_by, of_bound=f"{d_bms / d_dev_ms:.1%}")
    # decode attention at the hymba serve shapes: M=4 x B=4 slots, bf16,
    # kv_len inside the served positions (128 meta + 16..512 prompt + 32
    # new); 8 input copies rotate so K/V come from HBM, as in a decode step
    # where 32 layers of weights stream through L2 between two global layers
    from repro_torch.kernels import decode_attn as da
    sets = [decode_attn_inputs(torch, dev, torch.bfloat16, 30 + i, lens=(144, 673))
            for i in range(8)]
    q, k, v, kv_len = sets[0]
    got = da.decode_attention_cuda(q, k, v, kv_len)
    want = da.decode_attention_plain(q, k, v, kv_len)
    err = abs_err(got, want)
    it = iter(range(10 ** 9))
    ms = time_ms(torch, lambda: da.decode_attention_cuda(*sets[next(it) % 8]))
    plain = time_ms(torch, lambda: da.decode_attention_plain(*sets[next(it) % 8]), reps=5)
    device_ms = time_queued_ms(torch, lambda: da.decode_attention_cuda(*sets[next(it) % 8]))
    # the same function as one library call: SDPA, the prefix mask, GQA
    lib_in = []
    for q_, k_, v_, l_ in sets:
        mask = (torch.arange(YS, device=dev) < l_[..., None]).reshape(M * B, 1, 1, YS)
        lib_in.append((q_.reshape(M * B, YH, 1, HD), k_.reshape(M * B, YS, YKVH, HD).transpose(1, 2),
                       v_.reshape(M * B, YS, YKVH, HD).transpose(1, 2), mask))
    lib = lambda i: Fn.scaled_dot_product_attention(
        *lib_in[i % 8][:3], attn_mask=lib_in[i % 8][3], enable_gqa=True)
    assert abs_err(lib(0).reshape(M, B, YH, HD), want) < 0.05
    library = time_ms(torch, lambda: lib(next(it)))
    library_device = time_queued_ms(torch, lambda: lib(next(it)))
    # the latency floor: an empty kernel on the same grid of clusters
    plan = da.launch_plan(M * B, YS, YH, YKVH, HD)
    floor = time_queued_ms(torch, lambda: da.launch_floor(plan, dev))
    valid = kv_len.sum().item()
    nbytes = 2 * M * B * YH * HD * 2 + valid * YKVH * HD * 2 * 2 + M * B * 4
    bms, by = bound_ms(nbytes, 4 * YH * HD * valid, "bfloat16")
    log("times", name="decode_attention", shape=f"M={M},B={B},S={YS},H={YH},KVH={YKVH} bf16",
        ms=f"{ms:.4f}", device_ms=f"{device_ms:.4f}", library_ms=f"{library:.4f}",
        library_device_ms=f"{library_device:.4f}", floor_device_ms=f"{floor:.4f}",
        bound_ms=f"{bms:.4f}", splits=plan.splits, of_bound=f"{bms / device_ms:.1%}")
    rows.append(dict(name="decode_attention", route="cuda",
                     source="src/repro_torch/csrc/decode_attn.cu",
                     replaces="src/repro/kernels/decode_attn.py:25",
                     launches=launches["decode_attention"],
                     launches_by_path=per_path("decode_attention"), max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=library,
                     device_ms=device_ms, library_device_ms=library_device,
                     floor_device_ms=floor, library="SDPA, the prefix mask, GQA"))
    del sets, lib_in

    rows += new_time_rows(torch, dev, profile_launches, per_path("fused_matmul"),
                          per_path("mlstm_chunkwise"))
    rows += phase_time_rows(torch, dev, launches, per_path)
    rows.append(sharded_attn_time_row(torch, dev, launches, per_path))
    rows.append(sharded_matmul_time_row(torch, dev, launches, per_path))
    for r in rows:
        log("times", name=r["name"], ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"],
            library_ms=r["library_ms"], of_bound=f"{r['bound_ms'] / r['ms']:.1%}",
            **({"device_ms": f"{r['device_ms']:.4f}"} if "device_ms" in r else {}))
    return rows


def matmul_time(torch, dev, g, m, t, d, f, copies, dtype="bfloat16"):
    """The merged-matmul kernel at (m, t, d, f) in ``dtype``, ``copies``
    weight sets rotating so w comes from HBM, not L2: (max abs err against
    the plain version, event ms, device ms queued, plain ms, ``torch.bmm``
    ms, ``torch.bmm`` device ms queued, (bound ms, bound by))."""
    from repro_torch.kernels import fused_matmul as fm

    dt = getattr(torch, dtype)
    sets = [((torch.randn(m, t, d, generator=g, device=dev)).to(dt),
             (torch.randn(m, d, f, generator=g, device=dev) * d ** -0.5).to(dt))
            for _ in range(copies)]
    err = abs_err(fm.fused_matmul_cuda(*sets[0]), fm.fused_matmul_plain(*sets[0]))
    it = iter(range(10 ** 9))
    ms = time_ms(torch, lambda: fm.fused_matmul_cuda(*sets[next(it) % copies]))
    device_ms = time_queued_ms(torch, lambda: fm.fused_matmul_cuda(*sets[next(it) % copies]))
    plain = time_ms(torch, lambda: fm.fused_matmul_plain(*sets[next(it) % copies]), reps=5)
    lib = time_ms(torch, lambda: torch.bmm(*sets[next(it) % copies]))
    lib_device = time_queued_ms(torch, lambda: torch.bmm(*sets[next(it) % copies]))
    nbytes = _size(dtype) * (m * t * d + m * d * f + m * t * f)
    return (err, ms, device_ms, plain, lib, lib_device,
            bound_ms(nbytes, 2 * m * t * d * f, dtype))


def sharded_matmul_time_row(torch, dev, launches, per_path):
    """The times row of ``fused_matmul_sharded``: a rank's block at 2x2
    (half the instances, half of F) at the tinyllama serving shape, (2, 4,
    2048, 2816), in the row, and at the BERT shape, (16, 128, 768, 1536),
    beside it, bf16.  The wrapper's body is the merged-matmul kernel on the
    block, so the kernel is timed on it.  ``launches`` include the data
    phase's ranks."""
    g = torch.Generator(device=dev).manual_seed(33)
    err, ms, device_ms, plain, lib, lib_dev, (bms, by) = matmul_time(torch, dev, g, M // 2, B, D,
                                                                     F // 2, 8)
    b_err, b_ms, b_dev, b_plain, b_lib, b_lib_dev, (b_bms, b_by) = matmul_time(
        torch, dev, g, 16, 128, 768, 1536, 4)
    log("times", name="fused_matmul_sharded", shape="rank of 2x2: (16,128,768)@(16,768,1536) bf16",
        ms=f"{b_ms:.4f}", device_ms=f"{b_dev:.4f}", plain_ms=f"{b_plain:.4f}",
        library_ms=f"{b_lib:.4f}", library_device_ms=f"{b_lib_dev:.4f}",
        bound_ms=f"{b_bms:.4f}", bound_by=b_by, of_bound=f"{b_bms / b_dev:.1%}")
    return dict(name="fused_matmul_sharded", route="cuda",
                source="src/repro_torch/csrc/fused_matmul.cu",
                replaces="src/repro/kernels/fused_matmul.py:120",
                launches=launches["fused_matmul_sharded"],
                launches_by_path=per_path("fused_matmul_sharded"), max_abs_err=err, ms=ms,
                device_ms=device_ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=lib, library_device_ms=lib_dev, library="torch.bmm",
                shape=f"rank of 2x2: ({M // 2},{B},{D})@({M // 2},{D},{F // 2}) bf16",
                bert_ms=b_ms, bert_device_ms=b_dev, bert_plain_ms=b_plain,
                bert_library_ms=b_lib, bert_library_device_ms=b_lib_dev, bert_bound_ms=b_bms,
                bert_bound_by=b_by, bert_max_abs_err=b_err)


def new_time_rows(torch, dev, launches, moe_launches, mlstm_launches):
    """Times rows of the merged matmul, the group RMS norm and the chunkwise
    mLSTM at the profiler's shapes; ``launches`` are the counts of the
    profile phase (their main path), ``moe_launches`` the merged matmul's
    on the serve and mesh paths, by path (moe's experts, xlstm's mLSTM
    decode step, whisper's prefill cross-attention), ``mlstm_launches``
    the mLSTM's on the other paths by path (the train phase's)."""
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.kernels import group_norm as gn
    from repro_torch.kernels import mlstm_chunk as ml
    from repro_torch.serving.obs import kernel_profile as kp

    rows = []
    g = torch.Generator(device=dev).manual_seed(31)
    bf16 = torch.bfloat16

    # merged matmul: the tinyllama serving shape in the row, the BERT shape
    # beside it
    err, ms, dev_ms, plain, lib, lib_dev, (bms, by) = matmul_time(torch, dev, g, M, B, D, F, 8)
    b_err, b_ms, b_dev, b_plain, b_lib, b_lib_dev, (b_bms, b_by) = matmul_time(
        torch, dev, g, 32, 128, 768, 3072, 4)
    # beside them, olmoe-1b-7b's expert products at M=4 (256 (instance,
    # expert) pairs): gate / up at a decode step (4 rows a pair) and a
    # prefill chunk call (32 rows a pair)
    moe = {}
    for tag, t in (("moe_decode", B), ("moe_prefill", C)):
        e_, e_ms, e_dev, _, e_lib, e_lib_dev, (e_bms, e_by) = matmul_time(
            torch, dev, g, 4 * 64, t, 2048, 1024, 2)
        moe.update({f"{tag}_device_ms": e_dev, f"{tag}_ms": e_ms,
                    f"{tag}_library_device_ms": e_lib_dev, f"{tag}_bound_ms": e_bms,
                    f"{tag}_bound_by": e_by, f"{tag}_max_abs_err": e_})
        log("times", name="fused_matmul", shape=f"(256,{t},2048)@(256,2048,1024) bf16",
            ms=f"{e_ms:.4f}", device_ms=f"{e_dev:.4f}", library_ms=f"{e_lib:.4f}",
            library_device_ms=f"{e_lib_dev:.4f}", bound_ms=f"{e_bms:.4f}",
            of_bound=f"{e_bms / e_dev:.1%}")
    # and the f32 products whose sums must not depend on how many instances
    # share the call: the xlstm-1.3b mLSTM decode step's q C (one (1, 1024)
    # @ (1024, 1024) a lane and head at M=4 x B=4, 4 heads) and whisper's
    # prefill cross-attention over 1500 frames (4 lanes x 12 heads, chunk
    # 32: the scores, then P [V | 1])
    # and the olmoe-1b-7b train cell's expert products (M=2 x 64 experts,
    # 80 rows a pair at S=512): the forward x @ w and the backward's dx = dy
    # @ w^T and dw = x^T @ dy as ``fused_matmul.Merged`` launches them (the
    # transposed operand's contiguous copy is not in these times)
    for tag, shape, dtype in (
            ("mlstm_step", (64, 1, 1024, 1024), "float32"),
            ("cross_scores", (48, C, 64, 1500), "float32"),
            ("cross_pv", (48, C, 1500, 65), "float32"),
            ("train_fwd", (128, 80, 2048, 1024), "bfloat16"),
            ("train_dx", (128, 80, 1024, 2048), "bfloat16"),
            ("train_dw", (128, 2048, 80, 1024), "bfloat16")):
        e_, e_ms, e_dev, _, e_lib, e_lib_dev, (e_bms, e_by) = matmul_time(
            torch, dev, g, *shape, 2, dtype=dtype)
        moe.update({f"{tag}_device_ms": e_dev, f"{tag}_ms": e_ms,
                    f"{tag}_library_device_ms": e_lib_dev, f"{tag}_bound_ms": e_bms,
                    f"{tag}_bound_by": e_by, f"{tag}_max_abs_err": e_})
        m_, t_, d_, f_ = shape
        log("times", name="fused_matmul", shape=f"({m_},{t_},{d_})@({m_},{d_},{f_}) {dtype}",
            ms=f"{e_ms:.4f}", device_ms=f"{e_dev:.4f}", library_ms=f"{e_lib:.4f}",
            library_device_ms=f"{e_lib_dev:.4f}", bound_ms=f"{e_bms:.4f}",
            of_bound=f"{e_bms / e_dev:.1%}")
    by_path = {"profile": launches["fused_matmul"], **moe_launches}
    rows.append(dict(name="fused_matmul", route="cuda", source="src/repro_torch/csrc/fused_matmul.cu",
                     replaces="src/repro/kernels/fused_matmul.py:24",
                     launches=sum(by_path.values()), launches_by_path=by_path, **moe,
                     max_abs_err=err, ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=lib, device_ms=dev_ms,
                     library_device_ms=lib_dev,
                     shape=f"({M},{B},{D})@({M},{D},{F}) bf16", bert_ms=b_ms,
                     bert_device_ms=b_dev, bert_plain_ms=b_plain, bert_library_ms=b_lib,
                     bert_library_device_ms=b_lib_dev, bert_bound_ms=b_bms,
                     bert_bound_by=b_by, bert_max_abs_err=b_err,
                     library="torch.bmm"))
    log("times", name="fused_matmul", shape=f"({M},{B},{D})@({M},{D},{F}) bf16",
        ms=f"{ms:.4f}", device_ms=f"{dev_ms:.4f}", library_ms=f"{lib:.4f}",
        library_device_ms=f"{lib_dev:.4f}", bound_ms=f"{bms:.4f}", of_bound=f"{bms / dev_ms:.1%}")
    log("times", name="fused_matmul", shape="(32,128,768)@(32,768,3072) bf16",
        ms=f"{b_ms:.4f}", device_ms=f"{b_dev:.4f}", plain_ms=f"{b_plain:.4f}",
        library_ms=f"{b_lib:.4f}", library_device_ms=f"{b_lib_dev:.4f}",
        bound_ms=f"{b_bms:.4f}", bound_by=b_by, of_bound=f"{b_bms / b_dev:.1%}")

    # group RMS norm at the BERT shape: launch latency dominates, so the
    # device time of calls queued behind a spin kernel stands beside it
    x = (3 * torch.randn(32, 128, 768, generator=g, device=dev)).to(bf16)
    scale = (1 + 0.1 * torch.randn(32, 768, generator=g, device=dev)).to(bf16)
    err = abs_err(gn.group_rms_norm_cuda(x, scale), gn.group_rms_norm_plain(x, scale))
    ms = time_ms(torch, lambda: gn.group_rms_norm_cuda(x, scale))
    device_ms = time_queued_ms(torch, lambda: gn.group_rms_norm_cuda(x, scale))
    plain = time_ms(torch, lambda: gn.group_rms_norm_plain(x, scale))
    bms, by = bound_ms(2 * x.numel() * 2 + scale.numel() * 2, 4 * x.numel(), "float32")
    rows.append(dict(name="group_rms_norm", route="cuda", source="src/repro_torch/csrc/group_norm.cu",
                     replaces="src/repro/kernels/group_norm.py:17",
                     launches=launches["group_rms_norm"], max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                     library="none: F.rms_norm takes one (D,) weight, not M of them",
                     shape="(32,128,768) bf16, bf16 scale", device_ms=device_ms))
    del x

    # chunkwise mLSTM at the xlstm-1.3b profiler shape
    q, k, v, lf, li = mlstm_inputs(torch, dev, bf16, 4, 4, 4, 32, 1024, 32)
    gh, gst = ml.mlstm_chunkwise_cuda(q, k, v, lf, li, chunk=32)
    wh, wst = ml.mlstm_chunkwise_plain(q, k, v, lf, li, chunk=32)
    err = max(abs_err(a, w_) for a, w_ in zip((gh,) + gst, (wh,) + wst))
    del gh, gst, wh, wst
    ms = time_ms(torch, lambda: ml.mlstm_chunkwise_cuda(q, k, v, lf, li, chunk=32), reps=10)
    device_ms = time_queued_ms(torch, lambda: ml.mlstm_chunkwise_cuda(q, k, v, lf, li, chunk=32))
    plain = time_ms(torch, lambda: ml.mlstm_chunkwise_plain(q, k, v, lf, li, chunk=32), reps=5)

    def mlstm_bound(lanes, s, hd, cs):
        # q, k, v and h in bf16, the gates and the final C, n, m in f32
        nbytes = 4 * lanes * s * hd * 2 + 2 * lanes * s * 4 + lanes * (hd * hd + hd + 1) * 4
        return bound_ms(nbytes, kp.mlstm_chunkwise_flops(lanes, s, hd, cs), "bfloat16")

    bms, by = mlstm_bound(64, 32, 1024, 32)
    # beside it: four chunks of 64 and xlstm-1.3b's reference chunk of 128
    # over two chunks (C kept in registers over the chunks)
    extra = {}
    # and at the train phase's shape (xlstm-1.3b at M=2, B=1, S=256: 8 lanes)
    for tag, (m_, s_, cs) in (("4x64", (4, 256, 64)), ("2x128", (4, 256, 128)),
                              ("_train2x128", (2, 256, 128))):
        q2, k2, v2, lf2, li2 = mlstm_inputs(torch, dev, bf16, m_, 1, 4, s_, 1024, 43)
        e2 = abs_err(ml.mlstm_chunkwise_cuda(q2, k2, v2, lf2, li2, chunk=cs)[0],
                     ml.mlstm_chunkwise_plain(q2, k2, v2, lf2, li2, chunk=cs)[0])
        d2 = time_queued_ms(torch, lambda: ml.mlstm_chunkwise_cuda(q2, k2, v2, lf2, li2,
                                                                   chunk=cs))
        b2, by2 = mlstm_bound(4 * m_, s_, 1024, cs)
        extra.update({f"chunks{tag}_device_ms": d2, f"chunks{tag}_bound_ms": b2,
                      f"chunks{tag}_bound_by": by2, f"chunks{tag}_max_abs_err": e2})
        log("times", name="mlstm_chunkwise", shape=f"qkv ({m_},1,4,{s_},1024) bf16, chunk {cs}",
            device_ms=f"{d2:.4f}", bound_ms=f"{b2:.4f}", bound_by=by2,
            of_bound=f"{b2 / d2:.1%}")
        del q2, k2, v2, lf2, li2
    log("times", name="mlstm_chunkwise", shape="qkv (4,4,4,32,1024) bf16, chunk 32",
        ms=f"{ms:.4f}", device_ms=f"{device_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by,
        of_bound=f"{bms / device_ms:.1%}")
    rows.append(dict(name="mlstm_chunkwise", route="cuda", source="src/repro_torch/csrc/mlstm_chunk.cu",
                     replaces="src/repro/kernels/mlstm_chunk.py:29",
                     launches=launches["mlstm_chunkwise"] + sum(mlstm_launches.values()),
                     launches_by_path={"profile": launches["mlstm_chunkwise"],
                                       **mlstm_launches}, max_abs_err=err, ms=ms,
                     device_ms=device_ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=None,
                     library="none: no one PyTorch call computes the chunkwise scan",
                     shape="qkv (4,4,4,32,1024) bf16, chunk 32", **extra))
    return rows


def phase_time_rows(torch, dev, launches, per_path):
    """Times rows of the two halves of the sharded decode layer at a rank's
    shapes at TP=2 (bf16, M=4 x B=4 slots, positions inside the prompts'
    range); 4 input copies rotate so the weights come from HBM, as in a
    decode step.  ``launches`` include the TP serve (rank 0)."""
    from repro_torch.kernels import decode_layer as dl

    rows = []
    g = torch.Generator(device=dev).manual_seed(41)
    sets = [layer_inputs(torch, dev, torch.bfloat16, 42 + i, h=TH, kvh=TKVH, ff=TF)
            for i in range(4)]
    pos = torch.randint(16, 545, (M, B), generator=g, device=dev).to(torch.int32)
    kw = dict(num_heads=TH, head_dim=HD, rope_theta=10000.0)
    lp, x, ck, cv = sets[0]
    got = dl.decode_layer_attn_cuda(lp, x, ck.clone(), cv.clone(), pos, **kw)[0]
    err = abs_err(got, dl.decode_layer_attn_plain(lp, x, ck.clone(), cv.clone(), pos, **kw)[0])
    it = iter(range(10 ** 9))
    attn = lambda f: (lambda s_: f(s_[0], s_[1], s_[2], s_[3], pos, **kw))(sets[next(it) % 4])
    ms = time_ms(torch, lambda: attn(dl.decode_layer_attn_cuda))
    device_ms = time_queued_ms(torch, lambda: attn(dl.decode_layer_attn_cuda))
    plain = time_ms(torch, lambda: attn(dl.decode_layer_attn_plain))
    n_w = D * (TH + 2 * TKVH) * HD + TH * HD * D
    valid = (pos + 1).clamp(max=S).sum().item()
    nbytes = (M * n_w * 2 + M * D * 4 + 2 * M * B * D * 2 + valid * TKVH * HD * 2 * 2
              + M * B * TKVH * HD * 2 * 2 + M * B * 4)
    bms, by = bound_ms(nbytes, 2 * M * B * n_w + 4 * TH * HD * valid, "bfloat16")
    rows.append(dict(name="decode_layer_attn", route="cuda",
                     source="src/repro_torch/csrc/decode_layer.cu",
                     replaces="src/repro/kernels/decode_layer.py:144",
                     launches=launches["decode_layer_attn"],
                     launches_by_path=per_path("decode_layer_attn"), max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                     device_ms=device_ms,
                     shape=f"rank of TP={TP}: H={TH}, KVH={TKVH}, M={M}, B={B}, S={S} bf16"))
    ffn_in = lambda s_: (s_[1], *(s_[0][k] for k in ("mlp_norm", "w_gate", "w_up", "w_down")))
    err = abs_err(dl.ffn_cuda(*ffn_in(sets[0])), dl.ffn_plain(*ffn_in(sets[0])))
    ffn = lambda f: f(*ffn_in(sets[next(it) % 4]))
    ms = time_ms(torch, lambda: ffn(dl.ffn_cuda))
    device_ms = time_queued_ms(torch, lambda: ffn(dl.ffn_cuda))
    plain = time_ms(torch, lambda: ffn(dl.ffn_plain))
    n_w = 3 * D * TF
    bms, by = bound_ms(M * n_w * 2 + M * D * 4 + 2 * M * B * D * 2, 2 * M * B * n_w, "bfloat16")
    rows.append(dict(name="decode_layer_ffn", route="cuda",
                     source="src/repro_torch/csrc/decode_layer.cu",
                     replaces="src/repro/kernels/decode_layer.py:201",
                     launches=launches["decode_layer_ffn"],
                     launches_by_path=per_path("decode_layer_ffn"), max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                     device_ms=device_ms, shape=f"rank of TP={TP}: F={TF}, M={M}, B={B} bf16"))
    del sets
    return rows


def sharded_attn_time_row(torch, dev, launches, per_path):
    """The times row of ``decode_attention_sharded`` at each plan's
    per-rank shape of hymba-1.5b (M=4 x B=4 slots, bf16, kv_len inside the
    served positions, 8 input copies rotating so K/V come from HBM): the
    main fields at TP=2 (plan None, the TP serve's), the others beside
    them.  ``launches`` include the hybrid TP serve (rank 0)."""
    from types import SimpleNamespace

    import torch.nn.functional as Fn

    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_layer import tp_head_plan

    per_plan = {}
    for n in HYBRID_TPS:
        plan = tp_head_plan(YH, YKVH, n)
        lo, hi, _ = da.rank_kv_heads(YH, YKVH, n, 0) if plan else (0, YKVH, None)
        h, kvh = (YH // n if plan else YH), hi - lo
        sets = [decode_attn_inputs(torch, dev, torch.bfloat16, 50 + i, lens=(144, 673),
                                   h=h, kvh=kvh) for i in range(8)]
        kw = dict(plan=plan, tp=SimpleNamespace(rank=0, size=n), num_kv_heads=YKVH)
        got = ops.decode_attention_sharded(*sets[0], **kw)
        err = abs_err(got, da.decode_attention_plain(*sets[0]))
        it = iter(range(10 ** 9))
        ms = time_ms(torch, lambda: ops.decode_attention_sharded(*sets[next(it) % 8], **kw))
        device_ms = time_queued_ms(
            torch, lambda: ops.decode_attention_sharded(*sets[next(it) % 8], **kw))
        plain = time_ms(torch, lambda: da.decode_attention_plain(*sets[next(it) % 8]), reps=5)
        lib_in = []
        for q_, k_, v_, l_ in sets:
            mask = (torch.arange(YS, device=dev) < l_[..., None]).reshape(M * B, 1, 1, YS)
            lib_in.append((q_.reshape(M * B, h, 1, HD),
                           k_.reshape(M * B, YS, kvh, HD).transpose(1, 2),
                           v_.reshape(M * B, YS, kvh, HD).transpose(1, 2), mask))
        lib = lambda i: Fn.scaled_dot_product_attention(
            *lib_in[i % 8][:3], attn_mask=lib_in[i % 8][3], enable_gqa=True)
        assert abs_err(lib(0).reshape(M, B, h, HD), got) < 0.05
        library = time_ms(torch, lambda: lib(next(it)))
        valid = sets[0][3].sum().item()
        nbytes = 2 * M * B * h * HD * 2 + valid * kvh * HD * 2 * 2 + M * B * 4
        bms, by = bound_ms(nbytes, 4 * h * HD * valid, "bfloat16")
        per_plan[f"T{n}/{plan}"] = dict(shape=f"q heads {h} over kv heads {kvh}",
                                       max_abs_err=err, ms=ms, device_ms=device_ms,
                                       plain_ms=plain, bound_ms=bms, bound_by=by,
                                       library_ms=library)
        log("times", name="decode_attention_sharded", ranks=n, plan=plan,
            shape=f"M={M},B={B},S={YS},H={h},KVH={kvh}", ms=f"{ms:.4f}",
            device_ms=f"{device_ms:.4f}", plain_ms=f"{plain:.4f}",
            library_ms=f"{library:.4f}", bound_ms=f"{bms:.4f}", bound_by=by,
            of_bound=f"{bms / device_ms:.1%}")
        del sets, lib_in
    main = per_plan[f"T{TP}/None"]
    return dict(name="decode_attention_sharded", route="cuda",
                source="src/repro_torch/csrc/decode_attn.cu",
                replaces="src/repro/kernels/decode_attn.py:114",
                launches=launches["decode_attention_sharded"],
                launches_by_path=per_path("decode_attention_sharded"),
                **{k: v for k, v in main.items() if k != "shape"},
                shape=f"rank of TP={TP}: " + main["shape"], per_plan=per_plan)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log("phase", name=name, seconds=round(time.perf_counter() - t, 1))
        return out

    timed("device", phase_device, torch)
    timed("build", phase_build)
    b32 = timed("kernels", phase_kernels, torch, dev)
    launches, single_streams, olmoe_streams = timed("serve", phase_serve, torch, dev)
    launches["tinyllama-1.1b/periphery"] = timed("periphery", phase_periphery, torch, dev,
                                                 single_streams)
    timed("check", phase_check, torch, dev)
    timed("graph", phase_graph, torch, dev)
    launches.update(timed("train", phase_train, torch, dev))
    launches.update(timed("tp", phase_tp, torch, dev))
    launches[f"hymba-1.5b/tp{TP}-rank0"] = timed("tp_hybrid", phase_tp_hybrid, torch, dev)
    by_mesh, matmul_launches = timed("data", phase_data, torch, dev, single_streams)
    for name, la in by_mesh.items():
        launches[name if "/" in name else f"tinyllama-1.1b/data{name}-rank0"] = la
    launches["fused_matmul_sharded/data2x2-ranks"] = dict(
        dict.fromkeys(by_mesh["2x2"], 0), fused_matmul_sharded=matmul_launches)
    launches.update(timed("moe_mesh", phase_moe_mesh, torch, dev, olmoe_streams))
    launches["internvl2-26b/mesh1x2-rank0"] = timed("vlm_mesh", phase_vlm_mesh, torch, dev)
    timed("paper", phase_paper, torch, dev)
    profile_launches = timed("profile", phase_profile, torch, dev)
    rows = timed("times", phase_times, torch, dev, launches, profile_launches, b32)
    log("done", seconds=round(time.perf_counter() - t0, 1))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
