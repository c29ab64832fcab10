#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cambrian_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Phases, each of which must pass (a failure raises and exits non-zero):

1. the card's name and power limit (nvidia-smi), whether ``requests``
   imports (phase 12's HTTP client; else ``urllib.request``), then the
   build of every
   kernel from the repository's sources (one nvcc per source, all started
   together, sm_90a), ptxas' registers and spills of each kernel, and the
   tensor-core instructions (``cuobjdump -sass``: HGMMA, HMMA) of each
   kernel function of K1, K2, the quant matmuls and K8; every bf16 K1/K2 one
   must have HGMMA (16 of K1, 40 of K2: its dk/dv function for DP <= 128,
   the dV-alone and dK-alone ones for DP = 144..256, dq at every DP), K2's
   functions must be exactly those and its fp32 ones (64-row q tiles up to
   D = 128, 32-row above), with the registers and spills of those above 128
   printed, and each of the six bf16 prefill functions of K3, K4 and
   K4b (``gemm_wgmma_kernel``, modes 0-2, tiles of 64 and 128 columns) and
   the eight bf16 GEMM functions of K8 (``mlp_up_kernel`` and
   ``mlp_down_kernel``, tiles of 64, 128, 192 and 256 columns) must be
   there, with HGMMA and no HMMA; the three functions of the bf16 M = 1
   decode GEMV of K3, K4 and K4b/K4c (``gemv_m1_kernel<0>``, ``<1>``,
   ``<2>``) must be there, with their registers, I2F and HMMA counts and
   their main loop's SASS instructions per packed byte printed; none may
   spill, and ``<2>`` must run its products on the tensor cores (HMMA); so
   must the 18 functions of the bf16 M = 2..8 decode GEMV
   (``gemv_m8_kernel<mode, MT, W>``: modes 0-2, MT = 2, 4, 8 rows of x,
   W = 16 or 8 bytes a lane), every one with HMMA, none spilling, their
   registers, I2F, HMMA and instructions per packed byte printed;
   every instance of K6's ``layer_norm_vec_kernel`` (2 dtypes x the
   (lanes, chunks) pairs of ``norms.LN_INSTANCES``) and ``layer_norm_kernel``
   must be there without spills; so must every instance of K7's
   ``dwconv7x7_tma_kernel`` (2 dtypes x the register blocks of
   ``dwconv.DW_INSTANCES``) and ``dwconv7x7_kernel``, with the TMA kernel's
   registers and its tile loop's FFMA share printed; and every instance of
   K5's ``sva_attention_tma_kernel`` (the (lanes, window class) pairs of
   ``sva_attention.SVA_INSTANCES`` each dtype can need) and
   ``sva_attention_kernel``,
   with their registers and the 8B site plan's shared memory printed;
2. K1, flash attention, against its plain PyTorch version on the card at the
   shapes the main path gives it (SigLIP, CLIP, DINOv2 blocks; decoder
   prefill with GQA; Phi-3's prefill of phase 11's long request, D = 96
   with the 2,048-slot window) in bf16 and fp32, plus a causal case with
   padding and dead rows; max abs error against the fp32 plain result (and of the row
   statistic K1 writes for the backward against its plain version),
   CUDA-event times (each call alone behind a spin kernel) of the kernel,
   the plain version and ``F.scaled_dot_product_attention``
   (the library yardstick), and the bound from the case's bytes and
   operations;
3. K3, K4 and K4b/K4c, the int8 / int4 dequant-matmuls, against their plain
   versions at the seven decoder projection shapes of Cambrian-8B, at
   M = 1 (decode) and M = request 0's prompt length (prefill), bf16 and
   fp32: max abs error against the plain version on the inputs upcast to
   fp32, CUDA-event times with the L2 cache flushed before each call (as a
   decode step finds the weights) of the kernel, the plain version and
   ``torch.matmul`` on the dequantized weight, and the bound; each bf16
   prefill case also runs once under ``torch.profiler``, which must show
   ``gemm_wgmma_kernel``, and its TFLOP/s (2 M N K / time) are printed;
   each bf16 M = 1 case of K3, K4 and K4b runs in the same profiled run,
   which must show ``gemv_m1_kernel<mode>`` and no ``gemv_kernel``, gives
   the same bits on a second call, and is timed as the median of 30 calls
   beside the first port's ``gemv_kernel`` (``_route="gemv_kernel"``) and
   ``torch.matmul``, with its TB/s, its share of the bound and a decode
   step's sum of each; and bf16 at M = 4, the continuous-batching decode
   (phase 12), which runs ``gemv_m8_kernel<mode,4,W>`` alone (by counter and
   in the profiled run), with M = 8 at q_proj and down_proj and M = 2 and 3
   at k_proj: error against plain on fp32-upcast inputs, two calls equal
   bit for bit, medians of 30 with the L2 flushed beside the first port's
   ``gemv_kernel`` (``_route="gemv_kernel"``, held against plain too),
   ``torch.matmul`` and the plain version, the bound and a decode step's
   sums;
4. a tiny Cambrian, unquantized, int8 and int4: the kernel path on the card
   in fp32 (TF32 off) against the plain path on the CPU; greedy tokens must
   be identical and the kernels launched exactly as often as the path needs;
   unquantized, once more with a sliding window shorter than the prompt:
   ``generate`` and ``generate_stream`` on the card and ``generate`` on the
   CPU must give the same tokens; and as a Phi-3 with LongRoPE whose KV
   cache exceeds ``original_max_position_embeddings`` (the long factors);
   unquantized, int8 and int4, the continuous-batching engine on the card
   (the image request and two text requests on 2 slots, chunks of 4) must
   give the tokens of the same engine on the CPU; the phase restores the
   TF32 flags it found, so the later phases' fp32 products stay fp32;
5. Cambrian-8B at full width (four towers, SVA, LLaMA-3-8B), bf16 weights
   and an fp32 LM head made on the card from a seed: three requests of 32
   greedy tokens through ``CambrianForInference.generate``; each must launch
   K1 exactly 27 + 23 + 40 + 32 = 122 times (decode steps use plain
   attention) and give finite logits; the fp32 LM head timed in fp32 and in
   TF32 at the prefill and at a decode step;
6. the same model quantized on the card, layer by layer, with ``load_8bit``
   and then ``load_4bit`` semantics (the bf16 model freed first): two
   requests through ``generate``, each launching K1 122 times and its quant
   kernel 7 x 32 x 32 = 7,168 times (prefill and 31 decode steps), and one
   through ``generate_stream``, whose 4 chunks of 8 decode steps launch it
   7 x 32 x (1 + 32) = 7,392 times and whose tokens must equal
   ``generate``'s on the same prompt; with int4, one more request under
   ``CAMBRIAN_INT4_V2=1`` runs the scale-on-weights kernel 7,168 times, its
   prefill on the GEMM and its 31 decode steps on ``gemv_m1_kernel<2>``;
   each quantized request's prefill ms is printed beside the bf16 model's
   on the same prompt;
7. K2, the flash-attention backward, against its plain PyTorch version on
   the card (serving models freed): the stage-1 decoder shapes of
   Cambrian-8B (batch 8 x 2048, 32/8 heads, D 128, causal, right padding)
   and Cambrian-Gemma-7B (the same with 16/16 heads of D 256), causal cases
   with a sliding window and dead rows at D = 128 and 256, D = 192, and the
   three tower shapes, in bf16 and fp32, given the forward's row statistic
   as the training step gives it; max abs error of dq/dk/dv, CUDA-event
   times of the kernel, the plain version and the backward of
   ``F.scaled_dot_product_attention`` (forward+backward less forward; the
   library yardstick; at the two training shapes the backend it picked,
   named from one profiled call's kernels), the bound, and the statistic's
   own cost (K1 with it less K1 without);
8. a tiny Cambrian through ``make_train_step``, 3 optimizer steps of stage 1
   and 3 of stage 2 with remat, on the card (K1/K2, fp32, TF32 off) against
   the plain path on the CPU from the same weights and batches: losses and
   updated parameters must agree, K2 must launch once per decoder layer and
   micro-batch, K1 once per tower block and twice per decoder layer
   (forward and remat recompute);
9. Cambrian-8B stage-1 pretraining at full width and depth with the
   settings of ``scripts/cambrian/pretrain_cambrian_8b.sh`` (towers and
   decoder frozen in bf16, norms fp32, the connector trained through fp32
   masters): ``CambrianTrainer.train()`` for 3 optimizer steps at batch 8 x
   2048 on pre-tokenized samples made with numpy; finite losses, a moved
   connector, bitwise-unchanged frozen weights, exactly 154 K1 and 32 K2
   launches per micro-batch; step times, throughput, peak memory, and one
   more step under ``torch.profiler`` for where a step's device time goes
   (no kernel may recompute the row statistics there);
10. K5-K8 (SVA windowed attention, fused LayerNorm, depthwise 7x7 conv,
   fused GELU MLP), which no site of the path calls (as in the JAX
   package), on the inputs that one more warm bf16 request of phase 5 gave
   their drop-in sites (hooks on every LayerNorm, ConvNeXt dwconv and
   pwconv pair, SVA Mlp, and a recording wrapper around the SVA attention):
   one drop-in pass over every site shape, which must launch each kernel
   once per shape; each kernel against its plain version on fp32-upcast
   inputs and against the main path's output at the site; CUDA-event
   times (L2 flushed) of the kernel, its plain version and the library
   call the main path makes there (K6: medians of 30, in turns with its
   plain version, ``F.layer_norm`` and the port's ``layer_norm``, each
   record naming the kernel function, which must be ``layer_norm_vec_kernel``
   at every aligned bf16 site); the bound; training-batch (B = 8) and
   small fp32 cases, and K8 and K6 on x one element off its alignment (K8's
   ``mma.sync`` kernel; K6's scalar ``layer_norm_kernel``, which must run
   there, so both K6 functions are held against plain); K7 timed as
   medians of 30 in turns with its plain version, the first port's
   ``dwconv7x7_kernel`` (forced through the plan) and the main path's
   ``F.conv2d`` (the library call, "cudnn conv2d"), every case
   naming its kernel function by the wrapper's counter (the drop-in pass
   and every captured site must run ``dwconv7x7_tma_kernel``; a bf16 case
   with C = 90, whose positions are not whole 16-byte units, must run
   ``dwconv7x7_kernel``, so both K7 functions are held against plain);
   K5 timed as medians of 30 in turns with its plain version, the first
   port's ``sva_attention_kernel`` (forced through the plan), SDPA on the
   batch-flattened windows (the library call) and the main path's einsums,
   every case naming its kernel function by the wrapper's counter (the
   drop-in pass, the site and its training batch must run
   ``sva_attention_tma_kernel``; a bf16 case with k and v as views whose
   heads lie W D apart must run ``sva_attention_kernel``, so both K5
   functions are held against plain), with a request's sums and each case's
   share of the bound; K5-K7's backward against the plain backward. One
   ``torch.profiler`` run of every K8, K7 and K5 case must show the up and
   down wgmma functions that each bf16 K8 site plans, the ``mma.sync``
   kernel for the unaligned case and the SIMT kernel for the fp32 one, each
   of those two no more often than its own case's calls, and the K7 and K5
   function (with its template arguments) that each K7 and K5 case plans;
   K8's TFLOP/s (2 M H (C + C2) / time) are printed;
11. Cambrian-Phi-3 (``cambrian_phi3()``: the four towers, SVA and
   Phi-3-mini, 32 layers, hidden 3072, D = 96, the 2,048-slot window):
   (a) bf16 weights at full width and depth made on the card, three
   requests of 32 greedy tokens with the fp32 LM head and the same three
   with ``lm_head_dtype="bf16"`` on the same tensors (first-token logits
   within bf16 rounding of both operands of the fp32 head's, per
   vocabulary row; token agreement, decode tokens/s and the head's device
   time printed), and one request of 2,600 slots through ``generate`` and
   ``generate_stream`` (chunks of 8), whose tokens must agree; every
   request launches K1 122 times; (b) K3 and K4 against plain at Phi-3's
   seven projection shapes (bf16, M = 1 and request 0's prompt; the
   profiled run must show ``gemv_m1_kernel<mode>`` and
   ``gemm_wgmma_kernel``), then the model quantized on the card to int8
   and to int4, one request each: 7,168 launches of its kernel, the
   prefill on the GEMM and 31 decode steps on ``gemv_m1_kernel`` by the
   route counter; (c) a Cambrian-Phi-3 checkpoint (full width, 2 decoder
   layers, bf16 safetensors shards by the port's writer) and the four tower
   snapshots at full width and depth (HF naming for SigLIP, CLIP and
   DINOv2 at 37 x 37, timm naming for ConvNeXt-XXL) written under
   ``build/``, loaded by ``load_pretrained_model`` with warnings as errors;
   every tensor must equal the converters' output on the CPU from the same
   files (the resampled DINOv2 position table within 1e-6) and one request
   the tokens of ``from_state_dict`` on those tensors; the files are
   deleted.

12. continuous batching on each model of phases 5 and 6 while it is live
   (bf16, int8, int4): ``ContinuousBatchingEngine`` with the worker's
   defaults (4 slots, max_len = context_len + 1024, bf16 cache, chunks of
   8); 8 requests submitted at once, cycling phase 5's prompts and images,
   each encoded through ``_prepare_generate``, six with 32 new tokens, one
   12 and one 20 (slots retire and are re-admitted while others decode),
   one with an EOS taken from inside a chunk of its prompt's sequential
   output. Every request must finish with its budget or at its EOS, and its
   first token must equal sequential ``generate``'s (the share of agreeing
   tokens is printed); K1 exactly 122 times a request (90 at its encode, 32
   at its admission); quantized, 7 x 32 GEMM launches an admission and
   7 x 32 ``gemv_m8_kernel`` launches a decode step (route counter). Every
   chunk's steps run under ``torch.cuda.set_sync_debug_mode("error")``: no
   host sync inside a chunk. Printed: each request's time to first token,
   the tokens/s across slots (all chunks, and those without an
   admission), the wall ms of each chunk, peak memory, and phase 5's or
   6's sequential tokens/s. Then 4 text requests whose second chunk (all
   decode) runs under ``torch.profiler`` (quantized: ``gemv_m8_kernel<mode,
   4, W>`` 7 x 32 x 8 times and no other quant function: no
   ``gemv_kernel``, no ``gemv_m1_kernel``), and with int4 4 more under
   ``CAMBRIAN_INT4_V2=1``
   (K4b at M = 4). With bf16, the port's ``ModelWorker`` (continuous
   batching) on the live model serves 4 concurrent text-only streams over
   localhost HTTP with a numpy stand-in tokenizer: every chunk error code 0,
   each stream its whole budget; the server and the worker's stepper stop
   before the model is freed.

13. the encoder-study towers: (a) a tiny tower of each new family (plain
   ViT, DFN, EVA-02 with rope and sub-LN, DPT, BEiT with its rel-pos bias,
   SAM, a hybrid, ``tiny_sd`` at 128 px) on the card against the same on
   the CPU, fp32 with TF32 off, K1's launches by counter; (b) each registered
   tower of ``ZOO_TOWERS`` at its published width, depth and resolution in
   bf16, weights made on the card, one at a time: a forward at batch 1 and 8
   (shape, finiteness, medians of ``ZOO_ITERS``, peak memory) whose K1
   launches by counter must equal ZOO_TOWERS' a forward; every K1 call's
   inputs at each new shape captured and held against the plain version,
   then K1, plain and SDPA timed alone there (L2 flushed, a spin kernel,
   medians of 30) beside the bound; (c) Cambrian-8B through ``generate``
   with EVA-02-L/14-336 in CLIP-L's place and SD-2.1 in ConvNeXt-XXL's
   (three requests of 32 greedy tokens, random bf16 weights made on the
   card): tokens in range, K1 ``ZOO_8B_K1`` times a request, none of K5-K8;
   encode ms by tower, prefill ms, decode tokens/s.

14. the decoder families: (a) a tiny Cambrian of each (Mistral with a
   window, Gemma at head_dim 256, Gemma with both Gemma-2 softcaps, Cohere,
   Cohere with qk-norm) on the card against the same on the CPU, fp32 with
   TF32 off, from the same weights and a 159-slot prompt: identical greedy
   tokens, K1 launched once a tower block and once a decoder layer, or at
   the towers alone under the attention softcap; (b) K1 at head_dim 256
   (and 192) against its plain version in bf16 and fp32 at Gemma-7B's
   prefill (1 x 645 x 16 x 256, causal, the cache's padding), the same with
   a hole in the keys and a q_offset, under a window, and at D = 192: max
   abs error (bf16 within 2e-2 of the output's scale), K1, plain and SDPA
   alone (L2 flushed, a spin kernel, medians of 30) beside the bound; (c)
   Cambrian-Gemma-7B (``GEMMA_7B`` with ``CAMBRIAN_SVA``: 28 layers, hidden
   3072, 16 heads of 256, tied 256,000-row embeddings) at full width and
   depth in bf16: three requests of 32 greedy tokens through ``generate``,
   each launching K1 90 + 28 = 118 times; then quantized on the card to
   int8 and to int4, one request each (7 x 28 x 32 launches of its kernel,
   the prefill on the GEMM and 31 decode steps on ``gemv_m1_kernel`` by the
   route counter); and ``ContinuousBatchingEngine`` on the bf16 model, 4
   slots, 4 image requests of 16 tokens, K1 118 times an admission; (d)
   Cambrian-Command-R (``COMMAND_R_35B`` with ``CAMBRIAN_SVA``, hidden 8192,
   64 heads of 128) at full width with 8 of its 40 layers (the SVA
   re-injected at layers 0, 3 and 6): two requests through ``generate``,
   K1 98 times each. Encode, prefill and decode times and peak memory are
   printed.

15. Cambrian-Gemma-7B stage 1 (``GEMMA_7B`` with ``CAMBRIAN_SVA`` at full
   width and depth, random bf16 weights made on the card): phase 9's run
   through ``CambrianTrainer.train()``, 3 optimizer steps at batch 8 x 2048;
   exactly 3 x (90 + 2 x 28) = 438 K1 and 3 x 28 = 84 K2 launches (K2 at
   head_dim 256), finite losses, a moved connector, the frozen weights (the
   tied 256,000 x 3,072 embedding among them) bitwise unchanged; step times,
   throughput, peak memory and one profiled step's idle share.

16. Cambrian-8B LoRA (``lora_enable``, r 16, alpha 32, the seven default
   targets in the decoder and the SVA samplers' projections, as the JAX
   package targets them) with ``scripts/cambrian/finetune_cambrian_8b.sh``'s
   flags, 3 optimizer steps at batch 8 x 2048 through
   ``CambrianTrainer.train()``: 3 x 154 K1 and 3 x 32 K2 launches; every b
   moved off 0; when the run ends every targeted weight is its base plus
   its adapters' delta and every other tensor (connector, norms, towers)
   bitwise unchanged; ``lora_adapters.safetensors`` holds two tensors a
   target under the JAX package's key names, equal to the run's adapters;
   a second trainer given it through ``lora_weight_path`` (0 steps) merges
   the same weights into the restored base; step times and peak memory.

17. the eval harness (``cambrian_tpu_torch.eval``): (a) right after phase
   4, the first record of every benchmark of
   ``tests/fixtures/eval/records.json`` (28) through the runner's
   ``answer_record`` (greedy, 8 new tokens, the stand-in tokenizer, pixels
   from a seeded numpy generator in place of ``process_images``) and
   ``score_answers`` on a tiny fp32 Cambrian on the card and on the CPU:
   identical rows and metrics, K1 once a tower block (and once a decoder
   layer for a prompt of 128 slots or more) and nothing else; then a tiny
   text-only model of each LLaVA-style projector type (linear,
   mlp2x_gelu, identity, se_mlp, CAbstractor): identical greedy tokens,
   first-token logits within 1e-3 and the projector within 1e-4; (b) on
   phase 5's live bf16 Cambrian-8B, before it is freed, the same 28
   records with ``request_images``' pixels: K1 exactly 122 times a request
   and nothing else; every benchmark scored, ``write_submission`` where a
   benchmark has a submission, ``append_experiment_row``, ``pivot`` and
   ``write_pivot`` into ``build/eval_8b/``; each request's encode, prefill
   and decode ms; (c) one such request under ``profiling.trace`` with
   ``annotate`` spans around encode and generate: the trace under
   ``build/eval_trace/`` must name both spans and ``fwd_bf16_kernel`` (a
   trace without the kernel is taken again, three times in all).

Prints one JSON line of kernel results, then, as the last line, the device
record. Exits non-zero without a result when no CUDA device is present.
"""

import argparse
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NEW_TOKENS = 32
N_REQUESTS = 3
LAUNCHES_PER_REQUEST = 27 + 23 + 40 + 32   # SigLIP, CLIP (layer -2), DINOv2, prefill
LAYERS = 32
QUANT_PER_STEP = 7 * LAYERS                 # decoder projections per forward
QUANT_LAUNCHES = QUANT_PER_STEP * NEW_TOKENS  # prefill + 31 decode steps = 7,168
STREAM_CHUNK = 8
# the tiny slice's sliding-window case: a window shorter than its prompt
WINDOW = 24
WINDOW_TOKENS = 16
# Cambrian-Phi-3 (phase 11): the long request's slots (the 2,048-slot
# window bites in its prefill and decode), the decoder's window and
# projections (site, K, N), and the 2-layer checkpoint that
# load_pretrained_model reads
PHI3_LONG_SLOTS = 2600
PHI3_WINDOW = 2048
PHI3_QUANT_SHAPES = [("q_proj", 3072, 3072), ("k_proj", 3072, 3072), ("v_proj", 3072, 3072),
                     ("o_proj", 3072, 3072), ("gate_proj", 3072, 8192),
                     ("up_proj", 3072, 8192), ("down_proj", 8192, 3072)]
PHI3_LOAD_LAYERS = 2
# the tiny slice's LongRoPE case (phase 4): its KV cache, 159 prompt slots + 8
# new, runs past original_max_position_embeddings, so the long factors apply
TINY_ROPE_ORIG = 64
# stage-1 training (phase 9): the launch script's batch and length
TRAIN_STEPS = 3
TRAIN_BATCH = 8
TRAIN_SEQ = 2048
TOWER_K1_CALLS = 27 + 23 + 40               # SigLIP, CLIP (layer -2), DINOv2
# per micro-batch: the towers, each decoder layer's forward and its remat
# recompute (K1); each decoder layer's backward (K2)
TRAIN_K1_LAUNCHES = TOWER_K1_CALLS + 2 * LAYERS  # 154
TRAIN_K2_LAUNCHES = LAYERS
SPIN_CYCLES = 200_000    # ~0.1 ms at the H100's clock: longer than one host launch
# ~0.5 ms: longer than a K5-K8 wrapper's host work (an autograd Function and a
# ctypes call), which a loaded host can stretch past 0.1 ms
SITE_SPIN_CYCLES = 1_000_000
# the card's published peaks (H100 SXM, dense): memory rate, and the
# operation rate for the inputs' type (bf16 tensor cores, fp32 CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# (site, K, N) of the decoder projections of LLaMA-3-8B
QUANT_SHAPES = [("q_proj", 4096, 4096), ("k_proj", 4096, 1024), ("v_proj", 4096, 1024),
                ("o_proj", 4096, 4096), ("gate_proj", 4096, 14336),
                ("up_proj", 4096, 14336), ("down_proj", 14336, 4096)]
# K3, K4 and K4b/K4c, whose bf16 M = 1 calls run gemv_m1_kernel, timed as
# medians of GEMV_ITERS calls beside the first port's gemv_kernel
GEMV_M1_KERNELS = ("int8_matmul", "int4_matmul", "int4_matmul_scale_on_weights")
GEMV_ITERS = 30
# phase 3's further bf16 rows of x for gemv_m8_kernel, by projection, beside
# CB_SLOTS at every projection
GEMV_M8_EXTRA = {"q_proj": (8,), "down_proj": (8,), "k_proj": (2, 3)}
# continuous batching (phase 12): the worker's defaults (model_worker.py),
# so a decode step runs every projection at M = CB_SLOTS on gemv_m8_kernel
CB_SLOTS = 4
CB_CHUNK = 8
CB_EXTRA_LEN = 1024          # max_len = context_len + 1024
# the 8 requests submitted at once: request r takes phase 5's prompt and
# image r % 3 and budget CB_BUDGETS[r]; request CB_EOS_REQUEST carries as its
# EOS a token from inside a chunk of its prompt's sequential output
CB_BUDGETS = [32, 12, 20, 32, 32, 32, 32, 32]
CB_EOS_REQUEST = 3
# one more pass of CB_SLOTS text requests of CB_TEXT_LEN ids and
# CB_TEXT_TOKENS tokens, whose second chunk (all decode) is profiled
CB_TEXT_LEN = 40
CB_TEXT_TOKENS = 2 * CB_CHUNK
# the HTTP phase: concurrent text-only streams through the port's worker
HTTP_STREAMS = 4
HTTP_TOKENS = 16
# phase 13, the encoder-study towers at full width, depth and resolution:
# (registry name, K1 launches a forward): a launch a block that runs (a tap
# at layer -2 leaves the last out), none where the attention is plain (BEiT's
# bias, SAM's decomposed rel-pos), SD-2.1's UNet self-attention over >= 128
# queries (the down blocks' 2 + 2 + 2 at 64^2, 32^2, 16^2; the up blocks'
# 3 + 3 + 3), a hybrid's towers' sum
ZOO_TOWERS = [("mae-vit-h-14", 32), ("moco-vit-b-16", 12), ("ijepa-vit-h-14", 32),
              ("ijepa-vit-g-16", 40), ("maws-vit-2b-14", 24), ("supervised-vit-h-14", 32),
              ("dfn-clip-vit-h-14", 31), ("eva/CLIP-ViT-L-336", 23), ("large-midas", 24),
              ("large-beit-midas-512", 0), ("sam_vit_h", 0), ("diffusion", 15),
              ("hybridmodel-mae-vit-h-14-&&&-dfn-clip-vit-h-14", 63)]
ZOO_BATCHES = (1, 8)
ZOO_ITERS = 5            # timed forwards a batch, after one warm-up
# Cambrian-8B with EVA-02-L/14-336 in CLIP-L's place (336 px, 24 x 24,
# hidden 1024) and SD-2.1 in ConvNeXt-XXL's (1,024 tokens resized to 9,216,
# hidden 3,520): K1 a request = SigLIP 27 + EVA-02 23 + DINOv2 40 + SD 15 +
# the prefill's 32
ZOO_8B_TOWERS = ("siglip/CLIP-ViT-SO400M-14-384", "eva/CLIP-ViT-L-336",
                 "facebook/dinov2-giant-res378", "diffusion")
ZOO_8B_K1 = 27 + 23 + 40 + 15 + 32
# phase 14, the decoder families: the tiny models' switches (a), the K1
# cases at head_dim 256 and 192 (b), Cambrian-Gemma-7B's 28 layers and its
# K1 a request (towers + prefill), its quantized projections a forward,
# continuous batching's slots and budget, and Command-R's cut depth (d)
FAMILY_TINY = {
    "mistral_window": dict(model_type="mistral", sliding_window=24),
    "gemma_d256": dict(model_type="gemma", hidden_act="gelu_pytorch_tanh", head_dim=256,
                       tie_word_embeddings=True, rms_norm_eps=1e-6),
    "gemma_softcap": dict(model_type="gemma", hidden_act="gelu_pytorch_tanh", head_dim=48,
                          tie_word_embeddings=True, rms_norm_eps=1e-6,
                          attn_logit_softcapping=0.5, final_logit_softcapping=1.0),
    "cohere": dict(model_type="cohere", tie_word_embeddings=True, logit_scale=0.0625),
    "cohere_qk_norm": dict(model_type="cohere", tie_word_embeddings=True, logit_scale=0.0625,
                           use_qk_norm=True),
}
GEMMA_LAYERS = 28
GEMMA_K1 = TOWER_K1_CALLS + GEMMA_LAYERS                # 118
GEMMA_QUANT_PER_STEP = 7 * GEMMA_LAYERS
FAMILY_CB_SLOTS = 4
FAMILY_CB_TOKENS = 16
COMMAND_R_LAYERS = 8
# phase 17: the eval harness, on the first record of every benchmark in the
# eval fixtures, greedy, with the runner's default template
EVAL_FIXTURES = os.path.join("tests", "fixtures", "eval", "records.json")
EVAL_TOKENS = 8
EVAL_CONV = "llama_3"
EVAL_SIZES = [(640, 480), (480, 640), (1024, 1024)]
EVAL_MODEL_ID = "cambrian-8b-random"
NON_SVA_PROJECTORS = ["linear", "mlp2x_gelu", "identity", "se_mlp", "CAbstractor"]
TINY_LOGIT_TOL = 1e-3      # tiny fp32 (TF32 off) logits, card against CPU, as phase 4
TINY_PROJ_TOL = 1e-4       # a tiny projector's output, card against CPU, fp32
COMMAND_R_K1 = TOWER_K1_CALLS + COMMAND_R_LAYERS        # 98
QUANT_KERNELS = {
    "int8_matmul": ("cambrian_tpu/ops/quant.py:55", "int8"),
    "int4_matmul": ("cambrian_tpu/ops/quant.py:227", "int4"),
    # K4b (:190, CAMBRIAN_INT4_V2=1) and K4c (:282, CAMBRIAN_INT4_V1=1)
    "int4_matmul_scale_on_weights": ("cambrian_tpu/ops/quant.py:190", "int4"),
}


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(torch, fn, iters=10, flush=None, spin=None, median=False):
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up.
    With ``flush`` or ``spin``, each call is timed alone, after ``flush()``
    has run if given; a spin kernel (``spin`` cycles, by default
    SPIN_CYCLES) then holds the stream until the host has queued the timed
    call, so that its launch cost on the host is not read as device time.
    Without either, the calls run back to back. ``median``: the median of
    the calls' times instead of their mean (calls of a few microseconds,
    where one slow call would move the mean)."""
    fn()
    torch.cuda.synchronize()
    if flush is None and spin is None and not median:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    events = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(spin or SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) for s, e in events]
    return float(np.median(times)) if median else sum(times) / iters


def cuda_ms_turns(torch, fns, iters, flush, spin=None):
    """{name: median device ms} of each of ``fns`` ({name: fn}), timed in
    turns: every round calls each fn once, in order, alone (after
    ``flush()`` and behind a spin kernel, as ``cuda_ms`` does), so that
    drifts of the card's clock fall on all of them alike."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    events = {name: [] for name in fns}
    for _ in range(iters):
        for name, fn in fns.items():
            flush()
            torch.cuda._sleep(spin or SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events[name].append((start, end))
    torch.cuda.synchronize()
    return {name: float(np.median([s.elapsed_time(e) for s, e in ev]))
            for name, ev in events.items()}


def bound(n_bytes, n_ops, dtype_name):
    """Least time for the work on the card (ms) and which side bounds it:
    bytes moved once over the memory rate, operations over the peak rate
    for the inputs' type."""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), \
        bytes_ms, ops_ms


def request_images(torch, towers, r):
    """Request r's per-tower pixel batches, the same in every phase."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1 + r)
    return [torch.randn((1, 3, t.image_size, t.image_size), generator=g, device="cuda")
            for t in towers]


def all_counters(fa, quant):
    from cambrian_tpu_torch.ops import dwconv, fused_mlp, norms, sva_attention

    return {"flash_attention_fwd": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd, "int8_matmul": quant.int8_matmul,
            "int4_matmul": quant.int4_matmul,
            "int4_matmul_scale_on_weights": quant.int4_matmul_scale_on_weights,
            "fused_windowed_cross_attention": sva_attention.fused_windowed_cross_attention,
            "fused_layer_norm": norms.fused_layer_norm,
            "depthwise_conv7x7": dwconv.depthwise_conv7x7,
            "fused_mlp": fused_mlp.fused_mlp}


def zero_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters):
    return {name: fn.launches for name, fn in counters.items()}


def kernel_name(mangled):
    """A K1/K2, quant-matmul or K8 GEMM kernel function's mangled name as
    ``name<template arguments>`` (integers, bf16 or float); other names as
    they are."""
    names = (K1_FUNCTIONS + K2_FUNCTIONS + QUANT_FUNCTIONS + MLP_FUNCTIONS + LN_FUNCTIONS
             + DW_FUNCTIONS + SVA_FUNCTIONS)
    m = re.search(rf"({'|'.join(names)})"
                  r"I((?:Li\d+E|13__nv_bfloat16|f)+)E", mangled)
    if m is None:
        return mangled
    args = [n or ("bf16" if bf16 else "float")
            for n, bf16, _ in re.findall(r"Li(\d+)E|(13__nv_bfloat16)|(f)", m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def tensor_core_instructions(path):
    """{kernel function: [HGMMA, HMMA, I2F]}: the tensor-core instructions and
    the int-to-float conversions (I2F, I2FP) of each kernel function of a
    built library, counted in ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out, name = {}, None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = kernel_name(line.split(":", 1)[1].strip())
            out[name] = [0, 0, 0]
        elif name is not None and "HGMMA" in line:
            out[name][0] += 1
        elif name is not None and "HMMA" in line:
            out[name][1] += 1
        elif name is not None and "I2F" in line:
            out[name][2] += 1
    return out


def resource_usage(path):
    """{kernel function: (registers, stack bytes, local bytes)} of a built
    library, from ``cuobjdump -res-usage`` (whether or not this run compiled
    it); spilled registers live in local memory."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-res-usage", path], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\w+):", line)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", line)
        if m and name is not None:
            out[name] = tuple(int(v) for v in m.groups())
    return out


def loop_instructions(path, op="LDG", innermost=False):
    """{kernel function: (instructions, instructions of ``op``)} of each
    function's main loop in ``cuobjdump -sass``: of the spans between a
    backward branch and its target, the one with the most ``op`` (by default
    global loads, LDG); of spans with as many, the longest, or with
    ``innermost`` the shortest (a loop nested in another)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = kernel_name(line.split(":", 1)[1].strip())
            funcs[name] = ([], {})
            continue
        if name is None:
            continue
        m = re.match(r"(\.L_x_\d+):", line)
        if m:
            funcs[name][1][m.group(1)] = len(funcs[name][0])
            continue
        m = re.match(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            funcs[name][0].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for fn, (ins, labels) in funcs.items():
        best = None
        for i, (addr, text) in enumerate(ins):
            b = re.search(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)", text)
            if not b:
                continue
            tgt = b.group(1)
            start = (labels.get(tgt) if tgt.startswith(".L") else
                     next((j for j, (a, _) in enumerate(ins) if a == int(tgt, 16)), None))
            if start is None or start > i:
                continue
            body = [t for _, t in ins[start:i + 1] if not t.startswith("NOP")]
            loads = sum(op in t for t in body)
            size = -len(body) if innermost else len(body)
            if best is None or (loads, size) > (best[1], -best[0] if innermost else best[0]):
                best = (len(body), loads)
        out[fn] = best
    return out


def register_use(log):
    """{kernel function: (registers, spill store bytes)} from ptxas' -v log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = (int(m.group(1)), out.get(name, (0, 0))[1])
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name is not None:
            out[name] = (out.get(name, (0, 0))[0], int(m.group(1)))
    return out


def build_prompts(cfg, rng, lengths=None):
    """Token ids with one image marker, packed as the model packs them:
    N_REQUESTS prompts of 24 + 4 r and 20 + 3 r ids around the marker, or,
    with ``lengths``, one of each (ids before, ids after) pair."""
    from cambrian_tpu_torch import IMAGE_TOKEN_INDEX, prepare_multimodal_data

    sizes = [(640, 480), (480, 640), (1024, 1024)]
    lengths = lengths or [(24 + 4 * r, 20 + 3 * r) for r in range(N_REQUESTS)]
    high = min(128000, cfg.vocab_size)
    prompts = []
    for r, (n_pre, n_post) in enumerate(lengths):
        pre = rng.integers(0, high, n_pre)
        post = rng.integers(0, high, n_post)
        ids = np.concatenate([[cfg.bos_token_id], pre, [IMAGE_TOKEN_INDEX], post])
        size = sizes[r % len(sizes)]
        packed = prepare_multimodal_data(
            ids[None], ids[None].copy(), np.ones((1, len(ids)), bool), [size],
            cfg.image_token_len, cfg.mm_vision_tower_aux_token_len_list,
            len(ids) + cfg.image_block_len - 1)
        prompts.append(dict(ids=ids, size=size, mask=packed[2][0]))
    return prompts


def kernel_phase(torch, fa, prompt):
    """K1 vs plain at the main path's shapes; returns per-case records."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    s = len(prompt["mask"])
    prefill_valid = torch.zeros(s + NEW_TOKENS, dtype=torch.bool)
    prefill_valid[:s] = torch.from_numpy(prompt["mask"])
    cases = [
        # name, b, s_q, s_k, h, kvh, d, causal, key_valid, per-request
        # launches (Cambrian-8B), sliding window
        ("siglip", 1, 729, 729, 16, 16, 72, False, None, 27, None),
        ("clip", 1, 577, 577, 16, 16, 64, False, None, 23, None),
        ("dinov2", 1, 730, 730, 24, 24, 64, False, None, 40, None),
        ("prefill_request0", 1, s, s + NEW_TOKENS, 32, 8, 128, True, prefill_valid[None], 32,
         None),
        ("prefill_640", 1, 640, 640 + NEW_TOKENS, 32, 8, 128, True,
         (torch.arange(640 + NEW_TOKENS) < 640)[None], 0, None),
        # Phi-3-mini's prefill of phase 11's long request: D = 96, the window
        # shorter than the prompt
        ("phi3_prefill", 1, PHI3_LONG_SLOTS, PHI3_LONG_SLOTS + NEW_TOKENS, 32, 32, 96, True,
         (torch.arange(PHI3_LONG_SLOTS + NEW_TOKENS) < PHI3_LONG_SLOTS)[None], 0, PHI3_WINDOW),
    ]
    dead = torch.ones((2, 340), dtype=torch.bool)
    dead[0, :50] = False      # causal rows 0..49 of batch 0 see no valid key
    dead[1] = False           # batch 1 sees none at all
    cases.append(("dead_rows", 2, 300, 340, 8, 2, 128, True, dead, 0, None))

    g = torch.Generator(device=dev).manual_seed(SEED)
    records = []
    for name, b, s_q, s_k, h, kvh, d, causal, valid, per_req, window in cases:
        if valid is not None:
            valid = valid.to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, s_q, h, d), generator=g, device=dev).to(dtype)
            k = torch.randn((b, s_k, kvh, d), generator=g, device=dev).to(dtype)
            v = torch.randn((b, s_k, kvh, d), generator=g, device=dev).to(dtype)
            out = fa.flash_attention(q, k, v, valid, causal, sliding_window=window)
            torch.cuda.synchronize()
            ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), valid, causal,
                                               sliding_window=window)
            err = float((out.float() - ref).abs().max())
            tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
            check(torch.isfinite(out).all().item(), f"{name} {dtype}: non-finite output")
            check(err <= tol, f"{name} {dtype}: max abs error {err} > {tol}")
            # the row statistic K1 writes for the backward: +inf on the same
            # (dead) rows; elsewhere the fp32 log-sum-exp of the same logits,
            # summed in another order (|lse| < 20 here)
            _, lse = fa._flash_fwd(q, k, v, valid, causal, window, 0, d ** -0.5, True)
            lse_ref = fa.flash_attention_lse_reference(q.float(), k.float(), valid, causal,
                                                       sliding_window=window)
            live = torch.isfinite(lse_ref)
            check(torch.equal(live, torch.isfinite(lse)) and bool((lse[~live] > 0).all()),
                  f"{name} {dtype}: the statistic's +inf rows differ from the plain version's")
            lse_err = float((lse - lse_ref)[live].abs().max()) if live.any() else 0.0
            check(lse_err <= 1e-3, f"{name} {dtype}: row statistic error {lse_err} > 1e-3")
            if name == "dead_rows":
                check((out[1] == 0).all().item() and (out[0, :50] == 0).all().item(),
                      "dead rows are not exactly 0")
            # each call alone behind a spin kernel: at the serving shapes the
            # wrapper's host work outlasts the kernel, so calls back to back
            # would time the host
            ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, valid, causal,
                                                           sliding_window=window),
                         spin=SITE_SPIN_CYCLES)
            plain_ms = cuda_ms(torch, lambda: fa.flash_attention_reference(
                q, k, v, valid, causal, sliding_window=window), spin=SITE_SPIN_CYCLES)
            dtype_name = str(dtype).replace("torch.", "")
            # the (query, key) pairs this case's mask lets through
            keep = torch.ones((b, s_q, s_k), dtype=torch.bool, device=dev)
            if valid is not None:
                keep &= valid[:, None, :]
            if causal:
                keep &= torch.ones((s_q, s_k), dtype=torch.bool, device=dev).tril()
            if window is not None:
                keep &= torch.ones((s_q, s_k), dtype=torch.bool, device=dev).triu(1 - window)
            pairs = int(keep.sum())
            n_bytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size() + (
                0 if valid is None else valid.numel())
            bound_ms, bound_by, bytes_ms, ops_ms = bound(n_bytes, 4 * h * d * pairs, dtype_name)
            library_ms = None
            if per_req or name.startswith("phi3"):
                # the library call on the same work: heads first, GQA expanded,
                # the mask dense
                qt = q.transpose(1, 2).contiguous()
                kt = k.repeat_interleave(h // kvh, 2).transpose(1, 2).contiguous()
                vt = v.repeat_interleave(h // kvh, 2).transpose(1, 2).contiguous()
                dense = None if valid is None and not causal else keep[:, None]
                library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=dense), spin=SITE_SPIN_CYCLES)
            rec = dict(case=name, dtype=dtype_name, b=b, s_q=s_q,
                       s_k=s_k, h=h, kvh=kvh, d=d, causal=causal, window=window, max_abs_err=err,
                       tol=tol, lse_err=lse_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by, bytes_ms=bytes_ms,
                       ops_ms=ops_ms, per_request=per_req,
                       tflops=4 * h * d * pairs / ms / 1e9)
            lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
            print(f"kernel {name:16s} {dtype_name:8s} Sq={s_q} Sk={s_k} H={h}/{kvh} D={d} "
                  + ("" if window is None else f"window={window} ") +
                  f"err={err:.3e} lse_err={lse_err:.1e} kernel={ms:.4f} ms "
                  f"({rec['tflops']:.2f} TFLOP/s) plain={plain_ms:.4f} ms sdpa={lib} "
                  f"bound={bound_ms * 1e3:.2f} us ({bound_by})", flush=True)
            records.append(rec)
    return records


def quant_kernel_phase(torch, quant, prompt_len, shapes=QUANT_SHAPES, names=tuple(QUANT_KERNELS),
                       dtypes=None, label="8B", slots=None):
    """K3, K4 and K4b/K4c (``names``) against their plain versions at the
    decoder's projection shapes (the 8B decoder's by default), bf16 and fp32
    (``dtypes``); with ``slots``, also bf16 at M = ``slots`` (the
    continuous-batching decode, on ``gemv_m8_kernel``) and at the further
    rows of GEMV_M8_EXTRA; returns per-case records."""
    dtypes = dtypes or (torch.bfloat16, torch.float32)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False     # plain fp32 products in fp32
    g = torch.Generator(device=dev).manual_seed(SEED)
    # evict the L2 cache (50 MB) by reading 64 MB: writing would leave dirty
    # lines whose write-back the next timed call would pay for
    l2 = torch.zeros(16 << 20, dtype=torch.float32, device=dev)
    flush = l2.sum
    records = []
    int8pack = None     # torch.ops.aten._weight_int8pack_mm, where this build runs it on CUDA
    profiled_cases = []  # (name, site, x, weights, scales, record) of each bf16 prefill and M = 1 call
    for site, k, n in shapes:
        w = (torch.randn((k, n), generator=g, device=dev) * 0.02).bfloat16()
        q8, s8 = quant.quantize_int8(w)
        q4, s4 = quant.quantize_int4(w)
        cases = {
            "int8_matmul": (quant.int8_matmul, quant.int8_matmul_reference, q8, s8,
                            quant.dequantize_int8),
            "int4_matmul": (quant.int4_matmul, quant.int4_matmul_reference, q4, s4,
                            quant.dequantize_int4),
            "int4_matmul_scale_on_weights": (
                quant.int4_matmul_scale_on_weights,
                lambda x, wq, sc: quant.int4_matmul_reference(x, wq, sc, scale_on_weights=True),
                q4, s4, quant.dequantize_int4),
        }
        cases = {name: cases[name] for name in names}
        prefill = {}     # name: (x, the record) of each bf16 prefill case
        decode = {}      # name: (x, the record) of each bf16 M = 1 case of K3, K4, K4b
        batched = []     # (name, x, the record) of each bf16 M = 2..8 case
        runs = [(m, dtype) for m in (1, prompt_len) for dtype in dtypes]
        if slots:
            runs += [(m, torch.bfloat16) for m in (slots,) + GEMV_M8_EXTRA.get(site, ())]
        for name, (fn, plain, wq, sc, dequant) in cases.items():
            for m, dtype in runs:
                dtype_name = str(dtype).replace("torch.", "")
                x = torch.randn((m, k), generator=g, device=dev).to(dtype)
                out = fn(x, wq, sc)
                torch.cuda.synchronize()
                ref = plain(x.float(), wq, sc)
                err = float((out.float() - ref).abs().max())
                # bf16: the output's rounding (2^-8 relative) plus, with the
                # scale on the weights, their bf16 rounding; fp32: sums
                rel = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
                tol = rel * max(1.0, float(ref.abs().max()))
                check(torch.isfinite(out).all().item(), f"{name} {site} M={m}: non-finite")
                check(out.shape == (m, n) and out.dtype == dtype,
                      f"{name} {site} M={m}: {tuple(out.shape)} {out.dtype}")
                check(err <= tol, f"{name} {site} M={m} {dtype_name}: "
                      f"max abs error {err} > {tol}")
                # the bf16 M = 1 GEMV of K3 and K4 (gemv_m1_kernel): medians of
                # GEMV_ITERS calls, beside the first port's gemv_kernel
                m1 = m == 1 and dtype == torch.bfloat16 and name in GEMV_M1_KERNELS
                # the continuous-batching decode's GEMV (gemv_m8_kernel), timed
                # as at M = 1
                m8 = slots is not None and 2 <= m <= 8 and dtype == torch.bfloat16
                iters = GEMV_ITERS if m1 or m8 else 10
                med = m1 or m8
                ms = cuda_ms(torch, lambda: fn(x, wq, sc), iters, flush, median=med)
                plain_ms = cuda_ms(torch, lambda: plain(x, wq, sc), iters, flush, median=med)
                w_deq = dequant(wq, sc, dtype)
                library_ms = cuda_ms(torch, lambda: torch.matmul(x, w_deq), iters, flush,
                                     median=med)
                del w_deq
                old_ms = None
                if m1 or m8:
                    # a fixed order of sums: two calls agree bit for bit
                    check(torch.equal(fn(x, wq, sc), out),
                          f"{name} {site} M={m}: two calls differ")
                    old = fn(x, wq, sc, _route="gemv_kernel")
                    torch.cuda.synchronize()
                    old_err = float((old.float() - ref).abs().max())
                    check(old_err <= tol, f"{name} {site} gemv_kernel: error {old_err} > {tol}")
                    old_ms = cuda_ms(torch, lambda: fn(x, wq, sc, _route="gemv_kernel"),
                                     iters, flush, median=True)
                int8pack_ms = None
                if name == "int8_matmul" and dtype == torch.bfloat16:
                    if int8pack is None:
                        try:
                            torch.ops.aten._weight_int8pack_mm(x, q8.T.contiguous(),
                                                               s8.to(dtype))
                            int8pack = True
                        except (RuntimeError, NotImplementedError) as e:
                            print(f"_weight_int8pack_mm on CUDA: none ({str(e)[:120]})",
                                  flush=True)
                            int8pack = False
                    if int8pack:
                        wt, st = q8.T.contiguous(), s8.to(dtype)
                        int8pack_ms = cuda_ms(torch, lambda: torch.ops.aten._weight_int8pack_mm(
                            x, wt, st), flush=flush)
                n_bytes = wq.numel() + sc.numel() * 4 + (m * k + m * n) * x.element_size()
                bound_ms, bound_by, bytes_ms, ops_ms = bound(n_bytes, 2 * m * n * k,
                                                             dtype_name)
                tflops = 2 * m * n * k / (ms * 1e9)
                rec = dict(kernel=name, site=site, m=m, k=k, n=n, dtype=dtype_name,
                           max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, library_int8pack_ms=int8pack_ms,
                           gemv_kernel_ms=old_ms, bound_ms=bound_ms, bound_by=bound_by,
                           bytes_ms=bytes_ms, ops_ms=ops_ms, tflops=tflops,
                           tbps=n_bytes / (ms * 1e9), function=None)
                print(f"kernel {name:29s} {site:9s} {dtype_name:8s} M={m:<4d} K={k:<5d} "
                      f"N={n:<5d} err={err:.3e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
                      f"matmul={library_ms:.4f} ms"
                      + ("" if int8pack_ms is None else f" int8pack={int8pack_ms:.4f} ms")
                      + f" bound={bound_ms * 1e3:.2f} us ({bound_by}) {tflops:.1f} TFLOP/s",
                      flush=True)
                records.append(rec)
                if m1:
                    print(f"gemv M=1 {name:12s} {site:9s} gemv_m1_kernel {ms * 1e3:.2f} us, "
                          f"gemv_kernel {old_ms * 1e3:.2f} us, matmul {library_ms * 1e3:.2f} "
                          f"us, bound {bound_ms * 1e3:.2f} us, {rec['tbps']:.3f} TB/s "
                          f"({bound_ms / ms:.1%} of bound), err {err:.3e} (tol {tol:.2e}); "
                          f"faster than gemv_kernel: {ms < old_ms}, no slower than "
                          f"matmul: {ms <= library_ms}", flush=True)
                    decode[name] = (x, rec)
                if m8:
                    print(f"gemv M={m} {name:12s} {site:9s} gemv_m8_kernel {ms * 1e3:.2f} us, "
                          f"gemv_kernel {old_ms * 1e3:.2f} us, matmul {library_ms * 1e3:.2f} "
                          f"us, plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us, "
                          f"{rec['tbps']:.3f} TB/s ({bound_ms / ms:.1%} of bound), err "
                          f"{err:.3e} (tol {tol:.2e}); faster than gemv_kernel: {ms < old_ms}, "
                          f"no slower than matmul: {ms <= library_ms}", flush=True)
                    batched.append((name, x, rec))
                if dtype == torch.bfloat16 and m == prompt_len:
                    prefill[name] = (x, rec)
        for name, x, rec in ([(n, x, r) for n, (x, r) in prefill.items()]
                             + [(n, x, r) for n, (x, r) in decode.items()] + batched):
            profiled_cases.append((name, site, x, cases[name][2], cases[name][3], rec))
        del w, prefill
    del l2
    quant_function_check(torch, quant, profiled_cases)
    del profiled_cases
    for name in (n for n in GEMV_M1_KERNELS if n in names):
        recs = [r for r in records if r["kernel"] == name and r["m"] == 1
                and r["gemv_kernel_ms"] is not None]
        step = {key: LAYERS * sum(r[key] for r in recs)
                for key in ("ms", "gemv_kernel_ms", "library_ms", "bound_ms")}
        print(f"gemv M=1 {name}: a {label} decode step (7 shapes x {LAYERS} layers) gemv_m1_kernel "
              f"{step['ms']:.3f} ms, gemv_kernel {step['gemv_kernel_ms']:.3f} ms, matmul "
              f"{step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms "
              f"({step['bound_ms'] / step['ms']:.1%} of bound)", flush=True)
        if slots:
            recs = [r for r in records if r["kernel"] == name and r["m"] == slots]
            step = {key: LAYERS * sum(r[key] for r in recs)
                    for key in ("ms", "gemv_kernel_ms", "plain_ms", "library_ms", "bound_ms")}
            print(f"gemv M={slots} {name}: a {label} continuous-batching decode step (7 shapes x "
                  f"{LAYERS} layers) gemv_m8_kernel {step['ms']:.3f} ms, gemv_kernel "
                  f"{step['gemv_kernel_ms']:.3f} ms, matmul {step['library_ms']:.3f} ms, plain "
                  f"{step['plain_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms "
                  f"({step['bound_ms'] / step['ms']:.1%} of bound); below gemv_kernel: "
                  f"{step['ms'] < step['gemv_kernel_ms']}, at or below matmul: "
                  f"{step['ms'] <= step['library_ms']}", flush=True)
    return records


def request_sum(records, key, kernel, prompt_len):
    """One 8B request's worth of a quant kernel's ``key`` (bf16): each
    projection once per layer at the prompt length and 31 times at M = 1."""
    total = 0.0
    calls = {prompt_len: 1, 1: NEW_TOKENS - 1}
    for r in records:
        if r["kernel"] == kernel and r["dtype"] == "bfloat16" and r[key] is not None:
            total += LAYERS * r[key] * calls.get(r["m"], 0)
    return total


def tiny_slice_phase(torch, fa, quant, rng, quantize=None, longrope=False):
    """Kernel path on the card (fp32, TF32 off) against plain on the CPU.
    ``longrope``: the tiny model as a Phi-3 with LongRoPE whose KV cache
    exceeds ``original_max_position_embeddings``, so the long factors apply."""
    from cambrian_tpu_torch import IMAGE_TOKEN_INDEX, tiny_debug
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict
    from cambrian_tpu_torch.models.language.llama import rope_scaling_factors

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_debug(num_towers=2).replace(tokenizer_model_max_length=192, quantize=quantize)
    if longrope:
        factors = np.random.default_rng(SEED + 4)
        d2 = cfg.head_dim // 2
        cfg = cfg.replace(model_type="phi3", original_max_position_embeddings=TINY_ROPE_ORIG,
                          rope_scaling={"type": "longrope",
                                        "short_factor": factors.uniform(1.0, 1.2, d2).tolist(),
                                        "long_factor": factors.uniform(2.0, 4.0, d2).tolist()})
    sd = random_state_dict(cfg, torch.Generator().manual_seed(SEED), 0.05,
                           dtype=torch.float32, device="cpu")
    cpu = CambrianForInference.from_state_dict(cfg, sd, torch.float32,
                                               cache_dtype=torch.float32)
    gpu = CambrianForInference.from_state_dict(
        cfg, {k: v.cuda() for k, v in sd.items()}, torch.float32, cache_dtype=torch.float32)
    ids = rng.integers(5, cfg.vocab_size, 140)
    ids[cfg.image_position] = IMAGE_TOKEN_INDEX
    images = [rng.standard_normal((1, 3, t.image_size, t.image_size)).astype(np.float32)
              for t in cpu.towers]
    kw = dict(images=images, image_sizes=[(640, 360)], max_new_tokens=8, eos_token_id=None)
    want = cpu.generate(ids, **kw)
    counters = all_counters(fa, quant)
    zero_counts(counters)
    got = gpu.generate(ids, **kw)
    counts = read_counts(counters)
    steps = gpu.engine.last_timings["decode_steps"]
    logit_err = float((gpu.engine.last_next_logits.cpu() - cpu.engine.last_next_logits)
                      .abs().max())
    label = "phi3 longrope" if longrope else quantize or "fp32"
    if longrope:
        k_len = len(ids) + cfg.image_block_len - 1 + 8      # the prompt's slots + 8 new
        ext, mscale = rope_scaling_factors(cfg, k_len)
        check(k_len > TINY_ROPE_ORIG and ext.tolist() == torch.tensor(
            cfg.rope_scaling["long_factor"]).tolist(),
            f"tiny slice ({label}): a {k_len}-slot cache did not take the long factors")
        print(f"tiny slice ({label}): {k_len}-slot cache past {TINY_ROPE_ORIG}: long factors, "
              f"mscale {mscale:.6f}", flush=True)
    print(f"tiny slice ({label}): cpu tokens {want.tolist()} gpu tokens {got.tolist()} "
          f"launches {counts} first-token logits max abs diff {logit_err:.3e}", flush=True)
    check(got.shape == (1, 8) and (got == want).all(), f"tiny slice ({label}) tokens differ")
    expected = {name: 0 for name in counters}
    expected["flash_attention_fwd"] = (sum(t.config.num_blocks_to_run for t in gpu.towers)
                                       + cfg.num_hidden_layers)
    if quantize:
        expected[f"{quantize}_matmul"] = 7 * cfg.num_hidden_layers * (1 + steps)
    check(counts == expected, f"tiny slice ({label}) launched {counts}, not {expected}")
    check(logit_err < 1e-3, f"tiny slice ({label}) logits differ by {logit_err}")
    window = None
    if quantize is None and not longrope:
        # a sliding window shorter than the prompt: generate and
        # generate_stream on the card retire the same cache slots, and give
        # the plain path's tokens on the CPU
        wcfg = cfg.replace(sliding_window=WINDOW)
        wcpu = CambrianForInference.from_state_dict(wcfg, sd, torch.float32,
                                                    cache_dtype=torch.float32)
        wgpu = CambrianForInference.from_state_dict(
            wcfg, {k: v.cuda() for k, v in sd.items()}, torch.float32, cache_dtype=torch.float32)
        wkw = dict(kw, max_new_tokens=WINDOW_TOKENS)
        w_cpu = wcpu.generate(ids, **wkw)
        w_gen = wgpu.generate(ids, **wkw)
        *_, w_stream = wgpu.generate_stream(ids, stream_chunk=4, **wkw)
        print(f"tiny slice, sliding window {WINDOW} ({len(ids)} prompt ids): generate "
              f"{w_gen.tolist()} generate_stream {w_stream.tolist()} cpu {w_cpu.tolist()}",
              flush=True)
        check(w_gen.shape == (1, WINDOW_TOKENS) and (w_gen == w_stream).all(),
              "tiny slice with a sliding window: generate and generate_stream differ")
        check((w_gen == w_cpu).all(), "tiny slice with a sliding window: card and CPU differ")
        window = dict(window=WINDOW, tokens=w_gen.tolist())
    continuous = None
    if not longrope:
        continuous = tiny_continuous(torch, cpu, gpu, ids, kw, rng, label, got)
    # the flags as this phase found them: the phases after it keep their
    # own fp32 products (the 8B LM head among them) in fp32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return dict(tokens=got.tolist(), launches=counts, logit_err=logit_err, window=window,
                continuous=continuous)


def tiny_continuous(torch, cpu, gpu, ids, kw, rng, label, sequential):
    """The continuous-batching engine on the card against the same engine on
    the CPU (fp32 caches): the image request beside two text requests on 2
    slots, chunks of 4, so that a slot is re-admitted while the other
    decodes; the greedy tokens must be identical."""
    from cambrian_tpu_torch.infer.continuous import ContinuousBatchingEngine
    from cambrian_tpu_torch.infer.engine import GenerationConfig

    texts = [rng.integers(5, cpu.config.vocab_size, n) for n in (20, 33)]
    out = {}
    for where, model in (("cpu", cpu), ("gpu", gpu)):
        eng = ContinuousBatchingEngine(model.lm, num_slots=2,
                                       max_len=cpu.config.tokenizer_model_max_length + 64,
                                       cache_dtype=torch.float32)
        pids, pmask, ppos, feats, aux_masks, cfg, _ = model._prepare_generate(ids, **kw)
        reqs = [eng.submit(pids[0], pmask[0], ppos[0], feats, aux_masks, cfg)]
        for i, t in enumerate(texts):
            reqs.append(eng.submit(t, np.ones(len(t), bool), np.arange(len(t)),
                                   config=GenerationConfig(max_new_tokens=10 + 2 * i)))
        out[where] = [o.tolist() for o in eng.run_until_complete(reqs, chunk=4)]
    same_as_generate = out["gpu"][0] == sequential[0].tolist()
    print(f"tiny slice ({label}), continuous batching: cpu {out['cpu']} gpu {out['gpu']}; the "
          f"image request equals generate's tokens: {same_as_generate}", flush=True)
    check(out["gpu"] == out["cpu"], f"tiny slice ({label}): continuous batching on the card "
          f"and on the CPU differ")
    check([len(t) for t in out["gpu"]] == [8, 10, 12],
          f"tiny slice ({label}), continuous batching: lengths {[len(t) for t in out['gpu']]}")
    return dict(tokens=out["gpu"], same_as_generate=same_as_generate)


def serve_request(torch, model, counters, cfg, r, pr, stream=False, k1=LAUNCHES_PER_REQUEST):
    """One request through ``generate`` (or ``generate_stream``) with its
    checks (``k1``: K1's launches it must make); returns its record and the
    kernel launches it made."""
    images = request_images(torch, model.towers, r)
    before = read_counts(counters)
    t0 = time.perf_counter()
    kw = dict(images=images, image_sizes=[pr["size"]], max_new_tokens=NEW_TOKENS,
              eos_token_id=None)
    if stream:
        yields = 0
        for out in model.generate_stream(pr["ids"], stream_chunk=STREAM_CHUNK, **kw):
            yields += 1
        check(yields == NEW_TOKENS // STREAM_CHUNK, f"stream request {r}: {yields} yields")
    else:
        out = model.generate(pr["ids"], **kw)
    wall_ms = (time.perf_counter() - t0) * 1e3
    after = read_counts(counters)
    delta = {k: after[k] - before[k] for k in after}
    tm = dict(model.engine.last_timings)
    logits = model.engine.last_next_logits
    label = f"{'stream ' if stream else ''}request {r}"
    check(out.shape == (1, NEW_TOKENS), f"{label}: output shape {out.shape}")
    check(((out >= 0) & (out < cfg.vocab_size)).all(), f"{label}: token out of range")
    check(tuple(logits.shape) == (1, cfg.vocab_size) and logits.dtype == torch.float32,
          f"{label}: logits {tuple(logits.shape)} {logits.dtype}")
    check(torch.isfinite(logits).all().item(), f"{label}: non-finite logits")
    check(delta["flash_attention_fwd"] == k1,
          f"{label}: K1 launched {delta['flash_attention_fwd']}x, not {k1}x")
    tok_s = tm["decode_steps"] / tm["decode_ms"] * 1e3
    rec = dict(request=r, stream=stream, prompt_slots=len(pr["mask"]), image_size=pr["size"],
               encode_ms=tm["encode_ms"], prefill_ms=tm["prefill_ms"],
               decode_ms=tm["decode_ms"], decode_steps=tm["decode_steps"],
               decode_tokens_per_s=tok_s, wall_ms=wall_ms, launches=delta,
               tokens=out[0].tolist())
    print(f"{label}: slots={rec['prompt_slots']} encode={tm['encode_ms']:.1f} ms "
          f"prefill={tm['prefill_ms']:.1f} ms decode={tok_s:.2f} tok/s "
          f"({tm['decode_steps']} steps in {tm['decode_ms']:.1f} ms) "
          f"launches={ {k: v for k, v in delta.items() if v} }", flush=True)
    return rec


def full_width_phase(torch, fa, quant, prompts, quantize=None, sites=None, then=None):
    """Cambrian-8B through the user entry points, bf16 or quantized. With
    ``sites`` (a dict), one more warm request (request 0's prompt and image,
    2 new tokens) runs after the counted ones with ``capture_sites``' hooks,
    and the captured drop-in sites of K5-K8 are put into ``sites``. ``then``
    (model, counters, cfg) runs last on the live model; its result is the
    record's ``then``."""
    from cambrian_tpu_torch import cambrian_8b
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict

    dev = torch.device("cuda")
    cfg = cambrian_8b().replace(quantize=quantize)
    label = quantize or "bf16"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    sd = random_state_dict(cfg, g, 0.02, dtype=torch.bfloat16, device=dev)
    model = CambrianForInference.from_state_dict(cfg, sd, torch.bfloat16)
    del sd
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.lm.parameters()) + sum(
        p.numel() for t in model.towers for p in t.parameters())
    weight_bytes = sum(t.numel() * t.element_size() for m in [model.lm, *model.towers]
                       for t in [*m.parameters(), *m.buffers()])
    print(f"8B {label} build: {n_params / 1e9:.3f}B float parameters, "
          f"{weight_bytes / 1e9:.2f} GB of weights in {time.perf_counter() - t0:.1f} s",
          flush=True)

    counters = all_counters(fa, quant)
    requests = []
    zero_counts(counters)                    # the main path's count starts here
    if quantize is None:
        for r, pr in enumerate(prompts):
            requests.append(serve_request(torch, model, counters, cfg, r, pr))
    else:
        kernel = f"{quantize}_matmul"
        for r, pr in enumerate(prompts[:2]):
            rec = serve_request(torch, model, counters, cfg, r, pr)
            check(rec["launches"][kernel] == QUANT_LAUNCHES,
                  f"{label} request {r}: {kernel} launched {rec['launches'][kernel]}x, "
                  f"not {QUANT_LAUNCHES}x")
            requests.append(rec)
        rec = serve_request(torch, model, counters, cfg, 0, prompts[0], stream=True)
        want = QUANT_PER_STEP * (1 + rec["decode_steps"])
        check(rec["decode_steps"] == NEW_TOKENS, f"{label} stream: {rec['decode_steps']} steps")
        check(rec["launches"][kernel] == want,
              f"{label} stream: {kernel} launched {rec['launches'][kernel]}x, not {want}x")
        check(rec["tokens"] == requests[0]["tokens"],
              f"{label} stream tokens differ from generate's on the same prompt")
        requests.append(rec)
        if quantize == "int4":
            routes = quant.int4_matmul_scale_on_weights.function_launches
            routes.clear()
            os.environ["CAMBRIAN_INT4_V2"] = "1"
            try:
                rec = serve_request(torch, model, counters, cfg, 1, prompts[1])
            finally:
                del os.environ["CAMBRIAN_INT4_V2"]
            got = (rec["launches"]["int4_matmul_scale_on_weights"], rec["launches"]["int4_matmul"])
            check(got == (QUANT_LAUNCHES, 0),
                  f"int4 scale-on-weights request: launches {got}, not ({QUANT_LAUNCHES}, 0)")
            # the prefill on the GEMM, every decode step on gemv_m1_kernel<2>
            want = {"gemm": QUANT_PER_STEP, "gemv_m1_kernel": QUANT_PER_STEP * (NEW_TOKENS - 1)}
            check(routes == want, f"int4 scale-on-weights request: routes {routes}, not {want}")
            rec["functions"] = dict(routes)
            rec["scale_on_weights"] = True
            requests.append(rec)
    launches = read_counts(counters)
    unused = {k: launches[k] for k in VISION_KERNELS if launches[k]}
    check(not unused, f"8B {label}: the main path launched K5-K8 {unused}")
    peak = torch.cuda.max_memory_allocated()
    print(f"8B {label} peak memory allocated: {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)",
          flush=True)
    head = fp32_head_times(torch, model, len(prompts[0]["mask"])) if quantize is None else None
    t12 = time.perf_counter()
    continuous = continuous_phase(torch, quant, model, counters, cfg, prompts, requests,
                                  quantize)
    print(f"phase 12 ({label}): {time.perf_counter() - t12:.1f} s", flush=True)
    http = http_phase(torch, model, counters, cfg) if quantize is None else None
    if sites is not None:
        pr = prompts[0]
        t0 = time.perf_counter()
        sites.update(capture_sites(torch, [model.lm, *model.towers], lambda: model.generate(
            pr["ids"], images=request_images(torch, model.towers, 0), image_sizes=[pr["size"]],
            max_new_tokens=2, eos_token_id=None)))
        per_request = {kind: sum(x["count"] for x in found.values())
                       for kind, found in sites.items()}
        pairs = sum(x["count"] for k, x in sites["fused_mlp"].items() if k[0] == "convnext")
        print(f"8B {label}: K5-K8 drop-in sites of one request captured in "
              f"{time.perf_counter() - t0:.1f} s: {per_request} "
              f"({ {kind: len(found) for kind, found in sites.items()} } shapes)", flush=True)
        # ConvNeXt-XXL has 3 + 4 + 30 + 3 blocks; SVA attention runs in the 3
        # connector layers and the 10 in-decoder injections
        check(per_request["depthwise_conv7x7"] == 40 and pairs == 40,
              f"8B sites: {per_request['depthwise_conv7x7']} dwconv, {pairs} ConvNeXt MLP pairs")
        check(per_request["fused_windowed_cross_attention"] == 13,
              f"8B sites: {per_request['fused_windowed_cross_attention']} SVA attention calls")
    after = then(model, counters, cfg) if then is not None else None
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(requests=requests, launches=launches, n_params=n_params,
                weight_bytes=weight_bytes, peak_bytes=peak, continuous=continuous, http=http,
                head=head, then=after)


def fp32_head_times(torch, model, rows):
    """The 8B fp32 LM head's device time (medians of 10) at the prefill's
    ``rows`` and at a decode step, in fp32 (as phases 5, 6 and 12 run it) and
    in TF32 (as phases 5 and 6 ran it while phase 4 left TF32 on)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    try:
        with torch.inference_mode():
            for m in (rows, 1):
                h = torch.randn((1, m, model.config.hidden_size), generator=g,
                                device="cuda").bfloat16()
                for mode in (False, True):
                    torch.backends.cuda.matmul.allow_tf32 = mode
                    out[f"{m}_{'tf32' if mode else 'fp32'}"] = cuda_ms(
                        torch, lambda: model.lm.logits(h), 10, median=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"8B fp32 LM head (ms, medians of 10): {rows} rows fp32 {out[f'{rows}_fp32']:.3f}, "
          f"TF32 {out[f'{rows}_tf32']:.3f}; 1 row fp32 {out['1_fp32']:.3f}, TF32 "
          f"{out['1_tf32']:.3f}", flush=True)
    return out


def cb_first_tokens(torch, model, prompts, sequential):
    """Each prompt's sequential greedy tokens (``generate``, 32 new): phase
    5's or 6's where it ran the prompt, else one request run here."""
    seq = {}
    for rec in sequential:
        if not rec["stream"] and not rec.get("scale_on_weights"):
            seq.setdefault(rec["request"], rec["tokens"])
    for r, pr in enumerate(prompts):
        if r not in seq:
            seq[r] = model.generate(pr["ids"], images=request_images(torch, model.towers, r),
                                    image_sizes=[pr["size"]], max_new_tokens=NEW_TOKENS,
                                    eos_token_id=None)[0].tolist()
    return seq


def text_requests(engine, cfg, rng, n, tokens):
    """``n`` text-only requests of CB_TEXT_LEN random ids, ``tokens`` greedy
    tokens each."""
    from cambrian_tpu_torch.infer.engine import GenerationConfig

    out = []
    for _ in range(n):
        ids = np.concatenate([[cfg.bos_token_id],
                              rng.integers(0, min(128000, cfg.vocab_size), CB_TEXT_LEN - 1)])
        out.append(engine.submit(ids, np.ones(len(ids), bool), np.arange(len(ids)),
                                 config=GenerationConfig(max_new_tokens=tokens)))
    return out


def continuous_phase(torch, quant, model, counters, cfg, prompts, sequential, quantize):
    """Phase 12: ``ContinuousBatchingEngine`` on the live 8B model with the
    worker's defaults (CB_SLOTS slots, max_len = context_len + 1024, bf16
    cache, chunks of CB_CHUNK): the 8 requests of CB_BUDGETS, each encoded
    through ``_prepare_generate`` and all submitted at once, driven by
    ``step_chunk`` until every one has finished; every chunk's steps run
    under ``torch.cuda.set_sync_debug_mode("error")``. Then CB_SLOTS text
    requests whose second chunk runs under ``torch.profiler``, and, with
    int4, CB_SLOTS more under ``CAMBRIAN_INT4_V2=1`` (K4b at M = CB_SLOTS).
    Returns the records; ``launches`` are the phase's counts."""
    from torch.profiler import ProfilerActivity, profile

    from cambrian_tpu_torch.infer.continuous import ContinuousBatchingEngine

    label = quantize or "bf16"
    kernel = f"{quantize}_matmul" if quantize else None
    engine = ContinuousBatchingEngine(model.lm, num_slots=CB_SLOTS,
                                      max_len=cfg.tokenizer_model_max_length + CB_EXTRA_LEN)
    check(engine.cache[0][0].dtype == torch.bfloat16 and engine.device.type == "cuda",
          f"phase 12 ({label}): cache {engine.cache[0][0].dtype} on {engine.device}")
    seq = cb_first_tokens(torch, model, prompts, sequential)
    eos_seq = seq[CB_EOS_REQUEST % len(prompts)]
    k = next(i for i in range(1, NEW_TOKENS) if eos_seq[i] not in eos_seq[:i] and i % CB_CHUNK)
    eos = eos_seq[k]

    # every chunk's steps with host syncs made errors
    decode_steps = 0
    decode_chunk = engine._decode_chunk

    def checked_chunk(chunk, *args):
        nonlocal decode_steps
        decode_steps += chunk
        torch.cuda.set_sync_debug_mode("error")
        try:
            return decode_chunk(chunk, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    engine._decode_chunk = checked_chunk
    routes = {name: getattr(quant, name).function_launches for name in QUANT_KERNELS}
    for r in routes.values():
        r.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)                    # the phase's count starts here
    prepared = []
    for r, budget in enumerate(CB_BUDGETS):
        pr = prompts[r % len(prompts)]
        pids, pmask, ppos, feats, aux_masks, gcfg, _ = model._prepare_generate(
            pr["ids"], images=request_images(torch, model.towers, r % len(prompts)),
            image_sizes=[pr["size"]], max_new_tokens=budget,
            eos_token_id=eos if r == CB_EOS_REQUEST else None)
        prepared.append((pids[0], pmask[0], ppos[0], feats, aux_masks, gcfg))
    first = {}
    t_submit = time.perf_counter()
    reqs = [engine.submit(*args, on_token=lambda tok, r=r: first.setdefault(
        r, time.perf_counter())) for r, args in enumerate(prepared)]
    chunks = []
    while not all(q.finished for q in reqs):
        pending = engine._pending.qsize()
        before = sum(len(q.tokens) for q in reqs)
        t0 = time.perf_counter()
        active = engine.step_chunk(CB_CHUNK)
        chunks.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                           admitted=pending - engine._pending.qsize(),
                           tokens=sum(len(q.tokens) for q in reqs) - before, active=active))
    wall_ms = (time.perf_counter() - t_submit) * 1e3
    main_steps = decode_steps
    main = read_counts(counters)
    main_routes = {name: dict(r) for name, r in routes.items()}
    peak = torch.cuda.max_memory_allocated()

    n_tokens = sum(len(q.tokens) for q in reqs)
    records = []
    for r, q in enumerate(reqs):
        ref = seq[r % len(prompts)]
        budget = CB_BUDGETS[r]
        stopped = r == CB_EOS_REQUEST and q.tokens[-1] == eos
        check(q.finished and (len(q.tokens) == budget or (stopped and len(q.tokens) <= budget)),
              f"phase 12 ({label}) request {r}: {len(q.tokens)} tokens, budget {budget}")
        check(all(0 <= t < cfg.vocab_size for t in q.tokens),
              f"phase 12 ({label}) request {r}: a token out of range")
        check(q.tokens[0] == ref[0], f"phase 12 ({label}) request {r}: first token "
              f"{q.tokens[0]}, sequential generate's {ref[0]}")
        n = min(len(q.tokens), len(ref))
        agree = sum(a == b for a, b in zip(q.tokens[:n], ref[:n])) / n
        records.append(dict(request=r, prompt=r % len(prompts), budget=budget,
                            tokens=list(q.tokens), agree=agree, eos=stopped,
                            ttft_ms=(first[r] - t_submit) * 1e3))
        print(f"phase 12 ({label}) request {r}: prompt {r % len(prompts)}, {len(q.tokens)} of "
              f"{budget} tokens{' (stopped at its EOS)' if stopped else ''}, time to first "
              f"token {records[-1]['ttft_ms']:.1f} ms, {agree:.1%} of tokens agree with "
              f"sequential generate", flush=True)
    eos_rec = records[CB_EOS_REQUEST]
    print(f"phase 12 ({label}): the EOS request's stop token {eos} is token {k} of its "
          f"prompt's sequential output (inside chunk {k // CB_CHUNK}); it stopped at its EOS: "
          f"{eos_rec['eos']} after {len(eos_rec['tokens'])} tokens", flush=True)

    k1 = len(CB_BUDGETS) * LAUNCHES_PER_REQUEST      # 90 per encode + 32 per admission
    check(main["flash_attention_fwd"] == k1,
          f"phase 12 ({label}): K1 launched {main['flash_attention_fwd']}x, not {k1}x")
    unused = {name: main[name] for name in VISION_KERNELS if main[name]}
    check(not unused, f"phase 12 ({label}): launched K5-K8 {unused}")
    if kernel:
        want = {"gemm": QUANT_PER_STEP * len(CB_BUDGETS),
                "gemv_m8_kernel": QUANT_PER_STEP * main_steps}
        check(main_routes[kernel] == want and main[kernel] == sum(want.values()),
              f"phase 12 ({label}): {kernel} routes {main_routes[kernel]} ({main[kernel]} "
              f"launches), not {want}")
    decode = [c for c in chunks if not c["admitted"] and c["tokens"]]
    decode_tok_s = sum(c["tokens"] for c in decode) / sum(c["ms"] for c in decode) * 1e3
    tok_s = n_tokens / wall_ms * 1e3
    seq_tok_s = [rec["decode_tokens_per_s"] for rec in sequential]
    print(f"phase 12 ({label}): {len(CB_BUDGETS)} requests, {n_tokens} tokens in {wall_ms:.1f} ms "
          f"({len(chunks)} chunks, {main_steps} decode steps): {tok_s:.2f} tokens/s across "
          f"slots, {decode_tok_s:.2f} in the {len(decode)} chunks without an admission; "
          f"sequential generate on the same prompts {min(seq_tok_s):.2f}-{max(seq_tok_s):.2f} "
          f"tokens/s (phase {5 if quantize is None else 6}); wall ms a chunk "
          f"{[round(c['ms'], 1) for c in chunks]} (admissions {[c['admitted'] for c in chunks]}); "
          f"peak memory {peak / 2**30:.2f} GiB; no host sync inside a chunk", flush=True)

    rng = np.random.default_rng(SEED + 12)
    mode = list(QUANT_KERNELS).index(kernel) if kernel else None
    want_gemv = {"gemv_m8_kernel": QUANT_PER_STEP * CB_CHUNK}
    # one profiled chunk, all decode, every projection at M = CB_SLOTS: the
    # first chunk of CB_SLOTS text requests admits them, the second runs
    # profiled. A trace can hold no kernel, or lose a few of a chunk's
    # thousands (one of 1,792 gemv_m8_kernel launches, while the route
    # counter saw them all): then the pass is profiled again, on fresh
    # requests, three times in all. The counter must hold the chunk's every
    # launch each time; the trace must name them all in one pass.
    for attempt in range(1, 4):
        extra = text_requests(engine, cfg, rng, CB_SLOTS, CB_TEXT_TOKENS)
        engine.step_chunk(CB_CHUNK)
        for r in routes.values():
            r.clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            engine.step_chunk(CB_CHUNK)
            torch.cuda.synchronize()
        check(all(q.finished and len(q.tokens) == CB_TEXT_TOKENS for q in extra),
              f"phase 12 ({label}): the profiled pass gave "
              f"{[len(q.tokens) for q in extra]} tokens")
        events = kernel_events(prof)
        fns = {}
        for _, n, key in events:
            for fn in quant_functions([key]):
                fns[fn] = fns.get(fn, 0) + n
        if kernel:
            counted = dict(routes[kernel])
            check(counted == want_gemv, f"phase 12 ({label}): the profiled chunk's {kernel} "
                  f"routes {counted}, not {want_gemv}")
        if not events:
            print(f"profiler: trace {attempt} of 3 holds no kernel", flush=True)
            continue
        if not kernel:
            break
        # gemv_m8_kernel<mode, CB_SLOTS, W> alone (W by each projection's plan)
        gemv = {f: n for f, n in fns.items()
                if f.startswith(f"gemv_m8_kernel<{mode},{quant._gemv_rows(CB_SLOTS)},")}
        check(set(fns) == set(gemv), f"phase 12 ({label}): the profiled chunk ran {fns}, "
              f"not gemv_m8_kernel<{mode},{CB_SLOTS},.> alone")
        named = sum(gemv.values())
        check(named <= want_gemv["gemv_m8_kernel"], f"phase 12 ({label}): the profiled chunk "
              f"names {named} launches, more than the counter's {counted}")
        if named == want_gemv["gemv_m8_kernel"]:
            break
        print(f"profiler: trace {attempt} of 3 names {named} of the chunk's "
              f"{want_gemv['gemv_m8_kernel']} counted gemv_m8_kernel launches", flush=True)
    else:
        check(False, f"phase 12 ({label}): three profiled chunks came back without a kernel "
              f"or short of the counted launches (the last: {fns})")
    busy_ms = sum(us for us, _, _ in events) / 1e3
    top = [(round(us / 1e3, 3), n, key[:70]) for us, n, key in events[:8]]
    print(f"phase 12 ({label}) profiled decode chunk ({CB_CHUNK} steps): {busy_ms:.2f} ms "
          f"of kernel time ({busy_ms / CB_CHUNK:.2f} a step); quant functions {fns}; the "
          f"longest kernels (ms, launches, name): {top}", flush=True)
    if quantize == "int4":
        os.environ["CAMBRIAN_INT4_V2"] = "1"
        try:
            routes["int4_matmul_scale_on_weights"].clear()
            v2 = text_requests(engine, cfg, rng, CB_SLOTS, CB_CHUNK)
            engine.run_until_complete(v2, chunk=CB_CHUNK)
        finally:
            del os.environ["CAMBRIAN_INT4_V2"]
        want = {"gemm": QUANT_PER_STEP * CB_SLOTS, "gemv_m8_kernel": QUANT_PER_STEP * CB_CHUNK}
        got = dict(routes["int4_matmul_scale_on_weights"])
        check(got == want, f"phase 12 (int4, CAMBRIAN_INT4_V2=1): routes {got}, not {want}")
        main_routes["int4_matmul_scale_on_weights"] = got
    launches = read_counts(counters)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return dict(requests=records, chunks=chunks, wall_ms=wall_ms, tokens=n_tokens,
                tokens_per_s=tok_s, decode_tokens_per_s=decode_tok_s,
                decode_steps=main_steps, peak_bytes=peak, main_launches=main,
                routes=main_routes, launches=launches, profiled_kernel_ms=busy_ms,
                profiled_functions=fns)


class StandInTokenizer:
    """A numpy stand-in for the 8B tokenizer, which the card machine lacks:
    each whitespace-separated word becomes one of ``words`` ids from
    ``first_word``, from its bytes; ``decode`` writes each id as a word, and
    skips ids from ``special_from`` (the 8B's special ids) when told to. No
    EOS, so a stream runs its whole budget."""
    eos_token_id = None

    def __init__(self, bos_token_id=128000, first_word=100, words=100000, special_from=None):
        self.bos_token_id = bos_token_id
        self.first_word, self.words = first_word, words
        self.special_from = bos_token_id if special_from is None else special_from

    def __call__(self, text):
        from types import SimpleNamespace

        ids = [self.bos_token_id]
        for word in text.split():
            b = np.frombuffer(word.encode(), np.uint8).astype(np.int64)
            ids.append(int((b * (np.arange(len(b)) + 1) * 131).sum() % self.words)
                       + self.first_word)
        return SimpleNamespace(input_ids=ids)

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f" w{int(i)}" for i in ids
                       if not (skip_special_tokens and int(i) >= self.special_from))

    def batch_decode(self, rows, skip_special_tokens=True):
        return [self.decode(r, skip_special_tokens) for r in rows]


def http_stream(url, payload, timeout):
    """POST ``payload`` and read the \0-framed JSON chunks of the reply, by
    ``requests`` where it imports, else by ``urllib.request``."""
    try:
        import requests
    except ImportError:
        requests = None
    if requests is not None:
        r = requests.post(url, json=payload, stream=True, timeout=timeout)
        raw = b"\0".join(r.iter_lines(decode_unicode=False, delimiter=b"\0"))
    else:
        import urllib.request

        req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
    return [json.loads(c) for c in raw.split(b"\0") if c]


def http_phase(torch, model, counters, cfg):
    """The port's ``ModelWorker`` (continuous batching, the worker's
    defaults) on the live bf16 8B model on localhost, with the stand-in
    tokenizer: HTTP_STREAMS concurrent text-only streams of HTTP_TOKENS
    greedy tokens through ``/worker_generate_stream``; every chunk must have
    error code 0 and each stream its whole budget. The server and the
    worker's stepper thread stop before the model is freed."""
    import socket
    import threading

    from cambrian_tpu_torch.serve.model_worker import ModelWorker, serve

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    addr = f"http://localhost:{port}"
    bundle = (StandInTokenizer(), model, [t.image_processor for t in model.towers],
              cfg.tokenizer_model_max_length)
    worker = ModelWorker("http://unused", addr, "w0", "cambrian-8b", None, "cambrian-8b",
                         register=False, model_bundle=bundle, continuous_batching=True,
                         num_slots=CB_SLOTS, cb_chunk=CB_CHUNK)
    server = serve(worker, "localhost", port)
    animals = ["cat", "dog", "heron", "otter"]
    out = {}

    def stream(i):
        prompt = (f"USER: describe a {animals[i % len(animals)]} that sits by the river at "
                  f"dusk in a few words ASSISTANT:")
        try:
            out[i] = (prompt, http_stream(addr + "/worker_generate_stream", {
                "model": "cambrian-8b", "prompt": prompt, "temperature": 0.0,
                "max_new_tokens": HTTP_TOKENS}, timeout=300))
        except Exception as e:  # reported by the check below
            out[i] = (prompt, e)

    zero_counts(counters)
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=stream, args=(i,)) for i in range(HTTP_STREAMS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=400)
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        server.shutdown()
        server.server_close()
        worker.close()
    launches = read_counts(counters)
    try:
        import requests  # noqa: F401
        client = "requests"
    except ImportError:
        client = "urllib.request"
    check(sorted(out) == list(range(HTTP_STREAMS)), f"HTTP: streams {sorted(out)} returned")
    for i, (prompt, chunks) in sorted(out.items()):
        check(not isinstance(chunks, Exception), f"HTTP stream {i}: {chunks!r}")
        check(chunks and all(c["error_code"] == 0 for c in chunks),
              f"HTTP stream {i}: {chunks[-1:]}")
        check(len(chunks) == HTTP_TOKENS and chunks[-1]["text"].startswith(prompt),
              f"HTTP stream {i}: {len(chunks)} chunks, not {HTTP_TOKENS}")
    print(f"HTTP ({client}): {HTTP_STREAMS} concurrent streams of {HTTP_TOKENS} tokens through "
          f"the port's worker (continuous batching, {CB_SLOTS} slots) in {wall_ms:.1f} ms; "
          f"launches { {k: v for k, v in launches.items() if v} }; stream 0 ends "
          f"{out[0][1][-1]['text'][-60:]!r}", flush=True)
    return dict(streams=HTTP_STREAMS, tokens=HTTP_TOKENS, wall_ms=wall_ms, client=client,
                launches=launches)


# the port's tower parameter names -> the upstream snapshots' (the inverse of
# checkpoint/hf_vision.py): HF naming for the ViT blocks, open_clip's timm
# naming for the ConvNeXt blocks
VIT_BLOCK = [("norm1", "layer_norm1"), ("norm2", "layer_norm2"),
             ("attn.out_proj", "self_attn.out_proj"), ("attn.", "self_attn."), ("mlp.", "mlp.")]
DINO_BLOCK = [("attn.q_proj", "attention.attention.query"),
              ("attn.k_proj", "attention.attention.key"),
              ("attn.v_proj", "attention.attention.value"),
              ("attn.out_proj", "attention.output.dense"), ("ls1_gamma", "layer_scale1.lambda1"),
              ("ls2_gamma", "layer_scale2.lambda1"), ("norm1", "norm1"), ("norm2", "norm2"),
              ("mlp.", "mlp.")]
CONVNEXT_BLOCK = [("dwconv", "conv_dw"), ("norm", "norm"), ("pwconv1", "mlp.fc1"),
                  ("pwconv2", "mlp.fc2"), ("gamma", "gamma")]
DINOV2_NATIVE_SIDE = 37        # facebook/dinov2-giant's grid at 518 px


def _renamed(rest, table):
    for a, b in table:
        if rest.startswith(a):
            return b + rest[len(a):]
    raise KeyError(rest)


def tower_snapshot(torch, tower, sd, g):
    """An upstream snapshot {name: bf16 tensor} of a production tower with
    the weights ``sd`` (its ``module.*`` state dict) at the upstream depth
    (CLIP: 24 layers and the final norm, where the tower runs 23) and
    resolution (DINOv2: a fresh 37 x 37 position table from ``g``, which the
    loader resamples to the tower's 27 x 27): SigLIP, CLIP and DINOv2 in HF
    naming, ConvNeXt in open_clip's timm naming."""
    name, c = tower.name.lower(), tower.config
    dev = next(iter(sd.values())).device
    blocks, out = {}, {}
    for k, v in sd.items():
        m = re.fullmatch(r"module\.blocks_(\d+)\.(.+)", k)
        if m:
            blocks.setdefault(int(m[1]), {})[m[2]] = v
    if "convnext" in name:
        for k, v in sd.items():
            k = k[len("module.trunk."):]
            block = re.fullmatch(r"stage_(\d+)_block_(\d+)\.(.+)", k)
            down = re.fullmatch(r"downsample_(norm|conv)_(\d+)\.(.+)", k)
            if block:
                k = f"stages.{block[1]}.blocks.{block[2]}.{_renamed(block[3], CONVNEXT_BLOCK)}"
            elif down:
                k = f"stages.{down[2]}.downsample.{0 if down[1] == 'norm' else 1}.{down[3]}"
            else:
                k = k.replace("stem_conv.", "stem.0.").replace("stem_norm.", "stem.1.")
            out["visual.trunk." + k] = v
    elif "dinov2" in name:
        n_pos = 1 + DINOV2_NATIVE_SIDE ** 2
        out["embeddings.cls_token"] = sd["module.cls_token"]
        out["embeddings.mask_token"] = torch.zeros((1, c.hidden_size), device=dev)
        out["embeddings.position_embeddings"] = torch.randn(
            (1, n_pos, c.hidden_size), generator=g, device=dev) * 0.02
        for leaf in ("weight", "bias"):
            out[f"embeddings.patch_embeddings.projection.{leaf}"] = sd[f"module.patch_embed.{leaf}"]
            out[f"layernorm.{leaf}"] = sd[f"module.final_layernorm.{leaf}"]
        for i, blk in blocks.items():
            out.update({f"encoder.layer.{i}.{_renamed(k, DINO_BLOCK)}": v for k, v in blk.items()})
    else:
        p = "vision_model."
        out[p + "embeddings.patch_embedding.weight"] = sd["module.patch_embed.weight"]
        if c.patch_bias:
            out[p + "embeddings.patch_embedding.bias"] = sd["module.patch_embed.bias"]
        out[p + "embeddings.position_embedding.weight"] = sd["module.pos_embed"]
        if c.class_token:
            out[p + "embeddings.class_embedding"] = sd["module.cls_token"].reshape(-1)
        for leaf, fill in (("weight", torch.ones), ("bias", torch.zeros)):
            if c.pre_layernorm:
                out[f"{p}pre_layrnorm.{leaf}"] = sd[f"module.pre_layernorm.{leaf}"]
            out[f"{p}post_layernorm.{leaf}"] = sd.get(f"module.final_layernorm.{leaf}",
                                                      fill(c.hidden_size, device=dev))
        for i in range(c.num_layers):
            # the layers past the tower's tap (CLIP's last) repeat its last block
            blk = blocks.get(i, blocks[max(blocks)])
            out.update({f"{p}encoder.layers.{i}.{_renamed(k, VIT_BLOCK)}": v
                        for k, v in blk.items()})
    return {k: v.to(torch.bfloat16) for k, v in out.items()}


def head_bound(torch, w, h, h_other):
    """How far fp32 logits from bf16-rounded operands may lie from the fp32
    head's, per vocabulary row: (2^-7 + 2^-16) sum_k |h_k w_k| for rounding
    both operands, 2 K 2^-24 of the same sum for the two fp32 sums, plus
    sum_k |h'_k - h_k| |w_k| where the two runs' final hidden states differ.
    ``w`` the fp32 head [V, K], ``h`` / ``h_other`` [1, K] fp32."""
    k = w.shape[1]
    wa = w.abs()
    return ((2 ** -7 + 2 ** -16 + 2 * k * 2 ** -24) * (h.abs() @ wa.T)
            + (h_other - h).abs() @ wa.T)


def phi3_phase(torch, fa, quant):
    """Phase 11, Cambrian-Phi-3 (``cambrian_phi3()``): (a) bf16 weights at
    full width and depth with the fp32 and the bf16 LM head, and a long
    request through ``generate`` and ``generate_stream``; (b) int8 and int4;
    (c) ``load_pretrained_model`` on a checkpoint and tower snapshots written
    by the port. Returns its records and the launches of its three paths."""
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict
    from cambrian_tpu_torch.models.cambrian import head_logits
    from cambrian_tpu_torch.models.config import cambrian_phi3

    dev = torch.device("cuda")
    cfg = cambrian_phi3()
    rng = np.random.default_rng(SEED + 11)
    prompts = build_prompts(cfg, rng)
    n_ids = PHI3_LONG_SLOTS - cfg.image_block_len + 1       # bos and the marker included
    long_prompt = build_prompts(cfg, rng, [(n_ids // 2 - 1, n_ids - n_ids // 2 - 1)])[0]
    check(len(long_prompt["mask"]) == PHI3_LONG_SLOTS and cfg.sliding_window == PHI3_WINDOW,
          f"the long Phi-3 prompt has {len(long_prompt['mask'])} slots")

    # (a) bf16 weights, the fp32 head and the bf16 head on the same tensors;
    # fp32 products in fp32 (the phases before leave TF32 on), so that the
    # fp32 head is the reference the bf16 head's bound assumes
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = random_state_dict(cfg, torch.Generator(device=dev).manual_seed(SEED), 0.02,
                           dtype=torch.bfloat16, device=dev)
    models = {"fp32": CambrianForInference.from_state_dict(cfg, sd, torch.bfloat16),
              "bf16": CambrianForInference.from_state_dict(cfg.replace(lm_head_dtype="bf16"),
                                                           sd, torch.bfloat16)}
    del sd
    torch.cuda.synchronize()
    m = models["fp32"]
    n_params = sum(p.numel() for p in m.lm.parameters()) + sum(
        p.numel() for t in m.towers for p in t.parameters())
    check(models["bf16"].lm.lm_head.weight.dtype == torch.bfloat16
          and m.lm.lm_head.weight.dtype == torch.float32, "Phi-3 heads' dtypes")
    print(f"Phi-3 bf16 build: {n_params / 1e9:.3f}B float parameters, both heads, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    counters = all_counters(fa, quant)
    requests = {"fp32": [], "bf16": []}
    heads = []
    zero_counts(counters)                    # the main path's count starts here
    for r, pr in enumerate(prompts):
        hidden, logits = {}, {}
        for head, model in models.items():
            seen = []

            def keep_first(module, inputs, output, seen=seen):
                if not seen:
                    seen.append(output)      # the prefill's final hidden states

            hook = model.lm.norm.register_forward_hook(keep_first)
            try:
                rec = serve_request(torch, model, counters, cfg, r, pr)
            finally:
                hook.remove()
            last = int(np.flatnonzero(pr["mask"])[-1])
            hidden[head] = seen[0][:, last].float()
            logits[head] = model.engine.last_next_logits
            rec["head"] = head
            requests[head].append(rec)
        w = models["fp32"].lm.head().detach()
        tol = head_bound(torch, w, hidden["fp32"], hidden["bf16"])
        diff = (logits["bf16"] - logits["fp32"]).abs()
        t32, t16 = requests["fp32"][-1]["tokens"], requests["bf16"][-1]["tokens"]
        agree = float(np.mean(np.equal(t32, t16)))
        same_hidden = bool(torch.equal(hidden["fp32"], hidden["bf16"]))
        rec = dict(request=r, max_abs_diff=float(diff.max()), max_tol=float(tol.max()),
                   worst_share=float((diff / tol).max()), token_agreement=agree,
                   same_hidden=same_hidden)
        heads.append(rec)
        print(f"Phi-3 request {r}: bf16 head vs fp32 head first-token logits max abs diff "
              f"{rec['max_abs_diff']:.3e} (bound per row, max {rec['max_tol']:.3e}; worst "
              f"{rec['worst_share']:.1%} of its bound); hidden states equal: {same_hidden}; "
              f"tokens agree {agree:.1%}; decode {requests['fp32'][-1]['decode_tokens_per_s']:.2f}"
              f" / {requests['bf16'][-1]['decode_tokens_per_s']:.2f} tok/s (fp32 / bf16 head)",
              flush=True)
        check(bool((diff <= tol).all()), f"Phi-3 request {r}: the bf16 head's logits lie "
              f"outside bf16 rounding of the fp32 head's")
    # the head alone (device time, medians of 30) at a decode step and at the
    # prefill of request 0's slots, under inference mode as the engine runs it
    head_times = {}
    s0 = len(prompts[0]["mask"])
    g = torch.Generator(device=dev).manual_seed(SEED)
    for rows in (1, s0):
        h = torch.randn((1, rows, cfg.hidden_size), generator=g, device=dev).bfloat16()
        for head, model in models.items():
            w = model.lm.head()
            with torch.inference_mode():
                ms = cuda_ms(torch, lambda: head_logits(model.lm.cfg, w, h), 30,
                             spin=SITE_SPIN_CYCLES, median=True)
            n_bytes = w.numel() * w.element_size() + h.numel() * 2 + rows * cfg.vocab_size * 4
            b_ms, b_by, _, _ = bound(n_bytes, 2 * rows * w.numel(), "bfloat16")
            head_times[f"{head} M={rows}"] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
            print(f"Phi-3 LM head {head} at M={rows}: {ms:.4f} ms (bound {b_ms:.4f} ms, "
                  f"{b_by})", flush=True)
    # the long request: the window bites in the prefill and in every decode step
    model = models["fp32"]
    long_gen = serve_request(torch, model, counters, cfg, 0, long_prompt)
    long_stream = serve_request(torch, model, counters, cfg, 0, long_prompt, stream=True)
    check(long_stream["tokens"] == long_gen["tokens"],
          "Phi-3 long request: generate_stream's tokens differ from generate's")
    print(f"Phi-3 long request ({PHI3_LONG_SLOTS} slots, window {PHI3_WINDOW}): generate and "
          f"generate_stream (chunks of {STREAM_CHUNK}) agree on {NEW_TOKENS} tokens", flush=True)
    launches = read_counts(counters)
    unused = {k: launches[k] for k in VISION_KERNELS if launches[k]}
    check(not unused, f"Phi-3 bf16: the main path launched K5-K8 {unused}")
    peak = torch.cuda.max_memory_allocated()
    print(f"Phi-3 bf16 (both heads) peak memory allocated: {peak / 2**30:.2f} GiB", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    del models, model, w
    gc.collect()
    torch.cuda.empty_cache()

    # (b) int8 and int4, quantized on the card layer by layer
    quant_records = quant_kernel_phase(torch, quant, s0, PHI3_QUANT_SHAPES,
                                       ("int8_matmul", "int4_matmul"), (torch.bfloat16,), "Phi-3")
    for name in ("int8_matmul", "int4_matmul"):
        for label, rows in (("decode step", 1), ("prefill", s0)):
            recs = [x for x in quant_records if x["kernel"] == name and x["m"] == rows]
            per = {key: LAYERS * sum(x[key] for x in recs)
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
            print(f"Phi-3 {name}: decoder GEMMs per {label}: kernel {per['ms']:.3f} ms, plain "
                  f"{per['plain_ms']:.3f} ms, matmul {per['library_ms']:.3f} ms, bound "
                  f"{per['bound_ms']:.3f} ms", flush=True)
    quantized = {}
    zero_counts(counters)
    for q in ("int8", "int4"):
        qcfg = cfg.replace(quantize=q)
        sd = random_state_dict(qcfg, torch.Generator(device=dev).manual_seed(SEED), 0.02,
                               dtype=torch.bfloat16, device=dev)
        model = CambrianForInference.from_state_dict(qcfg, sd, torch.bfloat16)
        del sd
        fn = getattr(quant, f"{q}_matmul")
        fn.function_launches.clear()
        rec = serve_request(torch, model, counters, qcfg, 0, prompts[0])
        routes = dict(fn.function_launches)
        want = {"gemm": QUANT_PER_STEP, "gemv_m1_kernel": QUANT_PER_STEP * (NEW_TOKENS - 1)}
        check(rec["launches"][f"{q}_matmul"] == QUANT_LAUNCHES,
              f"Phi-3 {q}: {q}_matmul launched {rec['launches'][f'{q}_matmul']}x, "
              f"not {QUANT_LAUNCHES}x")
        check(routes == want, f"Phi-3 {q}: routes {routes}, not {want}")
        rec["functions"] = routes
        quantized[q] = rec
        ref = requests["fp32"][0]
        print(f"Phi-3 {q} request 0: prefill {rec['prefill_ms']:.1f} ms (bf16 "
              f"{ref['prefill_ms']:.1f}), decode {rec['decode_tokens_per_s']:.2f} tok/s (bf16 "
              f"{ref['decode_tokens_per_s']:.2f}); routes {routes}", flush=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    quant_launches = read_counts(counters)

    # (c) load_pretrained_model end to end
    load = phi3_load_phase(torch, counters, prompts[0])
    paths = [launches, quant_launches, load.pop("launches")]
    return dict(requests=requests, heads=heads, head_times=head_times,
                long=[long_gen, long_stream], quant_kernels=quant_records, quantized=quantized,
                load=load, peak_bytes=peak,
                launches={k: sum(p[k] for p in paths) for k in launches})


def phi3_load_phase(torch, counters, prompt):
    """Phase 11 (c): under ``build/``, a Cambrian-Phi-3 checkpoint at full
    width and PHI3_LOAD_LAYERS decoder layers (``config.json`` and bf16
    safetensors shards with their index, by the port's writer) and the four
    tower snapshots at full width and depth under a temporary
    ``CAMBRIAN_TOWER_CACHE``; ``load_pretrained_model`` with warnings as
    errors (the directory has no tokenizer, whose warning alone is let
    through, and transformers is kept out of the process); every loaded tensor against the converters' output on the CPU
    from the same files (bit for bit; the resampled DINOv2 position table
    within 1e-6); one request against ``from_state_dict`` on those tensors.
    The files are deleted at the end."""
    import warnings

    from cambrian_tpu_torch.checkpoint import safetensors_io
    from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax
    from cambrian_tpu_torch.checkpoint.hf_llm import convert_cambrian, export_cambrian
    from cambrian_tpu_torch.checkpoint.save import module_params_tree, save_config
    from cambrian_tpu_torch.models import builder
    from cambrian_tpu_torch.models.config import cambrian_phi3

    dev = torch.device("cuda")
    cfg = cambrian_phi3().replace(num_hidden_layers=PHI3_LOAD_LAYERS)
    root = os.path.join(REPO, "build", "phi3_load")
    ckpt, cache = os.path.join(root, "ckpt"), os.path.join(root, "towers")
    saved_env = {k: os.environ.get(k) for k in ("CAMBRIAN_TOWER_CACHE", "HF_HOME")}
    shutil.rmtree(root, ignore_errors=True)
    try:
        g = torch.Generator(device=dev).manual_seed(SEED)
        sd = builder.random_state_dict(cfg, g, 0.02, dtype=torch.bfloat16, device=dev)
        model = builder.CambrianForInference.from_state_dict(cfg, sd, torch.bfloat16)
        del sd
        t0 = time.perf_counter()
        hf = {k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in export_cambrian(module_params_tree(model.lm), cfg).items()}
        n_bytes = safetensors_io.save_sharded(hf, ckpt, shard_size_bytes=1 << 30)
        save_config(cfg, ckpt)
        del hf
        shards = sorted(f for f in os.listdir(ckpt) if f.endswith(".safetensors"))
        for t in model.towers:
            snap = os.path.join(cache, t.hf_repo.replace("/", "--"))
            os.makedirs(snap)
            n_bytes += safetensors_io.save_file(tower_snapshot(torch, t, t.state_dict(), g),
                                                os.path.join(snap, "model.safetensors"))
        write_s = time.perf_counter() - t0
        del model
        gc.collect()
        torch.cuda.empty_cache()
        print(f"Phi-3 load: wrote {n_bytes / 1e9:.3f} GB ({len(shards)} checkpoint shards and "
              f"4 tower snapshots) in {write_s:.1f} s", flush=True)

        os.environ["CAMBRIAN_TOWER_CACHE"] = cache
        os.environ["HF_HOME"] = os.path.join(root, "hf")
        # The directory holds no tokenizer. The loader's attempt to read one
        # imports transformers, whose sentencepiece extension faults when the
        # interpreter exits on the card's machine (exit code 139 after the
        # last line): the import is refused here, and the loader warns that
        # no tokenizer was loaded, the one warning let through.
        blocked = "transformers" not in sys.modules
        if blocked:
            sys.modules["transformers"] = None
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                warnings.filterwarnings("ignore", message="tokenizer not loaded")
                t0 = time.perf_counter()
                _, loaded, _, _ = builder.load_pretrained_model(ckpt, device="cuda",
                                                                dtype=torch.bfloat16)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
        finally:
            if blocked:
                del sys.modules["transformers"]
        check(loaded.config.model_type == "phi3"
              and loaded.config.num_hidden_layers == PHI3_LOAD_LAYERS,
              f"Phi-3 load: config {loaded.config.model_type}, "
              f"{loaded.config.num_hidden_layers} layers")

        # the converters on the CPU, from the same files
        t0 = time.perf_counter()
        mismatched, ref_sd, pos_err = [], {}, None
        want = state_dict_from_jax(convert_cambrian(builder._load_state_dict(ckpt),
                                                    loaded.config), prefix="lm.")
        parts = [({f"lm.{k}": v for k, v in loaded.lm.state_dict().items()}, want, None)]
        for i, t in enumerate(loaded.towers):
            snap = builder._tower_snapshot_dir(t)
            check(snap is not None and snap.startswith(cache), f"{t.name}: snapshot {snap}")
            tower_want = builder.convert_tower(t, builder._load_state_dict(snap))
            parts.append(({f"towers.{i}.{k}": v for k, v in t.state_dict().items()},
                          {f"towers.{i}.{k}": v for k, v in tower_want.items()}, t))
            del tower_want
        for got, want, t in parts:
            check(set(got) == set(want), f"Phi-3 load: keys differ "
                  f"{sorted(set(got) ^ set(want))[:10]}")
            for k, v in want.items():
                w = v.to(dev).to(got[k].dtype)
                if t is not None and "dinov2" in t.name.lower() and k.endswith("module.pos_embed"):
                    pos_err = float((got[k].float() - w.float()).abs().max())
                    check(pos_err <= 1e-6, f"Phi-3 load: DINOv2 resample differs by {pos_err}")
                elif not torch.equal(got[k], w):
                    mismatched.append(k)
                ref_sd[k] = w
        del parts, want
        check(not mismatched, f"Phi-3 load: {len(mismatched)} tensors differ from the CPU "
              f"converters', {mismatched[:10]}")
        check_s = time.perf_counter() - t0
        ref = builder.CambrianForInference.from_state_dict(loaded.config, ref_sd, torch.bfloat16)
        del ref_sd
        kw = dict(images=request_images(torch, loaded.towers, 0), image_sizes=[prompt["size"]],
                  max_new_tokens=NEW_TOKENS, eos_token_id=None)
        zero_counts(counters)                # the path's count starts here
        out = loaded.generate(prompt["ids"], **kw)
        launches = read_counts(counters)
        want_k1 = TOWER_K1_CALLS + PHI3_LOAD_LAYERS
        check(launches["flash_attention_fwd"] == want_k1,
              f"Phi-3 load: K1 launched {launches['flash_attention_fwd']}x, not {want_k1}x")
        ref_out = ref.generate(prompt["ids"], **kw)
        check(out.shape == (1, NEW_TOKENS) and np.array_equal(out, ref_out),
              "Phi-3 load: the loaded model's tokens differ from from_state_dict's")
        print(f"Phi-3 load: load_pretrained_model {load_s:.1f} s ({n_bytes / 1e9 / load_s:.2f} "
              f"GB/s), no warning; every tensor equals the CPU converters' ({check_s:.1f} s), the "
              f"DINOv2 {DINOV2_NATIVE_SIDE}^2 -> {loaded.towers[2].config.grid_side}^2 resample "
              f"within {pos_err:.1e}; {NEW_TOKENS} tokens equal from_state_dict's", flush=True)
        del loaded, ref
        gc.collect()
        torch.cuda.empty_cache()
        return dict(bytes=n_bytes, shards=len(shards), write_s=write_s, load_s=load_s,
                    check_s=check_s, pos_embed_err=pos_err, tokens=out[0].tolist(),
                    launches=launches)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


def sdpa_backend(torch, fn):
    """The backend SDPA picked for ``fn`` (a forward and backward), named
    from the kernels one profiled call ran: "flash", "efficient", "cudnn" or
    "math"."""
    prof, _ = profiled(torch, fn)
    names = " ".join(key.lower() for _, _, key in kernel_events(prof))
    for backend, marks in (("cudnn", ("cudnn", "sm90_flash", "cudnn_generated")),
                           ("flash", ("flash_fwd", "flash_bwd", "pytorch_flash")),
                           ("efficient", ("fmha", "efficient_attention", "mem_eff"))):
        if any(mark in names for mark in marks):
            return backend
    return "math"


def backward_kernel_phase(torch, fa):
    """K2 vs plain at the training paths' decoder shapes (Cambrian-8B's and
    Cambrian-Gemma-7B's), windowed causal cases with dead rows (D = 128 and
    256), D = 192 and the tower shapes; returns per-case records."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False     # plain fp32 products in fp32
    rng = np.random.default_rng(SEED)
    # right padding of a stage-1 batch: each sample's valid length
    lens = rng.integers(TRAIN_SEQ // 3, TRAIN_SEQ + 1, TRAIN_BATCH)
    lens[0] = TRAIN_SEQ
    train_valid = torch.arange(TRAIN_SEQ)[None] < torch.from_numpy(lens)[:, None]
    dead = torch.ones((2, 340), dtype=torch.bool)
    dead[0, :50] = False      # causal rows 0..49 of batch 0 see no valid key
    dead[1] = False           # batch 1 sees none at all
    cases = [
        # name, b, s_q, s_k, h, kvh, d, causal, window, key_valid, launches per step
        ("decoder_train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 8, 128, True, None,
         train_valid, TRAIN_K2_LAUNCHES),
        # Gemma-7B's stage-1 shape (phase 15): 16 heads of 256, the same H x D
        ("gemma_train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 16, 256, True, None,
         train_valid, GEMMA_LAYERS),
        ("window_dead_rows", 2, 300, 340, 8, 2, 128, True, 64, dead, 0),
        ("d256_window_dead_rows", 2, 300, 340, 4, 2, 256, True, 64, dead, 0),
        ("d192", 2, 300, 300, 8, 2, 192, True, None, None, 0),
        ("siglip", 1, 729, 729, 16, 16, 72, False, None, None, 0),
        ("clip", 1, 577, 577, 16, 16, 64, False, None, None, 0),
        ("dinov2", 1, 730, 730, 24, 24, 64, False, None, None, 0),
    ]
    g = torch.Generator(device=dev).manual_seed(SEED)
    records = []
    for name, b, s_q, s_k, h, kvh, d, causal, window, valid, per_step in cases:
        if valid is not None:
            valid = valid.to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            dtype_name = str(dtype).replace("torch.", "")
            q = torch.randn((b, s_q, h, d), generator=g, device=dev).to(dtype)
            k = torch.randn((b, s_k, kvh, d), generator=g, device=dev).to(dtype)
            v = torch.randn((b, s_k, kvh, d), generator=g, device=dev).to(dtype)
            do = torch.randn((b, s_q, h, d), generator=g, device=dev).to(dtype)
            # as FlashAttentionFunction runs it: the forward's output and row
            # statistic saved, then the backward given both
            scale = d ** -0.5
            o, lse = fa._flash_fwd(q, k, v, valid, causal, window, 0, scale, True)
            got = fa.flash_attention_bwd(q, k, v, valid, o, do, causal, window, lse=lse)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), valid,
                                                    o.float(), do.float(), causal, window)
            # fp32: the same math in another summation order; bf16: the
            # outputs' rounding (2^-8 relative) of values up to |ref|max, and
            # the GQA group summed in fp32 before it
            rel = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
            errs, tols = {}, {}
            for what, x, ref in zip(("dq", "dk", "dv"), got, want):
                check(x.dtype == dtype and x.shape == ref.shape,
                      f"K2 {name} {dtype_name} {what}: {x.dtype} {tuple(x.shape)}")
                check(torch.isfinite(x).all().item(), f"K2 {name} {dtype_name} {what}: non-finite")
                errs[what] = float((x.float() - ref).abs().max())
                tols[what] = rel * max(1.0, float(ref.abs().max()))
                check(errs[what] <= tols[what], f"K2 {name} {dtype_name} {what}: max abs error "
                      f"{errs[what]} > {tols[what]}")
            if name.endswith("window_dead_rows"):
                dq, dk, dv = got
                check((dq[1] == 0).all().item() and (dq[0, :50] == 0).all().item(),
                      "K2: dq of dead rows is not exactly 0")
                check(all((x[1] == 0).all().item() and (x[0, :50] == 0).all().item()
                          for x in (dk, dv)), "K2: dk/dv of keys no row sees are not exactly 0")
            del got, want
            # each call alone behind a spin kernel, as in phase 2
            alone = dict(spin=SITE_SPIN_CYCLES)
            ms = cuda_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, valid, o, do, causal,
                                                               window, lse=lse), **alone)
            # the statistic's own cost: K1 writing it less K1 without
            fwd_ms = cuda_ms(torch, lambda: fa._flash_fwd(q, k, v, valid, causal, window, 0,
                                                          scale), **alone)
            stat_ms = cuda_ms(torch, lambda: fa._flash_fwd(q, k, v, valid, causal, window, 0,
                                                           scale, True), **alone) - fwd_ms
            plain_ms = cuda_ms(torch, lambda: fa.flash_attention_bwd_reference(
                q, k, v, valid, o, do, causal, window), **alone)
            # the (batch, query, key) pairs the mask lets through
            keep = torch.ones((b, s_q, s_k), dtype=torch.bool, device=dev)
            if valid is not None:
                keep &= valid[:, None, :]
            qpos = torch.arange(s_q, device=dev)[:, None]
            kpos = torch.arange(s_k, device=dev)[None, :]
            if causal:
                keep &= kpos <= qpos
            if window is not None:
                keep &= (qpos - kpos) < window
            pairs = int(keep.sum())
            # the library call on the same work: SDPA's backward, heads first,
            # GQA expanded, the mask dense (its forward+backward less its forward)
            qt = q.transpose(1, 2).contiguous().requires_grad_(True)
            kt = k.repeat_interleave(h // kvh, 2).transpose(1, 2).contiguous().requires_grad_(True)
            vt = v.repeat_interleave(h // kvh, 2).transpose(1, 2).contiguous().requires_grad_(True)
            dot = do.transpose(1, 2).contiguous()
            dense = None if valid is None and not causal else keep[:, None]

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=dense,
                                                      scale=d ** -0.5)

            def sdpa_fwd_bwd():
                return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

            sdpa_fwd_ms = cuda_ms(torch, sdpa, **alone)
            sdpa_fwd_bwd_ms = cuda_ms(torch, sdpa_fwd_bwd, **alone)
            library_ms = sdpa_fwd_bwd_ms - sdpa_fwd_ms
            backend = sdpa_backend(torch, sdpa_fwd_bwd) if per_step else None
            del qt, kt, vt, dot, dense, keep
            # each input read once (q, k, v, o, do) and each output written
            # once (dq, dk, dv); five products of 2 * d operations per head
            # and live pair: q.k, do.v, p^T do, ds k, ds^T q
            n_bytes = 4 * (q.numel() + k.numel()) * q.element_size() + (
                0 if valid is None else valid.numel())
            bound_ms, bound_by, bytes_ms, ops_ms = bound(n_bytes, 10 * h * d * pairs, dtype_name)
            rec = dict(case=name, dtype=dtype_name, b=b, s_q=s_q, s_k=s_k, h=h, kvh=kvh, d=d,
                       causal=causal, window=window, max_abs_err=max(errs.values()), errs=errs,
                       tols=tols, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       sdpa_fwd_ms=sdpa_fwd_ms, bound_ms=bound_ms, bound_by=bound_by,
                       bytes_ms=bytes_ms, ops_ms=ops_ms, per_step=per_step,
                       sdpa_backend=backend,
                       tflops=10 * h * d * pairs / ms / 1e9, k1_ms=fwd_ms, stat_ms=stat_ms)
            print(f"kernel flash_attention_bwd {name:16s} {dtype_name:8s} B={b} Sq={s_q} "
                  f"Sk={s_k} H={h}/{kvh} D={d} err dq/dk/dv="
                  f"{errs['dq']:.3e}/{errs['dk']:.3e}/{errs['dv']:.3e} (tol "
                  f"{tols['dq']:.2e}/{tols['dk']:.2e}/{tols['dv']:.2e}) kernel={ms:.4f} ms "
                  f"({rec['tflops']:.2f} TFLOP/s) plain={plain_ms:.4f} ms "
                  f"sdpa_bwd={library_ms:.4f} ms"
                  + ("" if backend is None else f" ({backend})")
                  + f" bound={bound_ms:.4f} ms ({bound_by}); K1 "
                  f"{fwd_ms:.4f} ms, its row statistic {stat_ms:+.4f} ms", flush=True)
            records.append(rec)
            del q, k, v, o, do, lse
    torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    torch.cuda.empty_cache()
    return records


def tiny_train_batches(cfg, towers, rng, n, b=2):
    """n packed micro-batches of b samples: an image marker, a masked
    prompt, right padding in the second sample."""
    from cambrian_tpu_torch import IGNORE_INDEX, IMAGE_TOKEN_INDEX, prepare_multimodal_data

    out = []
    for _ in range(n):
        ids = rng.integers(5, cfg.vocab_size, (b, 150)).astype(np.int64)
        ids[:, cfg.image_position] = IMAGE_TOKEN_INDEX
        labels = ids.copy()
        labels[:, :30] = IGNORE_INDEX
        mask = np.ones(ids.shape, bool)
        mask[1, 110:] = False
        ids[1, 110:] = 0
        labels[1, 110:] = IGNORE_INDEX
        pids, plab, pmask, ppos, aux = prepare_multimodal_data(
            ids, labels, mask, [(640, 360), (300, 500)][:b], cfg.image_token_len,
            cfg.mm_vision_tower_aux_token_len_list, cfg.tokenizer_model_max_length)
        images = [rng.standard_normal((b, 3, t.image_size, t.image_size), dtype=np.float32)
                  for t in towers]
        out.append(dict(input_ids=pids, labels=plab, attention_mask=pmask, position_ids=ppos,
                        aux_masks=list(aux), images=images))
    return out


def batch_to(torch, batch, device):
    return {k: [torch.from_numpy(np.asarray(x)).to(device) for x in v] if isinstance(v, list)
            else torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def tiny_training_phase(torch, fa, quant):
    """``make_train_step`` on a tiny Cambrian, stage 1 and stage 2: the
    kernel path on the card (fp32, TF32 off) against the plain path on the
    CPU, 3 optimizer steps each from the same weights and batches."""
    from cambrian_tpu_torch import tiny_debug
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict
    from cambrian_tpu_torch.train.optimizer import TrainConfig
    from cambrian_tpu_torch.train.train_step import init_train_state, make_train_step

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_debug(num_towers=2).replace(tokenizer_model_max_length=192)
    sd = random_state_dict(cfg, torch.Generator().manual_seed(SEED), 0.05,
                           dtype=torch.float32, device="cpu")
    towers = CambrianForInference.from_state_dict(cfg, sd, torch.float32).towers
    batches = tiny_train_batches(cfg, towers, np.random.default_rng(SEED + 1), TRAIN_STEPS)
    tower_calls = sum(t.config.num_blocks_to_run for t in towers)
    counters = all_counters(fa, quant)
    loss_tol, param_tol = 1e-4, 1e-4
    out = {}
    for stage in (1, 2):
        tc = TrainConfig(learning_rate=1e-3, mm_vision_sampler_lr=5e-4, warmup_ratio=0.34,
                         total_steps=TRAIN_STEPS, lr_scheduler_type="cosine", max_grad_norm=1.0,
                         tune_mm_mlp_adapter=stage == 1)
        runs = {}
        for dev in ("cpu", "cuda"):
            m = CambrianForInference.from_state_dict(
                cfg, {k: v.to(dev, copy=True) for k, v in sd.items()}, torch.float32)
            state = init_train_state(m.lm, m.towers, tc)
            step = make_train_step(m.lm, m.towers, freeze=tc)
            zero_counts(counters)
            losses = [float(step(state, batch_to(torch, b, dev))[1]["loss"]) for b in batches]
            runs[dev] = (losses, read_counts(counters),
                         {k: p.detach().cpu() for k, p in m.lm.named_parameters()},
                         len(state.optimizer.params))
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
        param_err = max(float((runs["cuda"][2][k] - p).abs().max())
                        for k, p in runs["cpu"][2].items())
        want = {name: 0 for name in counters}
        want["flash_attention_fwd"] = TRAIN_STEPS * (tower_calls + 2 * cfg.num_hidden_layers)
        want["flash_attention_bwd"] = TRAIN_STEPS * cfg.num_hidden_layers
        print(f"tiny training stage {stage}: cpu losses {runs['cpu'][0]} card losses "
              f"{runs['cuda'][0]} (max rel diff {loss_err:.3e}), parameters max abs diff "
              f"{param_err:.3e}, {runs['cuda'][3]} trainable tensors, card launches "
              f"{ {k: v for k, v in runs['cuda'][1].items() if v} }", flush=True)
        check(runs["cpu"][1] == {name: 0 for name in counters},
              f"tiny training stage {stage}: the CPU path launched {runs['cpu'][1]}")
        check(runs["cuda"][1] == want,
              f"tiny training stage {stage}: launched {runs['cuda'][1]}, not {want}")
        check(all(np.isfinite(runs["cuda"][0])), f"tiny training stage {stage}: non-finite loss")
        check(loss_err <= loss_tol, f"tiny training stage {stage}: losses differ by {loss_err}")
        check(param_err <= param_tol,
              f"tiny training stage {stage}: parameters differ by {param_err}")
        out[f"stage{stage}"] = dict(cpu_losses=runs["cpu"][0], card_losses=runs["cuda"][0],
                                    loss_rel_err=loss_err, param_abs_err=param_err,
                                    launches=runs["cuda"][1])
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out


class PretokenizedDataset:
    """Stage-1 samples made with numpy (the card's machine has no tokenizer
    or image decoder): token ids with the llama_3 prompt masked, image
    samples with their marker at ``image_position`` and per-tower pixel
    arrays at each tower's crop size, text-only samples with the zero images
    ``LazySupervisedDataset`` gives them."""

    def __init__(self, cfg, towers, n, rng):
        from cambrian_tpu_torch import IGNORE_INDEX, IMAGE_TOKEN_INDEX

        self.items, self.modality_lengths = [], []
        longest = TRAIN_SEQ - cfg.image_block_len   # what fits beside the image block
        for i in range(n):
            has_image = i % 3 != 2
            length = int(rng.integers(longest // 4, longest + 1))
            ids = rng.integers(5, min(cfg.vocab_size, 128000), length).astype(np.int64)
            ids[0] = cfg.bos_token_id
            labels = ids.copy()
            labels[:cfg.image_position + 24] = IGNORE_INDEX      # the prompt
            if has_image:
                ids[cfg.image_position] = IMAGE_TOKEN_INDEX
                images = [rng.standard_normal((3, t.image_size, t.image_size), dtype=np.float32)
                          for t in towers]
                size = (int(rng.integers(300, 1200)), int(rng.integers(300, 1200)))
            else:
                images = [np.zeros((3, t.image_size, t.image_size), np.float32) for t in towers]
                size = (towers[0].image_size, towers[0].image_size)
            self.items.append(dict(input_ids=ids, labels=labels, image_aux_list=images,
                                   image_size=size))
            self.modality_lengths.append(length if has_image else -length)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class PretokenizedTokenizer:
    """What the collator reads of a tokenizer (LLaMA-3: pad = eos)."""
    model_max_length = TRAIN_SEQ
    pad_token_id = 128001
    padding_side = "right"


def kernel_events(prof):
    """(device us, count, name) of each kernel of a profiled run, longest
    first; the host-side ops that launched them are left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out.append((us, e.count, e.key))
    return sorted(out, reverse=True)


# kernel function names of K1 (fp32 SIMT, bf16 tensor cores) and K2 (delta,
# dk/dv and dq passes, each dtype)
K1_FUNCTIONS = ("flash_fwd_kernel", "fwd_bf16_kernel")
K2_FUNCTIONS = ("bwd_delta_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel", "bwd_dkdv_bf16_kernel",
                "bwd_dq_bf16_kernel")
# the quant matmuls' kernel functions: decode GEMV, fp32 SIMT GEMM, the
# mma.sync GEMM for bf16 operands TMA cannot address, the wgmma prefill GEMM,
# the bf16 M = 1 and M = 2..8 GEMVs over a thread-block cluster
QUANT_FUNCTIONS = ("gemv_kernel", "gemm_kernel", "gemm_tc_kernel", "gemm_wgmma_kernel",
                   "gemv_m1_kernel", "gemv_m8_kernel")
# the bf16 M = 1 decode GEMV of modes 0 (K3), 1 (K4) and 2 (K4b/K4c; on the
# tensor cores, mma.sync)
GEMV_M1_FUNCTIONS = ["gemv_m1_kernel<0>", "gemv_m1_kernel<1>", "gemv_m1_kernel<2>"]
# the bf16 M = 2..8 decode GEMV on the tensor cores: <mode, rows of x it is
# built for, bytes a lane of a row>
GEMV_M8_FUNCTIONS = [f"gemv_m8_kernel<{mode},{mt},{w}>" for mode in range(3) for mt in (2, 4, 8)
                     for w in (16, 8)]
# K6's functions: the 16-byte row pass <dtype, lanes a row, chunks a lane>
# and the scalar kernel <dtype>
LN_FUNCTIONS = ("layer_norm_vec_kernel", "layer_norm_kernel")
LN_VEC, LN_SCALAR = LN_FUNCTIONS
# K7's functions: the persistent TMA-fed kernel <dtype, rows, columns a
# thread> and the first port's kernel <dtype>
DW_FUNCTIONS = ("dwconv7x7_tma_kernel", "dwconv7x7_kernel")
DW_TMA, DW_OLD = DW_FUNCTIONS
# K5's functions: the persistent TMA-fed kernel <dtype, lanes a key row,
# window class> and the first port's kernel <dtype>
SVA_FUNCTIONS = ("sva_attention_tma_kernel", "sva_attention_kernel")
SVA_TMA, SVA_OLD = SVA_FUNCTIONS
# the wgmma prefill GEMM's functions: <mode, tile columns>
WGMMA_FUNCTIONS = [f"gemm_wgmma_kernel<{mode},{bn}>" for mode in range(3) for bn in (64, 128)]
# K8's bf16 GEMMs (bias + GELU, and bias): <tile columns>; its kernels for
# operands TMA cannot address (mma.sync) and for fp32 (SIMT)
MLP_FUNCTIONS = ("mlp_up_kernel", "mlp_down_kernel")
MLP_WGMMA_FUNCTIONS = [f"{fn}<{bn}>" for fn in MLP_FUNCTIONS for bn in (64, 128, 192, 256)]
MLP_TC_FUNCTION, MLP_SIMT_FUNCTION = "fused_mlp_tc_kernel", "fused_mlp_simt_kernel"


def profiled(torch, run, host=False, tries=3):
    """``run()`` under ``torch.profiler`` (the card's activity, and the
    host's with ``host``): the profile and what ``run`` returned. A trace
    that holds no kernel at all is the profiler's loss, not the card's: a
    session in a process that had held five others has come back empty
    while its calls ran, as their launch counts showed. ``run`` is then
    profiled again, ``tries`` times in all, before the check fails."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    for attempt in range(1, tries + 1):
        with profile(activities=activities) as prof:
            out = run()
            torch.cuda.synchronize()
        if kernel_events(prof):
            return prof, out
        print(f"profiler: trace {attempt} of {tries} holds no kernel", flush=True)
    check(False, f"{tries} profiled runs came back without a kernel")


def quant_functions(names):
    """The quant matmuls' kernel functions among profiled kernel names, as
    ``name<template arguments>``."""
    pattern = rf"\b({'|'.join(QUANT_FUNCTIONS)})(<[^>]*>)?"
    return [m[0] + m[1].replace(" ", "") for n in names for m in re.findall(pattern, n)]


def wgmma_tile_columns(m, n, sms):
    """The prefill GEMM's tile columns as its launcher picks them
    (``pick_bn`` in quant_matmul.cu): 64 where 128 x 128 tiles would give
    fewer tiles than SMs, else 128."""
    return 64 if -(-m // 128) * -(-n // 128) < sms else 128


def quant_function_check(torch, quant, cases, calls=3):
    """By launch counter and by kernel name, from one ``torch.profiler`` run
    of ``calls`` calls of each bf16 prefill, M = 1 and M = 2..8 case of K3,
    K4 and K4b (name, site, x, weights, scales, record): each M = 1 call runs
    gemv_m1_kernel<mode>, each M = 2..8 call gemv_m8_kernel<mode, MT, W> of
    its plan, each prefill the wgmma GEMM of its mode at the tile columns its
    launcher picks, and the trace holds no other quant-matmul function (so
    no bf16 decode call ran the first port's gemv_kernel). One
    run for the phase: profiler sessions in one process have come back
    without kernels, and a trace of one call has lost one of its kernels."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fns = {name: getattr(quant, name) for name in QUANT_KERNELS}

    def run():
        routes = []
        for name, _, x, wq, sc, _ in cases:
            fns[name].function_launches.clear()
            for _ in range(calls):
                fns[name](x, wq, sc)
            routes.append(dict(fns[name].function_launches))
        return routes

    prof, routes = profiled(torch, run)
    launched = {}
    for _, n, key in kernel_events(prof):
        for fn in quant_functions([key]):
            launched[fn] = launched.get(fn, 0) + n
    planned = set()
    for (name, site, x, wq, sc, rec), route in zip(cases, routes):
        mode = list(QUANT_KERNELS).index(name)   # K3, K4, K4b: modes 0, 1, 2
        m = x.shape[0]
        if m == 1:
            want, fn = "gemv_m1_kernel", f"gemv_m1_kernel<{mode}>"
        elif m <= 8:
            # <mode, rows of x it is built for, bytes a lane: the plan's slab / 8>
            plan = quant._gemv_plan(mode, x.dtype, m, rec["n"], rec["k"],
                                    1 if mode == 0 else rec["k"] // sc.shape[0], x.data_ptr(),
                                    wq.data_ptr(), sms, sc.data_ptr(), ldx=x.stride(0))
            check(plan is not None, f"{name} {site} M={m}: no gemv_m8_kernel plan")
            want = "gemv_m8_kernel"
            fn = f"gemv_m8_kernel<{mode},{quant._gemv_rows(m)},{plan.slab // 8}>"
        else:
            want = "gemm"
            fn = f"gemm_wgmma_kernel<{mode},{wgmma_tile_columns(m, rec['n'], sms)}>"
        check(route == {want: calls}, f"{name} {site} M={m}: the wrapper launched {route}, "
              f"not {calls} x {want}")
        check(fn in launched, f"{name} {site} M={m}: planned {fn}; the profiled run "
              f"launched {launched}")
        rec["function"] = fn
        planned.add(fn)
        print(f"kernel {name:29s} {site:9s} M={m:<4d} ran {fn}", flush=True)
    others = {fn: n for fn, n in launched.items() if fn not in planned}
    check(not others, f"the profiled bf16 prefill and decode calls also ran {others}")
    print(f"quant functions of the profiled run ({calls} calls a case): {launched}", flush=True)


def device_time_by_kind(prof):
    """Device ms of a profiled run by kernel kind: K1, K2, GEMMs, others."""
    kinds = {"K1": 0.0, "K2": 0.0, "gemm": 0.0, "other": 0.0}
    for us, _, key in kernel_events(prof):
        name = key.lower()
        if any(s in name for s in K1_FUNCTIONS):
            kind = "K1"
        elif any(s in name for s in K2_FUNCTIONS):
            kind = "K2"
        elif any(s in name for s in ("gemm", "xmma", "nvjet", "cutlass")):
            kind = "gemm"
        else:
            kind = "other"
        kinds[kind] += us / 1e3
    return kinds


def train_stage1_phase(torch, fa, quant, k2_record, cfg, label, layers):
    """Stage-1 pretraining of the Cambrian ``cfg`` (``layers`` decoder
    layers) through ``CambrianTrainer.train()``: phase 9 (Cambrian-8B) and
    phase 15 (Cambrian-Gemma-7B)."""
    from cambrian_tpu_torch.data.dataset import DataCollatorForSupervisedDataset
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict
    from cambrian_tpu_torch.train.optimizer import cast_frozen_params, label_params
    from cambrian_tpu_torch.train.train_step import make_train_step, named_parameters
    from cambrian_tpu_torch.train.trainer import CambrianTrainer, TrainingArguments, _pin

    dev = torch.device("cuda")
    # the training entry point's default: fp32 products (the loss's head) in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    k1_per_batch, k2_per_batch = TOWER_K1_CALLS + 2 * layers, layers
    out_dir = os.path.join(REPO, "build", "chip_smoke_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    # scripts/cambrian/pretrain_cambrian_8b.sh, but 3 optimizer steps
    args = TrainingArguments(
        output_dir=out_dir, tune_mm_mlp_adapter=True, bf16=True, num_train_epochs=1,
        per_device_train_batch_size=TRAIN_BATCH, gradient_accumulation_steps=1,
        learning_rate=1e-3, mm_vision_sampler_lr=1e-4, weight_decay=0.0, warmup_ratio=0.06,
        lr_scheduler_type="cosine", logging_steps=1, save_steps=500, save_total_limit=2,
        group_by_modality_length=True, seed=SEED, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    sd = random_state_dict(cfg, g, 0.02, dtype=torch.bfloat16, device=dev)
    model = CambrianForInference.from_state_dict(cfg, sd, torch.bfloat16)
    del sd
    lm, towers = model.lm, model.towers
    dataset = PretokenizedDataset(cfg, towers, TRAIN_STEPS * TRAIN_BATCH,
                                  np.random.default_rng(SEED))
    collator = DataCollatorForSupervisedDataset(
        tokenizer=PretokenizedTokenizer(), image_token_len=cfg.image_token_len,
        image_aux_token_len_list=list(cfg.mm_vision_tower_aux_token_len_list),
        image_position=cfg.image_position)
    # the trainer's own bf16 cast of the frozen groups, done first so that
    # the frozen weights can be snapshotted as they train
    named = named_parameters(lm, towers)
    cast_frozen_params(named, args)
    labels = label_params(named, args)
    frozen = {n: p for n, p in named.items() if labels[n] == "frozen"}
    frozen.update({f"towers.{i}.{n}": p for i, t in enumerate(towers)
                   for n, p in t.named_parameters()})
    trainable = {n: p for n, p in named.items() if labels[n] != "frozen"}
    check("embed_tokens.weight" in frozen, f"{label} train: the embedding is not frozen")
    n_frozen = sum(p.numel() for p in frozen.values())
    n_trainable = sum(p.numel() for p in trainable.values())
    frozen_before = {n: p.detach().cpu() for n, p in frozen.items()}
    trainable_before = {n: p.detach().cpu() for n, p in trainable.items()}
    valid_tokens = sum(int(collator([it])["attention_mask"].sum()) for it in dataset.items)
    torch.cuda.synchronize()
    print(f"{label} train build: {n_trainable / 1e9:.4f}B trainable, {n_frozen / 1e9:.3f}B frozen "
          f"parameters ({len(trainable)} / {len(frozen)} tensors) in "
          f"{time.perf_counter() - t0:.1f} s; {len(dataset)} samples, {valid_tokens} valid "
          f"tokens in {len(dataset) * TRAIN_SEQ} slots", flush=True)

    trainer = CambrianTrainer(model=lm, towers=towers, args=args, train_dataset=dataset,
                              data_collator=collator)
    counters = all_counters(fa, quant)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)                    # the training path's count starts here
    history = trainer.train()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()

    step_ms = [s * 1e3 for s in trainer.step_seconds]
    warm_ms = float(np.mean(step_ms[1:]))
    for h in history:
        print(f"{label} train step {h['step']}: loss {h['loss']:.6f} grad_norm {h['grad_norm']:.6f} "
              f"lr {h['lr']:.3e}", flush=True)
    check([h["step"] for h in history] == list(range(1, TRAIN_STEPS + 1)),
          f"{label} train: history steps {[h['step'] for h in history]}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) and h["grad_norm"] > 0
              for h in history), f"{label} train: non-finite loss or grad_norm, or grad_norm 0")
    want = {name: 0 for name in counters}
    want["flash_attention_fwd"] = TRAIN_STEPS * k1_per_batch
    want["flash_attention_bwd"] = TRAIN_STEPS * k2_per_batch
    check(launches == want, f"{label} train: launched {launches}, not {want}")
    moved = [n for n, p in trainable.items() if not torch.equal(p.detach().cpu(),
                                                                 trainable_before[n])]
    check(any("vision_sampler" in n for n in moved) and any("mm_projector" in n for n in moved),
          f"{label} train: the connector did not move ({len(moved)} tensors changed)")
    changed = [n for n, p in frozen.items() if not torch.equal(p.detach().cpu(),
                                                               frozen_before[n])]
    check(not changed, f"{label} train: frozen weights changed: {changed[:5]}")
    check(all(p.grad is None for p in named.values()), f"{label} train: a parameter kept a .grad")
    del frozen_before, trainable_before

    k2_step_ms = k2_per_batch * k2_record["ms"]
    warm_s = warm_ms / 1e3
    rec = dict(step_ms=step_ms, warm_step_ms=warm_ms, samples_per_s=TRAIN_BATCH / warm_s,
               slot_tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / warm_s,
               valid_tokens_per_s=valid_tokens / TRAIN_STEPS / warm_s, peak_bytes=peak,
               n_trainable=n_trainable, n_frozen=n_frozen, launches=launches,
               history=history, moved=len(moved), trainable_tensors=len(trainable),
               k2_step_ms=k2_step_ms, k2_share=k2_step_ms / warm_ms)
    print(f"{label} train: step wall ms {[round(s, 1) for s in step_ms]} (the first is cold); "
          f"warm {warm_ms:.1f} ms, {rec['samples_per_s']:.3f} samples/s, "
          f"{rec['slot_tokens_per_s']:.1f} slot tokens/s, {rec['valid_tokens_per_s']:.1f} valid "
          f"tokens/s; peak memory allocated {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); "
          f"{len(moved)}/{len(trainable)} connector tensors moved; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print(f"{label} train: K2 per step {k2_per_batch} x {k2_record['ms']:.3f} ms = "
          f"{k2_step_ms:.1f} ms, {100 * rec['k2_share']:.1f}% of a warm step", flush=True)

    # one more step under the profiler: where a step's device time goes
    step_fn = make_train_step(lm, towers)
    state = trainer._final_state
    host = collator(dataset.items[:TRAIN_BATCH])
    batch = {k: [x.to(dev, non_blocking=True) for x in _pin(v)] if isinstance(v, list)
             else _pin(v).to(dev, non_blocking=True) for k, v in host.items()}
    torch.cuda.synchronize()

    def step():
        t1 = time.perf_counter()
        new_state, metrics = step_fn(state, batch)
        check(np.isfinite(float(metrics["loss"])), f"{label} profiled step: non-finite loss")
        torch.cuda.synchronize()
        return new_state, (time.perf_counter() - t1) * 1e3

    prof, (state, prof_wall_ms) = profiled(torch, step, host=True)
    kinds = device_time_by_kind(prof)
    busy = sum(kinds.values())
    check(kinds["K1"] > 0 and kinds["K2"] > 0,
          f"{label} profiled step: no K1/K2 device time {kinds}")
    check(not any("stats" in key for _, _, key in kernel_events(prof)),
          f"{label} profiled step: a kernel recomputed the row statistics")
    rec.update(profiled_wall_ms=prof_wall_ms, device_ms=kinds, device_busy_ms=busy,
               idle_share=1 - busy / prof_wall_ms)
    print(f"{label} train profiled step: wall {prof_wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"(idle {100 * rec['idle_share']:.1f}%): K1 {kinds['K1']:.1f} ms, K2 "
          f"{kinds['K2']:.1f} ms, GEMMs {kinds['gemm']:.1f} ms, other {kinds['other']:.1f} ms",
          flush=True)
    for us, count, key in kernel_events(prof)[:12]:
        print(f"  {us / 1e3:9.1f} ms {count:6d}x {key[:110]}", flush=True)

    del model, lm, towers, trainer, state, batch, step_fn, named, frozen, trainable, prof
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    return rec


# -- phase 10: kernels K5-K8 at the drop-in sites of the 8B encode and prefill --

# kind (the kernel wrapper's name): (its op module, the site's arguments in
# order, the TPU kernel it replaces, its source)
VISION_KERNELS = {
    "fused_windowed_cross_attention": (
        "sva_attention", ("q", "k", "v", "mask"), "cambrian_tpu/ops/sva_attention.py:35",
        "cambrian_tpu_torch/csrc/sva_attention.cu"),
    "fused_layer_norm": (
        "norms", ("x", "weight", "bias", "eps"), "cambrian_tpu/ops/norms.py:51",
        "cambrian_tpu_torch/csrc/layer_norm.cu"),
    "depthwise_conv7x7": (
        "dwconv", ("x", "w", "bias"), "cambrian_tpu/ops/dwconv.py:36",
        "cambrian_tpu_torch/csrc/dwconv.cu"),
    "fused_mlp": (
        "fused_mlp", ("x", "w1", "b1", "w2", "b2"), "cambrian_tpu/ops/fused_mlp.py:36",
        "cambrian_tpu_torch/csrc/fused_mlp.cu"),
}
SITE_REL_PLAIN = 2 ** -7   # bf16 kernel vs its plain version on fp32-upcast inputs
LN_ITERS = 30              # K6's calls a site, timed in turns with the PyTorch calls
DW_ITERS = 30              # K7's, in turns with the first port's kernel and F.conv2d
SVA_ITERS = 30             # K5's, in turns with the first port's kernel, SDPA and einsums
# vs the main path's own op at the site: K5's einsum path rounds the
# probabilities to bf16 before PV and K8's main path rounds the first
# Linear's output (and adds its bias) in bf16 before GELU, so each differs
# from the kernel by more than one output rounding; K6's layer_norm and K7's
# cuDNN conv round only their outputs, but are held to the same bound
SITE_REL_MAIN = 2 ** -5


def _site_fns(kind):
    """(the kernel wrapper, its plain version) of a site kind."""
    import importlib

    mod = importlib.import_module(f"cambrian_tpu_torch.ops.{VISION_KERNELS[kind][0]}")
    return getattr(mod, kind), getattr(mod, f"{kind}_reference")


def _site_args(torch, kind, site, upcast=False):
    args = [site[a] for a in VISION_KERNELS[kind][1]]
    if upcast:
        args = [a.float() if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
    return args


def kernel_at_site(torch, kind, site):
    """The kernel (or, for CPU tensors, its plain version) on the site's inputs."""
    return _site_fns(kind)[0](*_site_args(torch, kind, site))


def plain_at_site(torch, kind, site, upcast=False):
    """The plain version on the site's inputs (upcast to fp32 if asked)."""
    return _site_fns(kind)[1](*_site_args(torch, kind, site, upcast))


def capture_sites(torch, modules, run):
    """Run ``run()`` once with forward hooks on the drop-in sites of K5-K8
    inside ``modules`` (every ``LayerNorm``; each ``ConvNeXtBlock``'s dwconv
    and its pwconv1/pwconv2 pair; every SVA ``Mlp``) and a recording wrapper
    around the SVA module's ``windowed_cross_attention``, which returns the
    main path's own result. Returns {kind: {shape key: site}}: the inputs
    and output of the first site of each shape, in the kernel's layout, and
    ``count``, the sites of that shape in the run. Hooks and wrapper are
    removed on return."""
    from cambrian_tpu_torch.models import sva
    from cambrian_tpu_torch.models.encoders.convnext import ConvNeXtBlock
    from cambrian_tpu_torch.ops.norms import LayerNorm

    sites = {kind: {} for kind in VISION_KERNELS}

    def keep(kind, key, make):
        if key not in sites[kind]:
            sites[kind][key] = dict(make(), count=0)
        sites[kind][key]["count"] += 1

    def grab(t):
        return t.detach().contiguous().clone()

    def on_norm(mod, inputs, out):
        x = inputs[0]
        c = x.shape[-1]
        keep("fused_layer_norm", (c, x.numel() // c), lambda: dict(
            x=grab(x.reshape(-1, c)), weight=mod.weight.detach(), bias=mod.bias.detach(),
            eps=mod.eps, out=grab(out.reshape(-1, c))))

    def on_dwconv(conv, inputs, out):
        x = inputs[0]                                    # NCHW
        keep("depthwise_conv7x7", (x.shape[0], x.shape[2], x.shape[3], x.shape[1]), lambda: dict(
            x=grab(x.permute(0, 2, 3, 1)), w=conv.weight.detach()[:, 0].permute(1, 2, 0),
            bias=conv.bias.detach(), out=grab(out.permute(0, 2, 3, 1)),
            x_nchw=x.detach().clone(), conv_w=conv.weight.detach(), conv_b=conv.bias.detach()))

    def mlp_site(x, lin1, lin2, out):
        return dict(x=grab(x), w1=lin1.weight.detach().t(),
                    b1=None if lin1.bias is None else lin1.bias.detach(),
                    w2=lin2.weight.detach().t(),
                    b2=None if lin2.bias is None else lin2.bias.detach(), out=grab(out))

    def on_pair(block):
        pending = {}

        def first(lin, inputs, out):
            pending["x"] = inputs[0]

        def second(lin, inputs, out):
            x = pending.pop("x").reshape(-1, block.pwconv1.in_features)
            out = out.reshape(x.shape[0], -1)
            keep("fused_mlp", ("convnext", x.shape[0], x.shape[1], block.pwconv1.out_features,
                               out.shape[1]),
                 lambda: mlp_site(x, block.pwconv1, block.pwconv2, out))

        return first, second

    def on_mlp(mod, inputs, out):
        x = inputs[0].reshape(-1, mod.linear_1.in_features)
        out = out.reshape(x.shape[0], -1)
        keep("fused_mlp", ("sva_mlp", x.shape[0], x.shape[1], mod.linear_1.out_features,
                           out.shape[1]), lambda: mlp_site(x, mod.linear_1, mod.linear_2, out))

    original = sva.windowed_cross_attention

    def recording(q, k, v, mask=None, scale=None):
        out = original(q, k, v, mask, scale)
        key = (*k.shape, 0 if mask is None else mask.dim())
        keep("fused_windowed_cross_attention", key, lambda: dict(
            q=grab(q), k=grab(k), v=grab(v), mask=None if mask is None else grab(mask),
            out=grab(out)))
        return out

    handles = []
    for module in modules:
        for m in module.modules():
            if isinstance(m, LayerNorm):
                handles.append(m.register_forward_hook(on_norm))
            elif isinstance(m, ConvNeXtBlock):
                handles.append(m.dwconv.register_forward_hook(on_dwconv))
                first, second = on_pair(m)
                handles.append(m.pwconv1.register_forward_hook(first))
                handles.append(m.pwconv2.register_forward_hook(second))
            elif isinstance(m, sva.Mlp):
                handles.append(m.register_forward_hook(on_mlp))
    sva.windowed_cross_attention = recording
    try:
        with torch.no_grad():
            run()
    finally:
        sva.windowed_cross_attention = original
        for h in handles:
            h.remove()
    return sites


def site_work(kind, site):
    """(bytes moved once, operations, the rate's dtype) of one call at a site:
    each input read once, each output written once; K5-K7 run on the CUDA
    cores in fp32, K8 on the bf16 tensor cores."""
    if kind == "fused_layer_norm":
        x = site["x"]
        return 2 * x.numel() * x.element_size() + 8 * x.shape[-1], 8 * x.numel(), "float32"
    if kind == "depthwise_conv7x7":
        x = site["x"]
        # 49 multiply-adds and the bias per output element
        return 2 * x.numel() * x.element_size() + 50 * x.shape[-1] * 4, 99 * x.numel(), "float32"
    if kind == "fused_mlp":
        x, w1, w2 = site["x"], site["w1"], site["w2"]
        m, (c, h), c2 = x.shape[0], w1.shape, w2.shape[1]
        n_bytes = (m * c + c * h + h * c2 + m * c2) * x.element_size() + sum(
            4 * b.numel() for b in (site["b1"], site["b2"]) if b is not None)
        return n_bytes, 2 * m * h * (c + c2), str(x.dtype).replace("torch.", "")
    q, k = site["q"], site["k"]
    b, n_q, w, h, d = k.shape
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + (
        0 if site["mask"] is None else site["mask"].numel())
    # q.k and p.v (2 operations a multiply-add) and ~5 for the softmax, per key
    return n_bytes, b * n_q * h * w * (4 * d + 5), "float32"


def library_call(torch, kind, site):
    """{name: fn} of the PyTorch calls the main path (or a library) makes
    for the same function at this site; the first is ``library_ms``."""
    import torch.nn.functional as F

    from cambrian_tpu_torch.ops.activations import gelu_exact
    from cambrian_tpu_torch.ops.attention import NEG_INF, windowed_cross_attention
    from cambrian_tpu_torch.ops.norms import layer_norm

    if kind == "fused_layer_norm":
        x, w, b, eps = site["x"], site["weight"], site["bias"], site["eps"]
        wd, bd = w.to(x.dtype), b.to(x.dtype)
        return {"F.layer_norm": lambda: F.layer_norm(x, (x.shape[-1],), wd, bd, eps),
                "port layer_norm": lambda: layer_norm(x, w, b, eps)}
    if kind == "depthwise_conv7x7":
        xn, cw, cb = site["x_nchw"], site["conv_w"], site["conv_b"]
        return {"cudnn conv2d": lambda: F.conv2d(xn, cw, cb, padding=3, groups=xn.shape[1])}
    if kind == "fused_mlp":
        x, w1, b1, w2, b2 = (site[a] for a in ("x", "w1", "b1", "w2", "b2"))
        w1l, w2l = w1.t(), w2.t()      # nn.Linear's weights, read in place
        return {"nn.Linear x2 + gelu": lambda: F.linear(gelu_exact(F.linear(x, w1l, b1)), w2l, b2)}
    q, k, v, mask = site["q"], site["k"], site["v"], site["mask"]
    b, n_q, w, h, d = k.shape
    # batch-flattened: [B*Q, H, 1, D] queries over [B*Q, H, W, D] windows
    qf = q.reshape(b * n_q, h, 1, d)
    kf = k.reshape(b * n_q, w, h, d).transpose(1, 2).contiguous()
    vf = v.reshape(b * n_q, w, h, d).transpose(1, 2).contiguous()
    fmask = None
    if mask is not None:
        keep = mask.reshape(b * n_q, 1, 1, w)
        fmask = torch.zeros(keep.shape, dtype=q.dtype, device=q.device).masked_fill(~keep, NEG_INF)
    return {"sdpa": lambda: F.scaled_dot_product_attention(qf, kf, vf, attn_mask=fmask),
            "einsum path": lambda: windowed_cross_attention(q, k, v, mask)}


def extra_sites(torch, sites):
    """Cases beside the captured ones, not on the path: the training batch
    (B = 8) of K5 and of K7 at (64^2, 1536), made by repeating the captured
    request; K5 at its site with k and v as views whose heads lie W D apart
    (no tensor map: the first port's kernel, so both K5 functions are held
    against plain); K8 at an SVA site and K6 at the CLIP site with x moved one
    element off its alignment (TMA cannot address it: the mma.sync kernel;
    no 16-byte loads: the scalar layer_norm_kernel); one small fp32 case per
    kernel; a 4096-wide bf16 LayerNorm; K7 at a C whose positions are not
    whole 16-byte units (the first port's kernel)."""
    extra = []
    for key, s in sites["fused_windowed_cross_attention"].items():
        if key[0] == 1:
            rep = dict(q=s["q"].repeat(8, 1, 1, 1), k=s["k"].repeat(8, 1, 1, 1, 1),
                       v=s["v"].repeat(8, 1, 1, 1, 1), out=None,
                       mask=None if s["mask"] is None else s["mask"].repeat(
                           8, *([1] * (s["mask"].dim() - 1))))
            extra.append(("fused_windowed_cross_attention", ("train_b8", *rep["k"].shape), rep))
            # k and v as [B, Q, W, H, D] views of [B, Q, H, W, D] storage: no
            # tensor map, the first port's kernel
            strided = dict(s, out=None, **{
                t: s[t].transpose(2, 3).contiguous().transpose(2, 3) for t in ("k", "v")})
            extra.append(("fused_windowed_cross_attention", ("strided", *s["k"].shape), strided))
            break
    for key, s in sites["depthwise_conv7x7"].items():
        if key[1:] == (64, 64, 1536):
            xn = s["x_nchw"].repeat(8, 1, 1, 1)
            extra.append(("depthwise_conv7x7", ("train_b8", 8, 64, 64, 1536), dict(
                s, x=s["x"].repeat(8, 1, 1, 1), x_nchw=xn, out=None)))
    for key, s in sites["fused_mlp"].items():
        if key[0] == "sva_mlp":
            m, c = s["x"].shape
            store = torch.empty(1 + m * (c + 1), dtype=s["x"].dtype, device=s["x"].device)
            x = store[1:].view(m, c + 1)[:, :c]     # base 2 bytes off, rows of c + 1
            x.copy_(s["x"])
            extra.append(("fused_mlp", ("unaligned", *key[1:]), dict(s, x=x)))
            break
    ln_sites = sites["fused_layer_norm"]
    key = (1024, 577) if (1024, 577) in ln_sites else next(iter(ln_sites))
    x0 = ln_sites[key]["x"]
    store = torch.empty(1 + x0.numel(), dtype=x0.dtype, device=x0.device)
    x = store[1:].view(x0.shape)                # base one element off its 16 bytes
    x.copy_(x0)
    extra.append(("fused_layer_norm", ("unaligned", *key), dict(ln_sites[key], x=x)))
    dev = site_device(sites)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    mask = rnd(2, 70, 19) > -0.5
    mask[:, ::7] = False                # dead windows: uniform weights
    extra += [
        ("fused_windowed_cross_attention", ("fp32", 2, 70, 19, 3, 72), dict(
            q=rnd(2, 70, 3, 72), k=rnd(2, 70, 19, 3, 72), v=rnd(2, 70, 19, 3, 72), mask=mask,
            out=None)),
        ("fused_layer_norm", ("fp32", 100, 300), dict(
            x=rnd(300, 100) * 3 + 1, weight=rnd(100), bias=rnd(100), eps=1e-6, out=None)),
        # the decoder's width at the prompt's length (its norms are RMSNorms,
        # so the path has no LayerNorm this wide)
        ("fused_layer_norm", ("width4096", 4096, 645), dict(
            x=(rnd(645, 4096) * 3 + 1).bfloat16(), weight=rnd(4096), bias=rnd(4096), eps=1e-5,
            out=None)),
        ("depthwise_conv7x7", ("fp32", 2, 13, 11, 96), dict(
            x=rnd(2, 13, 11, 96), w=rnd(7, 7, 96) * 0.2, bias=rnd(96), out=None)),
        # 180 bytes a position: no tensor map, the first port's kernel; the
        # weight a ConvNeXt [C, 1, 7, 7] bf16 weight read in place
        ("depthwise_conv7x7", ("unaligned_c", 1, 13, 11, 90), dict(
            x=rnd(1, 13, 11, 90).bfloat16(),
            w=(rnd(90, 1, 7, 7) * 0.2).bfloat16()[:, 0].permute(1, 2, 0),
            bias=rnd(90).bfloat16(), out=None)),
        ("fused_mlp", ("fp32", 300, 48, 192, 40), dict(
            x=rnd(300, 48), w1=rnd(48, 192) * 0.1, b1=rnd(192) * 0.1, w2=rnd(192, 40) * 0.1,
            b2=rnd(40) * 0.1, out=None)),
    ]
    return extra


def site_device(sites):
    """The device the captured sites' tensors lie on."""
    return next(s for found in sites.values() for s in found.values())["out"].device


def mlp_functions(names):
    """K8's kernel functions among profiled kernel names, as ``name<BN>``."""
    pattern = rf"({'|'.join(MLP_FUNCTIONS)})<(\d+)>|({MLP_TC_FUNCTION}|{MLP_SIMT_FUNCTION})"
    return sorted({f"{m[0]}<{m[1]}>" if m[0] else m[2]
                   for n in names for m in re.findall(pattern, n)})


def mlp_expected_functions(torch, site):
    """The kernel functions K8's wrapper plans for a site's inputs."""
    from cambrian_tpu_torch.ops import fused_mlp

    x, w1, w2 = site["x"], site["w1"], site["w2"]
    plan = fused_mlp._plan(
        x.shape[0], x.shape[1], w1.shape[1], w2.shape[1], x.stride(0),
        (x.data_ptr(), w1.t().contiguous().data_ptr(), w2.t().contiguous().data_ptr()),
        x.dtype, torch.cuda.get_device_properties(x.device).multi_processor_count)
    if plan.route == "wgmma":
        return plan.route, [f"{fn}<{bn}>" for fn, bn in zip(MLP_FUNCTIONS,
                                                            (plan.bn_up, plan.bn_down))]
    return plan.route, [MLP_TC_FUNCTION if plan.route == "mma_sync" else MLP_SIMT_FUNCTION]


def templated_functions(names, functions):
    """The kernel functions of ``functions`` among profiled kernel names, as
    ``name<dtype,...>`` (dtype bf16 or float)."""
    out = set()
    for n in names:
        for fn, args in re.findall(rf"\b({'|'.join(functions)})<([^>]*)>", n):
            args = [a.strip().replace("__nv_bfloat16", "bf16") for a in args.split(",")]
            out.add(f"{fn}<{','.join(args)}>")
    return sorted(out)


def dw_expected_function(torch, site):
    """(the plan, its kernel function) of K7's wrapper for a site's inputs."""
    import functools

    from cambrian_tpu_torch.ops import cuda_build, dwconv

    x = site["x"]
    plan = dwconv._dw_plan(*x.shape, x.dtype, x.stride(), x.data_ptr() % 16 == 0,
                           dwconv._sms(x.device),
                           functools.partial(dwconv._occupancy, x.device,
                                             cuda_build.dtype_code(x)))
    t = "bf16" if x.dtype == torch.bfloat16 else "float"
    if plan.function == DW_TMA:
        return plan, f"{DW_TMA}<{t},{plan.rows},{plan.cols}>"
    return plan, f"{DW_OLD}<{t}>"


def sva_expected_function(torch, site):
    """(the plan, its kernel function) of K5's wrapper for a site's inputs."""
    import functools

    from cambrian_tpu_torch.ops import cuda_build, sva_attention

    q, k, v = site["q"], site["k"], site["v"]
    b, n_q, h, d = q.shape
    plan = sva_attention._sva_plan(
        b, n_q, h, k.shape[2], d, q.dtype, (q.stride(), k.stride(), v.stride()),
        all(t.data_ptr() % 16 == 0 for t in (q, k, v)), sva_attention._sms(q.device),
        functools.partial(sva_attention._occupancy, q.device, cuda_build.dtype_code(q)))
    t = "bf16" if q.dtype == torch.bfloat16 else "float"
    if plan.function == SVA_TMA:
        return plan, f"{SVA_TMA}<{t},{plan.lanes},{plan.window}>"
    return plan, f"{SVA_OLD}<{t}>"


def site_function_check(torch, mlp_cases, dw_cases, sva_cases, calls=3):
    """By kernel name, from one ``torch.profiler`` run of ``calls`` calls of
    every K8, K7 and K5 case (label, record, site). K8: every bf16 site of
    the path plans and runs the up and down wgmma GEMMs, the unaligned case
    the mma.sync kernel, the fp32 case the SIMT kernel; the mma.sync and SIMT
    kernels may run at most ``calls`` times, so no site but their own took
    them. K7 and K5: every case runs the function its plan names (the TMA
    kernel at every bf16 site of the path), and the first port's kernel runs
    no more often than the cases planned on it. One run for all: after some
    ten profiler sessions in one process, traces came back without kernels;
    and a trace of one call has lost one of its kernels."""
    planned = {label: mlp_expected_functions(torch, s) for label, _, s in mlp_cases}
    routed = {"depthwise_conv7x7": (dw_cases, dw_expected_function, DW_OLD),
              "fused_windowed_cross_attention": (sva_cases, sva_expected_function, SVA_OLD)}

    def run():
        for kind, cases in (("fused_mlp", mlp_cases), ("depthwise_conv7x7", dw_cases),
                            ("fused_windowed_cross_attention", sva_cases)):
            for _, _, s in cases:
                for _ in range(calls):
                    kernel_at_site(torch, kind, s)

    prof, _ = profiled(torch, run)
    launched = {}
    for _, n, key in kernel_events(prof):
        for fn in mlp_functions([key]) + templated_functions([key], DW_FUNCTIONS + SVA_FUNCTIONS):
            launched[fn] = launched.get(fn, 0) + n
    for label, rec, s in mlp_cases:
        route, functions = planned[label]
        want = ("simt" if rec["dtype"] == "float32" else
                "mma_sync" if "unaligned" in label else "wgmma")
        check(route == want, f"{label}: planned the {route} route, not {want}")
        check(all(fn in launched for fn in functions),
              f"{label}: planned {functions}; the profiled run launched {launched}")
        rec["functions"] = functions
        print(f"kernel fused_mlp {label} ran {' + '.join(functions)}", flush=True)
    for fn in (MLP_TC_FUNCTION, MLP_SIMT_FUNCTION):
        check(launched.get(fn, 0) <= calls, f"{fn} launched {launched.get(fn, 0)} times, more "
              f"than its own case's {calls}: a bf16 site took it")
    for kind, (cases, expected, old_fn) in routed.items():
        old_cases = 0
        for label, rec, s in cases:
            plan, function = expected(torch, s)
            check(plan.function == rec["function"], f"{label}: planned {plan.function}, the "
                  f"counter saw {rec['function']}")
            check(launched.get(function, 0) >= calls,
                  f"{label}: planned {function}; the profiled run launched {launched}")
            old_cases += plan.function == old_fn
            rec["functions"] = [function]
            rec["plan"] = list(plan)
            print(f"kernel {kind} {label} ran {function} (plan {tuple(plan)[1:]})", flush=True)
        old = sum(n for fn, n in launched.items() if fn.startswith(old_fn + "<"))
        check(old <= old_cases * calls, f"{old_fn} launched {old} times, more than the "
              f"{old_cases * calls} calls of the cases planned on it")


def max_err(torch, out, ref):
    return float((out.float() - ref.float()).abs().max()), max(1.0, float(ref.abs().max()))


def backward_checks(torch, sites):
    """K5, K6 and K7 through their autograd Functions on the card (bf16)
    against the plain backward on the fp32-upcast inputs, at one site each;
    returns {kind: {"err", "tol", "key"}}."""
    from cambrian_tpu_torch.ops import dwconv, norms, sva_attention

    picks = {
        "fused_windowed_cross_attention": lambda k: k[0] == 1,
        "fused_layer_norm": lambda k: k[0] == 1024,
        "depthwise_conv7x7": lambda k: k[1:] == (64, 64, 1536),
    }
    dev = site_device(sites)
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for kind, pick in picks.items():
        key = next((k for k in sites[kind] if pick(k)), next(iter(sites[kind])))
        s = sites[kind][key]
        # copies: the sites were captured under the engine's inference mode
        args = [a.clone() if torch.is_tensor(a) else a for a in _site_args(torch, kind, s)]
        leaves = [a.requires_grad_(True) for a in args[:3]]
        fwd = _site_fns(kind)[0](*leaves, *args[3:])
        cot = torch.randn(fwd.shape, generator=g, device=dev).to(fwd.dtype)
        got = torch.autograd.grad(fwd, leaves, cot)
        up = [a.detach().float() if torch.is_tensor(a) and a.is_floating_point() else a
              for a in args]
        if kind == "fused_layer_norm":
            want = norms.fused_layer_norm_bwd_reference(up[0], up[1], cot.float(), up[3])
        elif kind == "depthwise_conv7x7":
            want = dwconv.depthwise_conv7x7_bwd_reference(up[0], up[1], cot.float())
        else:
            want = sva_attention.fused_windowed_cross_attention_bwd_reference(
                up[0], up[1], up[2], up[3], cot.float())
        errs, tols = [], []
        for name, a, e in zip(("d0", "d1", "d2"), got, want):
            check(torch.isfinite(a).all().item(), f"{kind} backward {name}: non-finite")
            err, scale = max_err(torch, a, e)
            errs.append(err)
            tols.append(SITE_REL_PLAIN * scale)
            check(err <= tols[-1], f"{kind} backward {key} {name}: max abs error {err} > "
                  f"{tols[-1]}")
        out[kind] = dict(key=list(key), errs=errs, tols=tols)
        print(f"backward {kind} at {key}: max abs errors {[f'{e:.3e}' for e in errs]} (tol "
              f"{[f'{t:.2e}' for t in tols]})", flush=True)
        del leaves, fwd, got, want, cot
    return out


def vision_kernel_phase(torch, fa, quant, sites):
    """K5-K8 on the inputs captured at their drop-in sites of one warm
    Cambrian-8B bf16 request: a drop-in pass (every site shape once, counts
    zeroed before and read after), then each kernel against its plain version
    on fp32-upcast inputs and against the main path's output at the site,
    CUDA-event times (L2 flushed before each call) of the kernel, the plain
    version and the library call, the bound, and backward checks."""
    from cambrian_tpu_torch.ops import dwconv, norms, sva_attention

    dev = site_device(sites)
    sva_fn = sva_attention.fused_windowed_cross_attention
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False     # plain fp32 products in fp32
    counters = all_counters(fa, quant)
    zero_counts(counters)                              # this slice's path starts here
    norms.fused_layer_norm.function_launches.clear()
    dwconv.depthwise_conv7x7.function_launches.clear()
    sva_fn.function_launches.clear()
    outs = {(kind, key): kernel_at_site(torch, kind, s)
            for kind, found in sites.items() for key, s in found.items()}
    torch.cuda.synchronize()
    launches = read_counts(counters)
    ln_functions = dict(norms.fused_layer_norm.function_launches)
    dw_functions_run = dict(dwconv.depthwise_conv7x7.function_launches)
    sva_functions_run = dict(sva_fn.function_launches)
    want = {name: len(sites.get(name, {})) for name in counters}
    check(launches == want, f"K5-K8 drop-in pass launched {launches}, not {want} (one per site "
          f"shape)")
    check(ln_functions == {LN_VEC: want["fused_layer_norm"]},
          f"K6 drop-in pass ran {ln_functions}, not {LN_VEC} at every site shape")
    check(dw_functions_run == {DW_TMA: want["depthwise_conv7x7"]},
          f"K7 drop-in pass ran {dw_functions_run}, not {DW_TMA} at every site shape")
    check(sva_functions_run == {SVA_TMA: want["fused_windowed_cross_attention"]},
          f"K5 drop-in pass ran {sva_functions_run}, not {SVA_TMA} at every site shape")
    l2 = torch.zeros(16 << 20, dtype=torch.float32, device=dev)
    flush = l2.sum
    records = []
    mlp_cases = []      # K8's, K7's and K5's cases, checked by kernel name at the end
    dw_cases = []
    sva_cases = []
    cases = [(kind, key, s, True) for kind, found in sites.items() for key, s in found.items()]
    cases += [(kind, key, s, False) for kind, key, s in extra_sites(torch, sites)]
    for kind, key, s, on_path in cases:
        out = outs.pop((kind, key)) if on_path else kernel_at_site(torch, kind, s)
        torch.cuda.synchronize()
        label = f"{kind} {key}"
        x0 = _site_args(torch, kind, s)[0]
        dtype_name = str(x0.dtype).replace("torch.", "")
        check(torch.isfinite(out).all().item(), f"{label}: non-finite output")
        ref = plain_at_site(torch, kind, s, upcast=True)
        check(out.shape == ref.shape and out.dtype == x0.dtype,
              f"{label}: {tuple(out.shape)} {out.dtype}")
        err, scale = max_err(torch, out, ref)
        tol = (SITE_REL_PLAIN if x0.dtype == torch.bfloat16 else 1e-4) * scale
        check(err <= tol, f"{label}: max abs error {err} against the plain version > {tol}")
        main_err = main_tol = None
        if s.get("out") is not None:
            main_err, scale = max_err(torch, out, s["out"])
            main_tol = SITE_REL_MAIN * scale
            check(main_err <= main_tol, f"{label}: max abs error {main_err} against the main "
                  f"path's output > {main_tol}")
        del out, ref
        function = None
        if kind == "fused_layer_norm":
            # K6's kernel function, by its counter; every aligned bf16 site of
            # the path takes the 16-byte row pass
            counts = norms.fused_layer_norm.function_launches
            counts.clear()
            kernel_at_site(torch, kind, s)
            torch.cuda.synchronize()
            check(len(counts) == 1 and sum(counts.values()) == 1, f"{label}: launched {counts}")
            function = next(iter(counts))
            x = s["x"]
            if on_path and x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0:
                check(function == LN_VEC, f"{label}: an aligned bf16 site ran {function}")
            if key[0] == "unaligned":
                check(function == LN_SCALAR, f"{label}: an unaligned base ran {function}")
        if kind == "depthwise_conv7x7":
            # K7's kernel function, by its counter: the TMA kernel at every
            # case a tensor map addresses, the first port's at the rest
            counts = dwconv.depthwise_conv7x7.function_launches
            counts.clear()
            kernel_at_site(torch, kind, s)
            torch.cuda.synchronize()
            check(len(counts) == 1 and sum(counts.values()) == 1, f"{label}: launched {counts}")
            function = next(iter(counts))
            want_fn = DW_OLD if key[0] == "unaligned_c" else DW_TMA
            check(function == want_fn, f"{label}: ran {function}, not {want_fn}")
        if kind == "fused_windowed_cross_attention":
            # K5's kernel function, by its counter: the TMA kernel at every
            # case but the one whose k and v no tensor map addresses
            counts = sva_fn.function_launches
            counts.clear()
            kernel_at_site(torch, kind, s)
            torch.cuda.synchronize()
            check(len(counts) == 1 and sum(counts.values()) == 1, f"{label}: launched {counts}")
            function = next(iter(counts))
            want_fn = SVA_OLD if key[0] == "strided" else SVA_TMA
            check(function == want_fn, f"{label}: ran {function}, not {want_fn}")
        big = kind == "fused_mlp" or key[0] == "train_b8"
        iters = 5 if big else 10
        library = {}
        if kind == "fused_layer_norm":
            # medians of LN_ITERS, in turns with the plain version and the
            # PyTorch calls the path could make
            t = cuda_ms_turns(torch, {"kernel": lambda: kernel_at_site(torch, kind, s),
                                      "plain": lambda: plain_at_site(torch, kind, s),
                                      **library_call(torch, kind, s)},
                              LN_ITERS, flush, SITE_SPIN_CYCLES)
            ms, plain_ms = t.pop("kernel"), t.pop("plain")
            library = t
        elif kind == "depthwise_conv7x7":
            # medians of DW_ITERS, in turns with the plain version, the first
            # port's kernel (forced through the plan) and the main path's
            # F.conv2d on its NCHW input
            x, w, b = _site_args(torch, kind, s)
            fns = {"kernel": lambda: kernel_at_site(torch, kind, s),
                   "plain": lambda: plain_at_site(torch, kind, s)}
            if function == DW_TMA:
                fns[DW_OLD] = lambda: dwconv._dwconv_kernel(x, w, b, DW_OLD)
            if "x_nchw" in s:
                fns.update(library_call(torch, kind, s))
            t = cuda_ms_turns(torch, fns, DW_ITERS, flush, SITE_SPIN_CYCLES)
            ms, plain_ms = t.pop("kernel"), t.pop("plain")
            first_port_ms = t.pop(DW_OLD, ms)
            library = t
        elif kind == "fused_windowed_cross_attention":
            # medians of SVA_ITERS, in turns with the plain version, the first
            # port's kernel (forced through the plan), SDPA on the
            # batch-flattened windows and the main path's einsums
            q, k, v, m = _site_args(torch, kind, s)
            fns = {"kernel": lambda: kernel_at_site(torch, kind, s),
                   "plain": lambda: plain_at_site(torch, kind, s)}
            if function == SVA_TMA:
                fns[SVA_OLD] = lambda: sva_attention._sva_kernel(q, k, v, m, q.shape[-1] ** -0.5,
                                                                 SVA_OLD)
            fns.update(library_call(torch, kind, s))
            t = cuda_ms_turns(torch, fns, SVA_ITERS, flush, SITE_SPIN_CYCLES)
            ms, plain_ms = t.pop("kernel"), t.pop("plain")
            first_port_ms = t.pop(SVA_OLD, ms)
            library = t
        else:
            ms = cuda_ms(torch, lambda: kernel_at_site(torch, kind, s), iters, flush,
                         SITE_SPIN_CYCLES)
            plain_ms = cuda_ms(torch, lambda: plain_at_site(torch, kind, s), iters, flush,
                               SITE_SPIN_CYCLES)
            if "x_nchw" in s or kind != "depthwise_conv7x7":
                library = {name: cuda_ms(torch, fn, iters, flush, SITE_SPIN_CYCLES)
                           for name, fn in library_call(torch, kind, s).items()}
        n_bytes, n_ops, rate = site_work(kind, s)
        bound_ms, bound_by, bytes_ms, ops_ms = bound(n_bytes, n_ops, rate)
        rec = dict(kernel=kind, site=[str(k) for k in key], dtype=dtype_name,
                   per_request=s.get("count", 0) if on_path else 0, max_abs_err=err, tol=tol,
                   main_path_err=main_err, main_path_tol=main_tol, ms=ms, plain_ms=plain_ms,
                   library=library, library_ms=next(iter(library.values()), None),
                   bound_ms=bound_ms, bound_by=bound_by, bytes_ms=bytes_ms, ops_ms=ops_ms,
                   function=function)
        records.append(rec)
        rate = ""
        if kind == "fused_layer_norm":
            rec["vs_library"] = ms / rec["library_ms"]
            rate = (f" {function} {rec['vs_library']:.3f}x F.layer_norm (<= 1.02x: "
                    f"{rec['vs_library'] <= 1.02}), {bound_ms / ms:.1%} of bound, "
                    f"{2 * x0.numel() * x0.element_size() / 1e6:.1f} MB")
        if kind == "fused_mlp":
            rec["flops"], rec["tflops"] = n_ops, n_ops / (ms * 1e9)
            rate = f" {rec['tflops']:.1f} TFLOP/s"
            mlp_cases.append((label, rec, s))
        if kind in ("depthwise_conv7x7", "fused_windowed_cross_attention"):
            rec["first_port_ms"] = first_port_ms
            rate = (f" {function}, first port {first_port_ms:.4f} ms, {bound_ms / ms:.1%} of "
                    f"bound")
            (dw_cases if kind == "depthwise_conv7x7" else sva_cases).append((label, rec, s))
        lib = " ".join(f"{n}={t:.4f} ms" for n, t in library.items())
        main = "" if main_err is None else f" main-path err={main_err:.3e} (tol {main_tol:.2e})"
        print(f"kernel {kind:13s} {str(key):40s} x{rec['per_request']:<3d} {dtype_name:8s} "
              f"err={err:.3e} (tol {tol:.2e}){main} kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
              f"{lib} bound={bound_ms:.4f} ms ({bound_by}){rate}", flush=True)
    del l2
    ran = {r["function"] for r in records if r["kernel"] == "fused_layer_norm"}
    check(ran == set(LN_FUNCTIONS), f"K6's cases ran {ran}, not both of {LN_FUNCTIONS}")
    ran = {r["function"] for r in records if r["kernel"] == "depthwise_conv7x7"}
    check(ran == set(DW_FUNCTIONS), f"K7's cases ran {ran}, not both of {DW_FUNCTIONS}")
    ran = {r["function"] for r in records if r["kernel"] == "fused_windowed_cross_attention"}
    check(ran == set(SVA_FUNCTIONS), f"K5's cases ran {ran}, not both of {SVA_FUNCTIONS}")
    site_function_check(torch, mlp_cases, dw_cases, sva_cases)
    bwd = backward_checks(torch, sites)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    torch.cuda.empty_cache()
    ln = [r for r in records if r["kernel"] == "fused_layer_norm" and r["per_request"]]
    k6 = {key: sum(r[key] * r["per_request"] for r in ln) for key in ("ms", "library_ms")}
    print(f"fused_layer_norm: a request's {sum(r['per_request'] for r in ln)} sites, medians of "
          f"{LN_ITERS}: kernel {k6['ms']:.3f} ms, F.layer_norm {k6['library_ms']:.3f} ms "
          f"(below: {k6['ms'] < k6['library_ms']}); every site within 1.02x: "
          f"{all(r['vs_library'] <= 1.02 for r in ln)}", flush=True)
    dw = [r for r in records if r["kernel"] == "depthwise_conv7x7" and r["per_request"]]
    k7 = {key: sum(r[key] * r["per_request"] for r in dw)
          for key in ("ms", "first_port_ms", "library_ms", "bound_ms")}
    print(f"depthwise_conv7x7: a request's {sum(r['per_request'] for r in dw)} sites, medians "
          f"of {DW_ITERS}: kernel {k7['ms']:.3f} ms, first port {k7['first_port_ms']:.3f} ms, "
          f"F.conv2d {k7['library_ms']:.3f} ms, bound {k7['bound_ms']:.4f} ms; every site faster "
          f"than both: {all(r['ms'] < min(r['first_port_ms'], r['library_ms']) for r in dw)}; "
          f"shares of bound {[round(r['bound_ms'] / r['ms'], 3) for r in dw]}", flush=True)
    sva = [r for r in records if r["kernel"] == "fused_windowed_cross_attention"]
    on_path = [r for r in sva if r["per_request"]]
    k5 = {key: sum(r[key] * r["per_request"] for r in on_path)
          for key in ("ms", "first_port_ms", "library_ms", "bound_ms")}
    k5["einsum"] = sum(r["library"]["einsum path"] * r["per_request"] for r in on_path)
    faster = all(r["ms"] < min(r["first_port_ms"], *r["library"].values())
                 for r in sva if r["function"] == SVA_TMA)
    print(f"fused_windowed_cross_attention: a request's {sum(r['per_request'] for r in on_path)} "
          f"calls, medians of {SVA_ITERS}: kernel {k5['ms']:.4f} ms, first port "
          f"{k5['first_port_ms']:.4f} ms, sdpa {k5['library_ms']:.4f} ms, einsum path "
          f"{k5['einsum']:.4f} ms, bound {k5['bound_ms']:.4f} ms; every {SVA_TMA} case faster "
          f"than the first port, sdpa and the einsum path: {faster}; shares of bound "
          f"{[(r['site'][0], round(r['bound_ms'] / r['ms'], 3)) for r in sva]}", flush=True)
    return dict(records=records, launches=launches, ln_functions=ln_functions,
                dw_functions=dw_functions_run, sva_functions=sva_functions_run, backward=bwd,
                sites={kind: {str(k): s["count"] for k, s in found.items()}
                       for kind, found in sites.items()})


# -- phase 13: the encoder-study towers ---------------------------------------

def zoo_tower(torch, name, seed, dtype, device):
    """A tower of the registry with random weights made on ``device`` from
    ``seed`` (N(0, 0.02) matrices, unit norm weights, zero biases), built on
    the meta device first so that no second copy is made."""
    from cambrian_tpu_torch.checkpoint.from_jax import load_state_dict_checked
    from cambrian_tpu_torch.models.builder import _random_like
    from cambrian_tpu_torch.models.encoders.base import build_vision_tower

    with torch.device("meta"):
        tower = build_vision_tower(name, dtype=dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    load_state_dict_checked(tower, _random_like(tower.state_dict(), g, 0.02, device),
                            assign=True)
    return tower.eval()


class K1Recorder:
    """Wraps the ``flash_attention`` the ViT and SD-2.1 modules call: while
    ``keep`` is set, the first call of each (B, Sq, H, D) keeps copies of its
    q, k, v; ``calls`` counts the calls of each shape. The real function runs
    every call, so the launch counter counts them."""

    def __init__(self):
        from cambrian_tpu_torch.models.encoders import diffusion, vit

        self.modules = (vit, diffusion)
        self.real = vit.flash_attention
        self.inputs, self.calls, self.keep = {}, {}, False

    def __call__(self, q, k, v, *args, **kwargs):
        key = (q.shape[0], q.shape[1], q.shape[2], q.shape[3])
        if self.keep:
            self.calls[key] = self.calls.get(key, 0) + 1
            if key not in self.inputs:
                self.inputs[key] = tuple(t.detach().clone() for t in (q, k, v))
        return self.real(q, k, v, *args, **kwargs)

    def __enter__(self):
        for m in self.modules:
            m.flash_attention = self
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.flash_attention = self.real


def zoo_tiny_phase(torch, fa, quant):
    """(a) a tiny tower of each new family on the card against the same on
    the CPU, fp32 with TF32 off, from the same weights and pixels (SD-2.1's
    noise passed to both); K1's launches on the card by counter."""
    from cambrian_tpu_torch.mm_utils import IMAGENET_MEAN, IMAGENET_STD
    from cambrian_tpu_torch.models.builder import _random_like
    from cambrian_tpu_torch.models.encoders import extra
    from cambrian_tpu_torch.models.encoders.base import build_vision_tower
    from cambrian_tpu_torch.models.encoders.sam import SamViT, SamViTConfig
    from cambrian_tpu_torch.models.encoders.vit import ViTConfig

    tiny = dict(hidden_size=32, num_layers=3, num_heads=4, intermediate_size=64, patch_size=8,
                image_size=32, class_token=True, ln_eps=1e-6)
    vits = {
        "plain_vit": dict(tiny),
        "dfn": dict(tiny, pre_layernorm=True, final_layernorm=False, act="quick_gelu",
                    patch_bias=False, select_layer=-2, ln_eps=1e-5),
        "eva02": dict(tiny, intermediate_size=43, final_layernorm=False, select_layer=-2,
                      k_bias=False, rope=True, rope_ref_side=2, swiglu_ln=True),
        "dpt": dict(tiny, final_layernorm=False, select_layer=-1, ln_eps=1e-12),
        "beit": dict(tiny, final_layernorm=False, select_layer=-1, ln_eps=1e-12, k_bias=False,
                     abs_pos_embed=False, rel_pos_bias=True, layer_scale=True),
    }
    # family: (builder on a device, pixels' side, K1 launches a forward: a
    # block that runs, none with BEiT's bias)
    families = {name: ((lambda dev, kw=kw, name=name: extra._vit_tower(
        name, ViTConfig(**kw), None, 9, torch.float32, dev, IMAGENET_MEAN, IMAGENET_STD)),
        32, 0 if kw.get("rel_pos_bias") else ViTConfig(**kw).num_blocks_to_run)
        for name, kw in vits.items()}
    families["sam"] = (lambda dev: SamViT(SamViTConfig(
        hidden_size=32, num_layers=3, num_heads=4, mlp_ratio=2.0, patch_size=8, image_size=64,
        window_size=3, global_attn_indexes=(1,), output_channels=16), device=dev), 64, 0)
    families["hybrid"] = (lambda dev: build_vision_tower(
        "hybridmodel-debug-tower-res32-interp4-&&&-debug-tower-res32-interp9", device=dev),
        32, 4)
    families["tiny_sd"] = (lambda dev: build_vision_tower("diffusion-tiny-res128", device=dev),
                           128, 3)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = all_counters(fa, quant)
    records = {}
    try:
        for i, (name, (make, size, k1)) in enumerate(families.items()):
            cpu = make("cpu").eval()
            sd = _random_like(cpu.state_dict(), torch.Generator().manual_seed(SEED + i), 0.05)
            cpu.load_state_dict(sd)
            gpu = make("cuda").eval()
            gpu.load_state_dict({k: v.cuda() for k, v in sd.items()})
            rng = np.random.default_rng(SEED + i)
            px = torch.from_numpy(rng.standard_normal((2, 3, size, size), dtype=np.float32))
            kw = {}
            if name == "tiny_sd":
                kw["noise"] = torch.from_numpy(
                    rng.standard_normal((2, 4, size // 8, size // 8), dtype=np.float32))
            with torch.no_grad():
                want = cpu(px, **kw)
                zero_counts(counters)
                got = gpu(px.cuda(), **{k: v.cuda() for k, v in kw.items()})
                torch.cuda.synchronize()
                counts = read_counts(counters)
            err = float((got.cpu() - want).abs().max())
            scale = float(want.abs().max())
            tol = 1e-4 * max(1.0, scale)
            print(f"phase 13 (a) tiny {name}: out {tuple(got.shape)} max abs err {err:.3e} "
                  f"(|ref| <= {scale:.3f}, tol {tol:.1e}) K1 launches "
                  f"{counts['flash_attention_fwd']}", flush=True)
            check(got.shape == want.shape and torch.isfinite(got).all().item(),
                  f"tiny {name}: {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
            check(err <= tol, f"tiny {name}: card and CPU differ by {err} > {tol}")
            want_counts = {k: 0 for k in counters}
            want_counts["flash_attention_fwd"] = k1
            check(counts == want_counts, f"tiny {name}: launches {counts}, not {want_counts}")
            records[name] = dict(max_abs_err=err, ref_max=scale, tol=tol, launches=counts)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return records


def zoo_k1_case(torch, fa, q, k, v, flush):
    """K1 against its plain version on a captured call's inputs (bf16; the
    plain version in fp32 on the upcast inputs, the tolerance 2e-2 of the
    output's scale, as phase 2's unit-scale cases), and K1, plain and SDPA
    alone: L2 flushed, behind a spin kernel, medians of 30."""
    import torch.nn.functional as F

    b, s, h, d = q.shape
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    err = float((out.float() - ref).abs().max())
    tol = 2e-2 * max(1.0, float(ref.abs().max()))
    check(torch.isfinite(out).all().item(), f"K1 at {tuple(q.shape)}: non-finite output")
    check(err <= tol, f"K1 at {tuple(q.shape)}: max abs error {err} > {tol}")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    times = {key: cuda_ms(torch, fn, iters=30, flush=flush, spin=SITE_SPIN_CYCLES, median=True)
             for key, fn in (("ms", lambda: fa.flash_attention(q, k, v)),
                             ("plain_ms", lambda: fa.flash_attention_reference(q, k, v)),
                             ("library_ms", lambda: F.scaled_dot_product_attention(qt, kt, vt)))}
    n_bytes = 4 * q.numel() * q.element_size()        # q, k, v read, out written
    bound_ms, bound_by, bytes_ms, ops_ms = bound(n_bytes, 4 * b * h * d * s * s, "bfloat16")
    return dict(b=b, s=s, h=h, d=d, max_abs_err=err, tol=tol, bound_ms=bound_ms,
                bound_by=bound_by, bytes_ms=bytes_ms, ops_ms=ops_ms,
                tflops=4 * b * h * d * s * s / times["ms"] / 1e9, **times)


def zoo_full_phase(torch, fa, quant):
    """(b) each registered tower at its published width, depth and resolution
    in bf16, weights made on the card, one at a time: a forward at batch 1
    and at 8 (shape, finiteness, medians of ZOO_ITERS, peak memory), K1's
    launches by counter against ZOO_TOWERS; then K1 at each new shape the
    towers gave it, on the captured inputs, against its plain version, and
    timed beside it and SDPA. Returns (records, K1 cases by "BxSxHxD", the
    path's launches)."""
    dev = torch.device("cuda")
    counters = all_counters(fa, quant)
    path = {name: 0 for name in counters}
    l2 = torch.zeros(16 << 20, dtype=torch.float32, device=dev)
    records, cases = [], {}
    for i, (name, k1) in enumerate(ZOO_TOWERS):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tower = zoo_tower(torch, name, SEED + 13 + i, torch.bfloat16, dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in tower.parameters())
        rec = dict(tower=name, params=n_params, build_s=build_s, image_size=tower.image_size,
                   hidden_size=tower.hidden_size, batches={})
        g = torch.Generator(device=dev).manual_seed(SEED + 13)
        with K1Recorder() as k1_calls, torch.inference_mode():
            zero_counts(counters)                 # this tower's path starts here
            for b in ZOO_BATCHES:
                px = torch.randn((b, 3, tower.image_size, tower.image_size), generator=g,
                                 device=dev)
                k1_calls.keep = True
                out = tower(px)
                k1_calls.keep = False
                torch.cuda.synchronize()
                want = (b, tower.num_patches, tower.hidden_size)
                check(tuple(out.shape) == want, f"{name} batch {b}: {tuple(out.shape)}, "
                      f"not {want}")
                finite = bool(torch.isfinite(out).all().item())
                check(finite, f"{name} batch {b}: non-finite features")
                times = []
                for _ in range(ZOO_ITERS):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    tower(px)
                    end.record()
                    times.append((start, end))
                torch.cuda.synchronize()
                ms = float(np.median([s_.elapsed_time(e) for s_, e in times]))
                rec["batches"][b] = dict(shape=list(out.shape), finite=finite, ms=ms,
                                         images_per_s=b / ms * 1e3)
            counts = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
        forwards = len(ZOO_BATCHES) * (1 + ZOO_ITERS)
        want_counts = {k: 0 for k in counters}
        want_counts["flash_attention_fwd"] = k1 * forwards
        check(counts == want_counts, f"{name}: launches {counts}, not {want_counts} "
              f"({k1} K1 a forward)")
        per_forward = {key: n for key, n in k1_calls.calls.items() if key[0] == ZOO_BATCHES[0]}
        check(sum(per_forward.values()) == k1, f"{name}: K1 calls at batch 1 "
              f"{per_forward}, not {k1}")
        for key, n in counts.items():
            path[key] += n
        rec.update(k1_per_forward=k1, launches=counts, peak_bytes=peak,
                   k1_shapes={"x".join(map(str, key)): n for key, n in k1_calls.calls.items()})
        print(f"phase 13 (b) {name}: {n_params / 1e9:.3f}B parameters built in {build_s:.1f} s; "
              + "; ".join(f"batch {b}: {tuple(r['shape'])} finite, {r['ms']:.2f} ms "
                          f"({r['images_per_s']:.1f} images/s)"
                          for b, r in rec["batches"].items())
              + f"; peak {peak / 2**30:.2f} GiB; K1 {counts['flash_attention_fwd']} launches "
              f"({k1} a forward x {forwards})", flush=True)
        # K1 at each new shape: on the captured inputs, outside the path's count
        for key, (q, k, v) in k1_calls.inputs.items():
            with torch.inference_mode():
                case = zoo_k1_case(torch, fa, q, k, v, l2.sum)
            case.update(tower=name, calls_per_forward=k1_calls.calls[key])
            cases.setdefault("x".join(map(str, key)), case)
            print(f"phase 13 K1 {name} B={key[0]} S={key[1]} H={key[2]} D={key[3]}: err "
                  f"{case['max_abs_err']:.3e} (tol {case['tol']:.2e}) kernel {case['ms']:.4f} ms "
                  f"({case['tflops']:.1f} TFLOP/s) plain {case['plain_ms']:.4f} sdpa "
                  f"{case['library_ms']:.4f} bound {case['bound_ms'] * 1e3:.2f} us "
                  f"({case['bound_by']})", flush=True)
        records.append(rec)
        del tower, k1_calls, out, px
        gc.collect()
        torch.cuda.empty_cache()
    return records, cases, path


def tower_encode_times(torch, towers):
    """Forward hooks that put CUDA events around each tower's forward;
    returns (the hooks' handles, {tower index: [(start, end), ...]})."""
    events, handles = {}, []
    for i, t in enumerate(towers):
        def pre(mod, args, i=i):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            events.setdefault(i, []).append([start, None])

        def post(mod, args, out, i=i):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events[i][-1][1] = end
        handles += [t.register_forward_pre_hook(pre), t.register_forward_hook(post)]
    return handles, events


def zoo_cambrian_phase(torch, fa, quant, prompts):
    """(c) Cambrian-8B through ``generate`` with EVA-02-L/14-336 in CLIP-L's
    place and SD-2.1 in ConvNeXt-XXL's, bf16 weights made on the card:
    three requests of 32 greedy tokens, each launching K1 ZOO_8B_K1 times and
    none of K5-K8; encode ms by tower, prefill ms, decode tokens/s."""
    from cambrian_tpu_torch import cambrian_8b
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict

    dev = torch.device("cuda")
    cfg = cambrian_8b().replace(mm_vision_tower_aux_list=ZOO_8B_TOWERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = random_state_dict(cfg, torch.Generator(device=dev).manual_seed(SEED), 0.02,
                           dtype=torch.bfloat16, device=dev)
    model = CambrianForInference.from_state_dict(cfg, sd, torch.bfloat16)
    del sd
    torch.cuda.synchronize()
    print(f"phase 13 (c) 8B with towers {ZOO_8B_TOWERS}: built in "
          f"{time.perf_counter() - t0:.1f} s; hidden sizes "
          f"{[t.hidden_size for t in model.towers]}, tokens "
          f"{[t.num_patches for t in model.towers]}", flush=True)
    counters = all_counters(fa, quant)
    handles, events = tower_encode_times(torch, model.towers)
    requests = []
    try:
        zero_counts(counters)                     # the main path's count starts here
        for r, pr in enumerate(prompts):
            rec = serve_request(torch, model, counters, cfg, r, pr, k1=ZOO_8B_K1)
            torch.cuda.synchronize()
            rec["encode_ms_by_tower"] = {
                name: events[i][-1][0].elapsed_time(events[i][-1][1])
                for i, name in enumerate(ZOO_8B_TOWERS)}
            print(f"phase 13 (c) request {r}: encode by tower "
                  + ", ".join(f"{n} {ms:.1f} ms" for n, ms in rec["encode_ms_by_tower"].items()),
                  flush=True)
            requests.append(rec)
        launches = read_counts(counters)
    finally:
        for h in handles:
            h.remove()
    unused = {k: launches[k] for k in VISION_KERNELS if launches[k]}
    check(not unused, f"phase 13 (c): the main path launched K5-K8 {unused}")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 13 (c) peak memory allocated: {peak / 2**30:.2f} GiB", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(towers=list(ZOO_8B_TOWERS), requests=requests, launches=launches,
                peak_bytes=peak)


def zoo_phase(torch, fa, quant, prompts):
    """Phase 13: (a) tiny parity, (b) the full-width towers, (c) the
    swapped-tower Cambrian-8B."""
    t0 = time.perf_counter()
    tiny = zoo_tiny_phase(torch, fa, quant)
    towers, cases, path = zoo_full_phase(torch, fa, quant)
    cambrian = zoo_cambrian_phase(torch, fa, quant, prompts)
    print(f"phase 13 (encoder-study towers): {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(tiny=tiny, towers=towers, k1_cases=cases, launches=path, cambrian=cambrian)


# -- phase 14: the decoder families --------------------------------------------

def family_tiny_phase(torch, fa, quant, rng):
    """(a) a tiny Cambrian of each of FAMILY_TINY on the card against the
    same on the CPU (fp32, TF32 off, the same weights and a 159-slot prompt,
    so that the prefill takes the flash route where the family allows it):
    identical greedy tokens; K1 a tower block and a decoder layer, none in
    the decoder under the attention softcap."""
    from cambrian_tpu_torch import IMAGE_TOKEN_INDEX, tiny_debug
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = all_counters(fa, quant)
    records = {}
    try:
        for i, (name, switches) in enumerate(FAMILY_TINY.items()):
            cfg = tiny_debug(num_towers=2).replace(tokenizer_model_max_length=192, **switches)
            sd = random_state_dict(cfg, torch.Generator().manual_seed(SEED + i), 0.05,
                                   dtype=torch.float32, device="cpu")
            cpu = CambrianForInference.from_state_dict(cfg, sd, torch.float32,
                                                       cache_dtype=torch.float32)
            gpu = CambrianForInference.from_state_dict(
                cfg, {k: v.cuda() for k, v in sd.items()}, torch.float32,
                cache_dtype=torch.float32)
            ids = rng.integers(5, cfg.vocab_size, 140)
            ids[cfg.image_position] = IMAGE_TOKEN_INDEX
            images = [rng.standard_normal((1, 3, t.image_size, t.image_size)).astype(np.float32)
                      for t in cpu.towers]
            kw = dict(images=images, image_sizes=[(640, 360)], max_new_tokens=8,
                      eos_token_id=None)
            want = cpu.generate(ids, **kw)
            zero_counts(counters)
            got = gpu.generate(ids, **kw)
            counts = read_counts(counters)
            err = float((gpu.engine.last_next_logits.cpu() - cpu.engine.last_next_logits)
                        .abs().max())
            decoder_k1 = 0 if cfg.attn_logit_softcapping else cfg.num_hidden_layers
            expected = {k: 0 for k in counters}
            expected["flash_attention_fwd"] = (sum(t.config.num_blocks_to_run
                                                   for t in gpu.towers) + decoder_k1)
            print(f"phase 14 (a) tiny {name}: cpu tokens {want.tolist()} gpu tokens "
                  f"{got.tolist()}; first-token logits max abs diff {err:.3e}; K1 launches "
                  f"{counts['flash_attention_fwd']} ({decoder_k1} in the decoder)", flush=True)
            check(got.shape == (1, 8) and (got == want).all(), f"tiny {name}: tokens differ")
            check(counts == expected, f"tiny {name}: launches {counts}, not {expected}")
            check(err < 1e-3, f"tiny {name}: logits differ by {err}")
            records[name] = dict(tokens=got.tolist(), logit_err=err, launches=counts)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return records


def family_k1_phase(torch, fa, prompt):
    """(b) K1 at head_dim 256 and 192 against its plain version (fp32, on
    the upcast inputs), bf16 and fp32: Gemma-7B's prefill of ``prompt`` (its
    queries, a cache of NEW_TOKENS more slots), the same with a hole in the
    keys and a q_offset, under a window, and D = 192; K1, plain and SDPA
    (a dense mask, the same work) alone: L2 flushed, a spin kernel, medians
    of 30; the bound from the bytes moved and the live pairs' operations."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    s = len(prompt["mask"])
    valid = torch.zeros((1, s + NEW_TOKENS), dtype=torch.bool)
    valid[0, :s] = torch.from_numpy(prompt["mask"])
    holed = valid.clone()
    holed[0, 128:192] = False
    cases = [
        # name, s_q, s_k, heads, d, key validity, window, q_offset, per request
        ("gemma_prefill", s, s + NEW_TOKENS, 16, 256, valid, None, 0, GEMMA_LAYERS),
        ("gemma_hole_offset", s, s + NEW_TOKENS, 16, 256, holed, None, NEW_TOKENS // 2, 0),
        ("gemma_window", s, s + NEW_TOKENS, 16, 256, valid, 256, 0, 0),
        ("d192", s, s + NEW_TOKENS, 16, 192, valid, None, 0, 0),
    ]
    l2 = torch.zeros(16 << 20, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    records = []
    for name, s_q, s_k, h, d, kv, window, q_off, per_req in cases:
        kv = kv.to(dev)
        keep = kv[:, None, :].expand(1, s_q, s_k).clone()
        q_pos = q_off + torch.arange(s_q, device=dev)[:, None]
        k_pos = torch.arange(s_k, device=dev)[None, :]
        keep &= k_pos <= q_pos
        if window is not None:
            keep &= (q_pos - k_pos) < window
        pairs = int(keep.sum())
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((1, s_q, h, d), generator=g, device=dev).to(dtype)
            k = torch.randn((1, s_k, h, d), generator=g, device=dev).to(dtype)
            v = torch.randn((1, s_k, h, d), generator=g, device=dev).to(dtype)

            def kernel():
                return fa.flash_attention(q, k, v, kv, True, window, q_off)

            def plain():
                return fa.flash_attention_reference(q, k, v, kv, True, window, q_off)

            out = kernel()
            ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), kv, True,
                                               window, q_off)
            torch.cuda.synchronize()
            err = float((out.float() - ref).abs().max())
            scale = max(1.0, float(ref.abs().max()))
            tol = (2e-2 if dtype == torch.bfloat16 else 1e-4) * scale
            check(torch.isfinite(out).all().item(), f"K1 {name} {dtype}: non-finite output")
            check(err <= tol, f"K1 {name} {dtype}: max abs error {err} > {tol}")
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            dense = keep[:, None]
            times = {key: cuda_ms(torch, fn, iters=30, flush=l2.sum, spin=SITE_SPIN_CYCLES,
                                  median=True)
                     for key, fn in (("ms", kernel), ("plain_ms", plain),
                                     ("library_ms", lambda: F.scaled_dot_product_attention(
                                         qt, kt, vt, attn_mask=dense)))}
            dtype_name = str(dtype).replace("torch.", "")
            n_bytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size() + (
                kv.numel())
            bound_ms, bound_by, bytes_ms, ops_ms = bound(n_bytes, 4 * h * d * pairs, dtype_name)
            rec = dict(case=name, dtype=dtype_name, s_q=s_q, s_k=s_k, h=h, d=d, window=window,
                       q_offset=q_off, pairs=pairs, max_abs_err=err, tol=tol,
                       bound_ms=bound_ms, bound_by=bound_by, bytes_ms=bytes_ms, ops_ms=ops_ms,
                       per_request=per_req, tflops=4 * h * d * pairs / times["ms"] / 1e9,
                       **times)
            records.append(rec)
            print(f"phase 14 (b) K1 {name:18s} {dtype_name:8s} Sq={s_q} Sk={s_k} H={h} D={d}"
                  + ("" if window is None else f" window={window}")
                  + ("" if not q_off else f" q_offset={q_off}")
                  + f": err {err:.3e} (tol {tol:.2e}) kernel {times['ms']:.4f} ms "
                  f"({rec['tflops']:.1f} TFLOP/s) plain {times['plain_ms']:.4f} sdpa "
                  f"{times['library_ms']:.4f} bound {bound_ms * 1e3:.2f} us ({bound_by})",
                  flush=True)
    return records


def family_model(torch, cfg, quantize=None):
    """A Cambrian of ``cfg`` with random bf16 weights made on the card from
    the seed (quantized layer by layer with ``quantize``); its build time."""
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict

    t0 = time.perf_counter()
    qcfg = cfg.replace(quantize=quantize)
    sd = random_state_dict(qcfg, torch.Generator(device="cuda").manual_seed(SEED), 0.02,
                           dtype=torch.bfloat16, device="cuda")
    model = CambrianForInference.from_state_dict(qcfg, sd, torch.bfloat16)
    del sd
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def family_continuous(torch, model, counters, cfg, prompts, sequential):
    """``ContinuousBatchingEngine`` on the live model: FAMILY_CB_SLOTS slots
    (max_len = context_len + 1024, bf16 cache, chunks of CB_CHUNK), as many
    image requests of FAMILY_CB_TOKENS tokens cycling ``prompts`` and their
    images, submitted at once; K1 GEMMA_K1 times an admission."""
    from cambrian_tpu_torch.infer.continuous import ContinuousBatchingEngine

    engine = ContinuousBatchingEngine(model.lm, num_slots=FAMILY_CB_SLOTS,
                                      max_len=cfg.tokenizer_model_max_length + CB_EXTRA_LEN)
    reqs = []
    zero_counts(counters)
    t0 = time.perf_counter()
    for r in range(FAMILY_CB_SLOTS):
        pr = prompts[r % len(prompts)]
        pids, pmask, ppos, feats, aux_masks, gcfg, _ = model._prepare_generate(
            pr["ids"], images=request_images(torch, model.towers, r % len(prompts)),
            image_sizes=[pr["size"]], max_new_tokens=FAMILY_CB_TOKENS, eos_token_id=None)
        reqs.append(engine.submit(pids[0], pmask[0], ppos[0], feats, aux_masks, gcfg))
    out = engine.run_until_complete(reqs, chunk=CB_CHUNK)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts(counters)
    n_tokens = sum(len(t) for t in out)
    agree = [float(np.mean(np.equal(t, sequential[r % len(prompts)][:len(t)])))
             for r, t in enumerate(out)]
    print(f"phase 14 (c) Gemma continuous batching: {len(out)} requests on {FAMILY_CB_SLOTS} "
          f"slots, {n_tokens} tokens in {wall_ms:.1f} ms ({n_tokens / wall_ms * 1e3:.2f} "
          f"tokens/s, encodes included); tokens agreeing with sequential generate's "
          f"{[f'{a:.0%}' for a in agree]}; K1 {launches['flash_attention_fwd']}", flush=True)
    for r, t in enumerate(out):
        check(len(t) == FAMILY_CB_TOKENS and ((t >= 0) & (t < cfg.vocab_size)).all(),
              f"Gemma continuous request {r}: {len(t)} tokens or a token out of range")
    want = FAMILY_CB_SLOTS * GEMMA_K1
    check(launches["flash_attention_fwd"] == want,
          f"Gemma continuous: K1 launched {launches['flash_attention_fwd']}x, not {want}x")
    return dict(tokens=[t.tolist() for t in out], wall_ms=wall_ms, agreement=agree,
                launches=launches)


def gemma_phase(torch, fa, quant, cfg, prompts):
    """(c) Cambrian-Gemma-7B at full width and depth: bf16 requests, the
    continuous engine, then int8 and int4 quantized on the card."""
    counters = all_counters(fa, quant)
    torch.cuda.reset_peak_memory_stats()
    model, build_s = family_model(torch, cfg)
    n_params = sum(p.numel() for p in model.lm.parameters()) + sum(
        p.numel() for t in model.towers for p in t.parameters())
    print(f"phase 14 (c) Cambrian-Gemma-7B bf16: {n_params / 1e9:.3f}B parameters built in "
          f"{build_s:.1f} s; head_dim {cfg.head_dim}, tied head "
          f"{tuple(model.lm.head().shape)} {model.lm.head().dtype}", flush=True)
    requests = []
    zero_counts(counters)                    # the main path's count starts here
    for r, pr in enumerate(prompts):
        requests.append(serve_request(torch, model, counters, cfg, r, pr, k1=GEMMA_K1))
    launches = read_counts(counters)
    unused = {k: launches[k] for k in VISION_KERNELS if launches[k]}
    check(not unused, f"Gemma bf16: the main path launched K5-K8 {unused}")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 14 (c) Gemma bf16 peak memory allocated: {peak / 2**30:.2f} GiB", flush=True)
    continuous = family_continuous(torch, model, counters, cfg, prompts,
                                   [rec["tokens"] for rec in requests])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    quantized = {}
    zero_counts(counters)
    for q in ("int8", "int4"):
        torch.cuda.reset_peak_memory_stats()
        model, build_s = family_model(torch, cfg, q)
        fn = getattr(quant, f"{q}_matmul")
        fn.function_launches.clear()
        rec = serve_request(torch, model, counters, cfg, 0, prompts[0], k1=GEMMA_K1)
        routes = dict(fn.function_launches)
        want = {"gemm": GEMMA_QUANT_PER_STEP,
                "gemv_m1_kernel": GEMMA_QUANT_PER_STEP * (NEW_TOKENS - 1)}
        check(rec["launches"][f"{q}_matmul"] == GEMMA_QUANT_PER_STEP * NEW_TOKENS,
              f"Gemma {q}: {q}_matmul launched {rec['launches'][f'{q}_matmul']}x")
        check(routes == want, f"Gemma {q}: routes {routes}, not {want}")
        rec.update(functions=routes, build_s=build_s, peak_bytes=torch.cuda.max_memory_allocated())
        quantized[q] = rec
        print(f"phase 14 (c) Gemma {q} (built in {build_s:.1f} s) request 0: prefill "
              f"{rec['prefill_ms']:.1f} ms (bf16 {requests[0]['prefill_ms']:.1f}), decode "
              f"{rec['decode_tokens_per_s']:.2f} tok/s (bf16 "
              f"{requests[0]['decode_tokens_per_s']:.2f}); routes {routes}; peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    quant_launches = read_counts(counters)
    return dict(requests=requests, continuous=continuous, quantized=quantized,
                n_params=n_params, peak_bytes=peak,
                launches=[launches, continuous["launches"], quant_launches])


def command_r_phase(torch, fa, quant, cfg, prompts):
    """(d) Cambrian-Command-R at full width, COMMAND_R_LAYERS of its 40
    layers: two requests through ``generate``."""
    counters = all_counters(fa, quant)
    torch.cuda.reset_peak_memory_stats()
    model, build_s = family_model(torch, cfg)
    n_params = sum(p.numel() for p in model.lm.parameters()) + sum(
        p.numel() for t in model.towers for p in t.parameters())
    print(f"phase 14 (d) Cambrian-Command-R bf16, {cfg.num_hidden_layers} layers: "
          f"{n_params / 1e9:.3f}B parameters built in {build_s:.1f} s", flush=True)
    zero_counts(counters)                    # the main path's count starts here
    requests = [serve_request(torch, model, counters, cfg, r, pr, k1=COMMAND_R_K1)
                for r, pr in enumerate(prompts[:2])]
    launches = read_counts(counters)
    unused = {k: launches[k] for k in VISION_KERNELS if launches[k]}
    check(not unused, f"Command-R: the main path launched K5-K8 {unused}")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 14 (d) Command-R peak memory allocated: {peak / 2**30:.2f} GiB", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(requests=requests, n_params=n_params, peak_bytes=peak, launches=[launches])


def family_phase(torch, fa, quant):
    """Phase 14: (a) tiny parity, (b) K1 at head_dim 256, (c)
    Cambrian-Gemma-7B, (d) Cambrian-Command-R at its cut depth."""
    from cambrian_tpu_torch.models.config import (
        CAMBRIAN_SVA,
        COMMAND_R_35B,
        GEMMA_7B,
        CambrianConfig,
    )

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)
    tiny = family_tiny_phase(torch, fa, quant, rng)
    gemma_cfg = CambrianConfig(**{**GEMMA_7B, **CAMBRIAN_SVA})
    check(gemma_cfg.num_hidden_layers == GEMMA_LAYERS and gemma_cfg.head_dim == 256,
          f"Gemma-7B: {gemma_cfg.num_hidden_layers} layers, head_dim {gemma_cfg.head_dim}")
    prompts = build_prompts(gemma_cfg, rng)
    k1_cases = family_k1_phase(torch, fa, prompts[0])
    gemma = gemma_phase(torch, fa, quant, gemma_cfg, prompts)
    # the cut: COMMAND_R_LAYERS decoder layers, with the SVA re-injected at
    # every third of them (0, 3, 6), as the 40-layer recipe does
    command_r_cfg = CambrianConfig(**{**COMMAND_R_35B, **CAMBRIAN_SVA}).replace(
        num_hidden_layers=COMMAND_R_LAYERS,
        num_of_vision_sampler_layers=len(range(0, COMMAND_R_LAYERS, 3)))
    command_r = command_r_phase(torch, fa, quant, command_r_cfg, build_prompts(
        command_r_cfg, rng))
    print(f"phase 14 (decoder families): {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(tiny=tiny, k1_cases=k1_cases, gemma=gemma, command_r=command_r,
                launches=gemma["launches"] + command_r["launches"])


# -- phases 15 and 16: training Cambrian-Gemma-7B and LoRA on one card -----------

def gemma_train_phase(torch, fa, quant, k2_record):
    """Phase 15: Cambrian-Gemma-7B (``GEMMA_7B`` with the four towers and
    the SVA, 28 layers, head_dim 256, tied 256,000-row embeddings) at full
    width and depth, stage 1 through ``CambrianTrainer.train()`` with phase
    9's flags and batch: K2 at head_dim 256 on the training path."""
    from cambrian_tpu_torch.models.config import CAMBRIAN_SVA, GEMMA_7B, CambrianConfig

    cfg = CambrianConfig(**{**GEMMA_7B, **CAMBRIAN_SVA})
    check(cfg.num_hidden_layers == GEMMA_LAYERS and cfg.head_dim == 256
          and cfg.tie_word_embeddings, f"Gemma-7B: {cfg.num_hidden_layers} layers, head_dim "
          f"{cfg.head_dim}, tied {cfg.tie_word_embeddings}")
    return train_stage1_phase(torch, fa, quant, k2_record, cfg, "Gemma-7B", GEMMA_LAYERS)


def lora_train_phase(torch, fa, quant):
    """Phase 16: Cambrian-8B LoRA at full width and depth through
    ``CambrianTrainer.train()``: ``scripts/cambrian/finetune_cambrian_8b.sh``'s
    flags with ``lora_enable`` (r 16, alpha 32, the seven default targets),
    3 optimizer steps at phase 9's batch 8 x 2048. Only the adapters may
    change while it trains; the run ends by writing
    ``lora_adapters.safetensors`` and merging the adapters into the model,
    and a second trainer given that file through ``lora_weight_path`` (0
    steps) must merge the same weights into the restored base."""
    from cambrian_tpu_torch import cambrian_8b
    from cambrian_tpu_torch.checkpoint import safetensors_io
    from cambrian_tpu_torch.data.dataset import DataCollatorForSupervisedDataset
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict
    from cambrian_tpu_torch.train import lora
    from cambrian_tpu_torch.train.trainer import CambrianTrainer, TrainingArguments

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cambrian_8b()
    out_dir = os.path.join(REPO, "build", "chip_smoke_lora")
    shutil.rmtree(out_dir, ignore_errors=True)

    def arguments(**kw):
        return TrainingArguments(**{**dict(
            output_dir=out_dir, lora_enable=True, lora_r=16, lora_alpha=32,
            tune_mm_mlp_adapter=False, bf16=True, num_train_epochs=1,
            per_device_train_batch_size=TRAIN_BATCH, gradient_accumulation_steps=1,
            adam_mu_dtype="bfloat16", learning_rate=4e-5, mm_vision_sampler_lr=1e-5,
            warmup_ratio=0.03, lr_scheduler_type="cosine", logging_steps=1, save_steps=500,
            save_total_limit=1, group_by_modality_length=True, seed=SEED, device="cuda"), **kw})

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    sd = random_state_dict(cfg, g, 0.02, dtype=torch.bfloat16, device=dev)
    model = CambrianForInference.from_state_dict(cfg, sd, torch.bfloat16)
    del sd
    lm, towers = model.lm, model.towers
    dataset = PretokenizedDataset(cfg, towers, TRAIN_STEPS * TRAIN_BATCH,
                                  np.random.default_rng(SEED))
    collator = DataCollatorForSupervisedDataset(
        tokenizer=PretokenizedTokenizer(), image_token_len=cfg.image_token_len,
        image_aux_token_len_list=list(cfg.mm_vision_tower_aux_token_len_list),
        image_position=cfg.image_position)
    targets = lora.lora_targets(lm)
    base = {n: p.detach().cpu() for n, p in lm.named_parameters()}
    base.update({f"towers.{i}.{n}": p.detach().cpu() for i, t in enumerate(towers)
                 for n, p in t.named_parameters()})
    n_adapter = 16 * sum(lin.in_features + lin.out_features for lin in targets.values())
    torch.cuda.synchronize()
    print(f"8B LoRA build: {len(targets)} targeted projections "
          f"({sum(k.startswith('params/layers_') for k in targets)} in the decoder), "
          f"{n_adapter / 1e6:.2f}M adapter parameters over a "
          f"{sum(p.numel() for p in base.values()) / 1e9:.3f}B frozen model, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    trainer = CambrianTrainer(model=lm, towers=towers, args=arguments(), train_dataset=dataset,
                              data_collator=collator)
    counters = all_counters(fa, quant)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)                    # the LoRA path's count starts here
    history = trainer.train()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s * 1e3 for s in trainer.step_seconds]
    warm_ms = float(np.mean(step_ms[1:]))
    for h in history:
        print(f"8B LoRA step {h['step']}: loss {h['loss']:.6f} grad_norm {h['grad_norm']:.6f} "
              f"lr {h['lr']:.3e}", flush=True)
    check([h["step"] for h in history] == list(range(1, TRAIN_STEPS + 1)),
          f"8B LoRA: history steps {[h['step'] for h in history]}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) and h["grad_norm"] > 0
              for h in history), "8B LoRA: non-finite loss or grad_norm, or grad_norm 0")
    want = {name: 0 for name in counters}
    want["flash_attention_fwd"] = TRAIN_STEPS * TRAIN_K1_LAUNCHES
    want["flash_attention_bwd"] = TRAIN_STEPS * TRAIN_K2_LAUNCHES
    check(launches == want, f"8B LoRA: launched {launches}, not {want}")
    adapters = trainer.adapters
    check(sorted(adapters) == sorted(targets), "8B LoRA: the adapters are not the targets")
    unmoved = [k for k, ad in adapters.items() if not ad["b"].any()]
    check(not unmoved, f"8B LoRA: b still 0 in {unmoved[:5]}")

    # the run ended by merging: every targeted weight is its base plus its
    # adapters' delta, every other tensor (connector, norms, towers) as it was
    merged = {n: p.detach() for n, p in lm.named_parameters()}
    merged.update({f"towers.{i}.{n}": p.detach() for i, t in enumerate(towers)
                   for n, p in t.named_parameters()})
    targeted = {lora.weight_name(k) for k in targets}
    changed = []
    for n, p in merged.items():
        if n in targeted:
            continue
        if not torch.equal(p.cpu(), base[n]):
            changed.append(n)
    check(not changed, f"8B LoRA: tensors other than the adapters changed: {changed[:5]}")
    wrong = []
    with torch.no_grad():
        for k, ad in adapters.items():
            n = lora.weight_name(k)
            w = lora.apply_lora({n: base[n].to(dev)}, {k: ad}, 32, 16)[n]
            if not torch.equal(merged[n], w):
                wrong.append(n)
    check(not wrong, f"8B LoRA: merged weights are not base + delta: {wrong[:5]}")
    check(all(p.grad is None for p in merged.values()), "8B LoRA: a parameter kept a .grad")

    # the adapters' file: JAX's key names, the run's adapters bit for bit
    path = os.path.join(out_dir, "lora_adapters.safetensors")
    saved = safetensors_io.load_file(path)
    check(sorted(saved) == sorted(f"{k}.lora_{p}" for k in targets for p in "ab"),
          f"8B LoRA: {len(saved)} tensors in the adapters' file, not {2 * len(targets)}")
    for k, ad in adapters.items():
        for part in "ab":
            check(np.array_equal(saved[f"{k}.lora_{part}"], ad[part].detach().cpu().numpy()),
                  f"8B LoRA: the file's {k}.lora_{part} is not the run's")

    # lora_weight_path: restore the base, train 0 steps from the file; the
    # merge must give the first run's final weights
    final = {n: merged[n].clone() for n in targeted}
    with torch.no_grad():
        for n, p in lm.named_parameters():
            if n in targeted:
                p.copy_(base[n])
    reload = CambrianTrainer(model=lm, towers=towers,
                             args=arguments(output_dir=out_dir + "_reload", lora_weight_path=path,
                                            num_train_epochs=0),
                             train_dataset=dataset, data_collator=collator)
    reload.train()
    torch.cuda.synchronize()
    params = dict(lm.named_parameters())
    wrong = [n for n in targeted if not torch.equal(params[n].detach(), final[n])]
    check(not wrong, f"8B LoRA: lora_weight_path merged other weights: {wrong[:5]}")
    del final, base

    rec = dict(step_ms=step_ms, warm_step_ms=warm_ms, peak_bytes=peak, launches=launches,
               history=history, targets=len(targets), adapter_params=n_adapter,
               file_tensors=len(saved), slot_tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / warm_ms * 1e3)
    print(f"8B LoRA: step wall ms {[round(s, 1) for s in step_ms]} (the first is cold); warm "
          f"{warm_ms:.1f} ms, {rec['slot_tokens_per_s']:.1f} slot tokens/s; peak memory "
          f"allocated {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); {len(saved)} tensors in "
          f"lora_adapters.safetensors; the reload merged the same weights; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    del model, lm, towers, trainer, reload, adapters, merged, params
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(out_dir + "_reload", ignore_errors=True)
    return rec


def eval_records():
    """(benchmark, its first fixture record) for every benchmark of the eval
    fixtures, in name order; the image stays the fixture's placeholder, and
    the pixels come from the caller."""
    with open(os.path.join(REPO, EVAL_FIXTURES)) as f:
        table = json.load(f)
    return [(name, table[name][0]) for name in sorted(table) if not name.startswith("_")]


def eval_row(r, name, rec, bundle, pixels, out_dir):
    """Record ``r`` of eval_records() through the runner's ``answer_record``
    (greedy, EVAL_TOKENS) on ``pixels``, its row written to
    ``out_dir/<benchmark>.jsonl`` and scored by ``score_answers``: (row,
    metrics)."""
    from cambrian_tpu_torch.eval import score
    from cambrian_tpu_torch.eval.runner import answer_record

    row = answer_record(name, dict(rec), 0, bundle, EVAL_CONV, EVAL_TOKENS, 0.0, pixels=pixels,
                        image_size=EVAL_SIZES[r % 3])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps(row) + "\n")
    return row, score.score_answers(name, path)


def eval_tiny_phase(torch, fa, quant):
    """Phase 17 (a): the eval harness on a tiny fp32 Cambrian (TF32 off) on
    the card against the same on the CPU, on the first record of every
    fixture benchmark with pixels from a seeded numpy generator: identical
    answer rows and metrics; K1 once a tower block and, where the packed
    prompt has 128 slots or more, once a decoder layer. Then a tiny
    text-only model of each LLaVA-style projector type: identical greedy
    tokens, first-token logits within TINY_LOGIT_TOL, K1 once a decoder
    layer, and the projector module itself within TINY_PROJ_TOL."""
    from cambrian_tpu_torch import tiny_debug
    from cambrian_tpu_torch.eval import BENCHMARKS
    from cambrian_tpu_torch.eval.runner import build_inputs
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = tiny_debug(num_towers=2)
        sd = random_state_dict(cfg, torch.Generator().manual_seed(SEED + 17), 0.05,
                               dtype=torch.float32, device="cpu")
        models = {"cpu": CambrianForInference.from_state_dict(cfg, sd, torch.float32,
                                                              cache_dtype=torch.float32),
                  "gpu": CambrianForInference.from_state_dict(
                      cfg, {k: v.cuda() for k, v in sd.items()}, torch.float32,
                      cache_dtype=torch.float32)}
        tok = StandInTokenizer(bos_token_id=cfg.bos_token_id, first_word=5,
                               words=cfg.vocab_size - 5, special_from=cfg.vocab_size)
        records = eval_records()
        rng = np.random.default_rng(SEED + 17)
        pixels = [[rng.standard_normal((1, 3, t.image_size, t.image_size)).astype(np.float32)
                   for t in models["cpu"].towers] for _ in records]
        counters = all_counters(fa, quant)
        out = {}
        for where, model in models.items():
            bundle = (tok, model, [t.image_processor for t in model.towers],
                      cfg.tokenizer_model_max_length)
            out_dir = os.path.join(REPO, "build", "eval_tiny", where)
            zero_counts(counters)
            rows, metrics = {}, {}
            for r, (name, rec) in enumerate(records):
                rows[name], metrics[name] = eval_row(r, name, rec, bundle, pixels[r], out_dir)
            out[where] = rows, metrics
            if where == "gpu":
                counts = read_counts(counters)
        check(out["gpu"][0] == out["cpu"][0], "phase 17 (a): the tiny eval rows differ between "
              "the card and the CPU: " + str([n for n in out["cpu"][0]
                                              if out["cpu"][0][n] != out["gpu"][0].get(n)]))
        check(out["gpu"][1] == out["cpu"][1], "phase 17 (a): the tiny metrics differ")
        blocks = sum(t.config.num_blocks_to_run for t in models["gpu"].towers)
        long_prompts = 0
        for r, (name, rec) in enumerate(records):
            prompt = BENCHMARKS[name].build_prompt(dict(rec))
            ids = build_inputs(prompt, tok, None, cfg, EVAL_CONV, pixels[r], EVAL_SIZES[r % 3])[0]
            long_prompts += len(ids) + cfg.image_block_len - 1 >= 128
        expected = {name: 0 for name in counters}
        expected["flash_attention_fwd"] = (blocks * len(records)
                                           + cfg.num_hidden_layers * long_prompts)
        check(counts == expected, f"phase 17 (a): the tiny eval launched {counts}, not {expected}")
        answered = sum(bool(row["prediction"]) for row in out["gpu"][0].values())
        print(f"phase 17 (a): {len(records)} tiny eval rows and metrics identical on the card and "
              f"the CPU ({answered} non-empty answers; {long_prompts} prompts of 128 slots or "
              f"more); K1 {counts['flash_attention_fwd']} launches", flush=True)
        projectors = {}
        for ptype in NON_SVA_PROJECTORS:
            projectors[ptype] = tiny_projector_case(torch, fa, quant, ptype, rng)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return dict(records=len(records), rows=out["gpu"][0], metrics=out["gpu"][1],
                launches=counts, long_prompts=long_prompts, projectors=projectors)


def tiny_projector_case(torch, fa, quant, ptype, rng):
    """A tiny text-only Cambrian with a ``ptype`` projector on the card
    against the CPU (fp32): 8 greedy tokens and the first token's logits
    from a 150-id prompt (the decoder's prefill on K1), and the projector
    module on random tokens."""
    from cambrian_tpu_torch import tiny_debug
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict

    cfg = tiny_debug(num_towers=2).replace(mm_projector_type=ptype)
    sd = random_state_dict(cfg, torch.Generator().manual_seed(SEED + 18), 0.05,
                           dtype=torch.float32, device="cpu")
    cpu = CambrianForInference.from_state_dict(cfg, sd, torch.float32, cache_dtype=torch.float32)
    gpu = CambrianForInference.from_state_dict(cfg, {k: v.cuda() for k, v in sd.items()},
                                               torch.float32, cache_dtype=torch.float32)
    ids = rng.integers(5, cfg.vocab_size, 150)
    kw = dict(max_new_tokens=8, eos_token_id=None)
    want = cpu.generate(ids, **kw)
    counters = all_counters(fa, quant)
    zero_counts(counters)
    got = gpu.generate(ids, **kw)
    counts = read_counts(counters)
    logit_err = float((gpu.engine.last_next_logits.cpu() - cpu.engine.last_next_logits)
                      .abs().max())
    in_dim = sum(t.hidden_size for t in cpu.towers)
    x = torch.from_numpy(rng.standard_normal((1, 16, in_dim)).astype(np.float32))
    with torch.no_grad():
        proj_err = float((gpu.lm.mm_projector(x.cuda()).cpu() - cpu.lm.mm_projector(x))
                         .abs().max())
    print(f"phase 17 (a), {ptype} projector, text only: cpu tokens {want.tolist()} gpu tokens "
          f"{got.tolist()}; first-token logits max abs diff {logit_err:.3e}; projector "
          f"max abs diff {proj_err:.3e}; launches { {k: v for k, v in counts.items() if v} }",
          flush=True)
    check(got.shape == (1, 8) and (got == want).all(), f"{ptype} projector: tokens differ")
    check(logit_err < TINY_LOGIT_TOL, f"{ptype} projector: logits differ by {logit_err}")
    check(proj_err < TINY_PROJ_TOL, f"{ptype} projector: its output differs by {proj_err}")
    expected = {name: 0 for name in counters}
    expected["flash_attention_fwd"] = cfg.num_hidden_layers
    check(counts == expected, f"{ptype} projector: launched {counts}, not {expected}")
    return dict(tokens=got.tolist(), logit_err=logit_err, proj_err=proj_err)


def eval_full_phase(torch, fa, quant, model, counters, cfg):
    """Phase 17 (b) and (c) on the live bf16 Cambrian-8B of phase 5: (b) the
    first record of every fixture benchmark through the runner's
    ``answer_record`` with the stand-in tokenizer and request_images' pixels
    (greedy, EVAL_TOKENS), each request K1 LAUNCHES_PER_REQUEST times and no
    other kernel of the port; every benchmark scored, its submission written
    where it has one, every metric appended to an experiments CSV under
    ``build/`` and pivoted; (c) one request under ``profiling.trace`` with
    ``annotate`` spans around encode and generate, whose trace must name both
    spans and ``fwd_bf16_kernel``."""
    from cambrian_tpu_torch import profiling
    from cambrian_tpu_torch.eval import BENCHMARKS, score, tabulate
    from cambrian_tpu_torch.eval.runner import build_inputs

    out_dir = os.path.join(REPO, "build", "eval_8b")
    shutil.rmtree(out_dir, ignore_errors=True)
    bundle = (StandInTokenizer(), model, [t.image_processor for t in model.towers],
              cfg.tokenizer_model_max_length)
    records = eval_records()
    requests = []
    want = {name: 0 for name in counters}
    want["flash_attention_fwd"] = LAUNCHES_PER_REQUEST
    zero_counts(counters)                     # the eval path's count starts here
    t0 = time.perf_counter()
    rows, metrics = {}, {}
    for r, (name, rec) in enumerate(records):
        before, t_req = read_counts(counters), time.perf_counter()
        rows[name], metrics[name] = eval_row(r, name, rec, bundle,
                                             request_images(torch, model.towers, r), out_dir)
        after = read_counts(counters)
        tm = model.engine.last_timings
        requests.append(dict(benchmark=name, wall_ms=(time.perf_counter() - t_req) * 1e3,
                             encode_ms=tm["encode_ms"], prefill_ms=tm["prefill_ms"],
                             decode_ms=tm["decode_ms"], decode_steps=tm["decode_steps"],
                             launches={k: after[k] - v for k, v in before.items()}))
        check(requests[-1]["launches"] == want,
              f"phase 17 (b) {name}: launched {requests[-1]['launches']}")
    wall_s = time.perf_counter() - t0
    launches = read_counts(counters)
    csv_path = os.path.join(out_dir, "experiments.csv")
    subs = {}
    for name, m in metrics.items():
        b = BENCHMARKS[name]
        check(b.primary_metric in m and all(np.isfinite(float(v)) for v in m.values()),
              f"phase 17 (b) {name}: metrics {m}")
        sub = score.write_submission(name, os.path.join(out_dir, f"{name}.jsonl"), EVAL_MODEL_ID)
        check((sub is not None) == (b.submission is not None) and (sub is None or
                                                                    os.path.isfile(sub)),
              f"phase 17 (b) {name}: submission {sub}")
        if sub:
            subs[name] = os.path.relpath(sub, REPO)
        score.append_experiment_row(csv_path, EVAL_MODEL_ID, name, m)
    table = tabulate.pivot(tabulate.read_rows([csv_path]))
    pivot_path = os.path.join(out_dir, "experiments_pivot.csv")
    tabulate.write_pivot(table, pivot_path)
    with open(pivot_path) as f:
        header = f.readline().strip().split(",")
    check(sorted(table[EVAL_MODEL_ID]) == sorted(metrics) and sorted(header[1:]) ==
          sorted(metrics), f"phase 17 (b): pivot columns {header}")
    for req in requests:
        print(f"phase 17 (b) {req['benchmark']}: encode {req['encode_ms']:.1f} ms, prefill "
              f"{req['prefill_ms']:.1f} ms, decode {req['decode_ms']:.1f} ms "
              f"({req['decode_steps']} steps), request {req['wall_ms']:.1f} ms; answer "
              f"{rows[req['benchmark']]['prediction']!r}", flush=True)
    print(f"phase 17 (b) on {card_line()}: {len(records)} Cambrian-8B bf16 eval requests in "
          f"{wall_s:.2f} s, K1 "
          f"{launches['flash_attention_fwd']} launches ({LAUNCHES_PER_REQUEST} each, nothing "
          f"else); {len(metrics)} benchmarks scored, submissions {sorted(subs)}, "
          f"{os.path.relpath(csv_path, REPO)} and {os.path.relpath(pivot_path, REPO)} written",
          flush=True)

    # (c) one request under the port's profiling.trace; a trace that lacks
    # K1's kernel is the profiler's loss (see profiled), so it runs again
    trace_dir = os.path.join(REPO, "build", "eval_trace")
    name, rec = records[0]
    prompt = BENCHMARKS[name].build_prompt(dict(rec))
    ids, images, sizes, _ = build_inputs(prompt, bundle[0], bundle[2], cfg, EVAL_CONV,
                                         request_images(torch, model.towers, 0), EVAL_SIZES[0])
    spans = ("eval_encode", "eval_generate")
    for attempt in range(1, 4):
        shutil.rmtree(trace_dir, ignore_errors=True)
        with profiling.trace(trace_dir):
            with profiling.annotate(spans[0]):
                *args, _ = model._prepare_generate(ids, images, sizes,
                                                   max_new_tokens=EVAL_TOKENS)
            with profiling.annotate(spans[1]):
                model.engine.generate(*args)
            torch.cuda.synchronize()
        files = sorted(os.listdir(trace_dir))
        text = ""
        for fname in files:
            with open(os.path.join(trace_dir, fname)) as f:
                text += f.read()
        found = {key: key in text for key in (*spans, "fwd_bf16_kernel")}
        if found["fwd_bf16_kernel"]:
            break
        print(f"phase 17 (c): trace {attempt} of 3 holds no fwd_bf16_kernel", flush=True)
    check(files and all(found.values()), f"phase 17 (c): the trace {files} names {found}")
    print(f"phase 17 (c): profiling.trace wrote {files} ({len(text) / 1e6:.2f} MB) under "
          f"{os.path.relpath(trace_dir, REPO)}, naming {sorted(found)}", flush=True)
    return dict(requests=requests, wall_s=wall_s, launches=launches, metrics=metrics,
                submissions=subs, trace_files=files, trace_attempts=attempt)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write every measurement to this JSON file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from cambrian_tpu_torch import cambrian_8b
    from cambrian_tpu_torch.ops import cuda_build, quant
    from cambrian_tpu_torch.ops import flash_attention as fa

    smi = card_line()
    print(smi, flush=True)
    try:
        import requests  # noqa: F401
        print("HTTP client: requests imports here", flush=True)
    except ImportError:
        print("HTTP client: urllib.request (requests does not import here)", flush=True)
    t0 = time.perf_counter()
    built = cuda_build.build("flash_attention", "flash_attention_bwd", "quant_matmul",
                             "layer_norm", "dwconv", "sva_attention", "fused_mlp")
    print(f"kernel build: {time.perf_counter() - t0:.2f} s in all", flush=True)
    for name, b in built.items():
        print(f"{name}: {b['seconds']:.2f} s -> {b['path']}", flush=True)
        # ptxas: registers, shared memory and spills of each kernel
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                print(line.strip(), flush=True)
    # K1 and K2 on the tensor cores: every bf16 kernel function (one per
    # padded head dimension, 16 .. 256 for K1, 16 .. 128 for K2) must contain
    # wgmma (HGMMA); so must the quant matmuls' bf16 prefill functions and
    # K8's bf16 GEMMs, without mma.sync (HMMA)
    sass = {}
    for lib in ("flash_attention", "flash_attention_bwd", "quant_matmul", "fused_mlp"):
        regs = register_use(built[lib]["log"])
        for fn, (hgmma, hmma, i2f) in tensor_core_instructions(built[lib]["path"]).items():
            n_regs, spills = regs.get(fn, (None, None))
            sass[fn] = dict(library=lib, hgmma=hgmma, hmma=hmma, i2f=i2f, registers=n_regs,
                            spill_bytes=spills)
            print(f"sass {lib}: {fn}: {hgmma} HGMMA, {hmma} HMMA, {i2f} I2F, {n_regs} registers, "
                  f"{spills} bytes spilled", flush=True)
    bf16_fns = [fn for fn in sass if "bf16_kernel" in fn]
    check(len(bf16_fns) == 56, f"expected 16 bf16 kernel functions of K1 and 40 of K2, "
          f"found {bf16_fns}")
    # K2 up to head_dim 256: its dk/dv function accumulating dK and dV up to
    # DP = 128 (<DP,0>), dV alone (<DP,1>) and dK alone (<DP,2>) above; dq at
    # every DP; the fp32 functions with 64-row q tiles and 8 columns a thread
    # (D <= 128) and 32-row tiles with 16 (above); the registers and spills
    # of those above 128 printed
    k2_usage = resource_usage(built["flash_attention_bwd"]["path"])
    k2_regs = register_use(built["flash_attention_bwd"]["log"])
    want_k2 = {f"bwd_dkdv_bf16_kernel<{dp},0>" for dp in range(16, 129, 16)}
    want_k2 |= {f"bwd_dkdv_bf16_kernel<{dp},{part}>" for dp in range(144, 257, 16)
                for part in (1, 2)}
    want_k2 |= {f"bwd_dq_bf16_kernel<{dp}>" for dp in range(16, 257, 16)}
    want_k2 |= {f"{fn}<float,{rows},{cols}>" for fn in ("bwd_dkdv_kernel", "bwd_dq_kernel")
                for rows, cols in ((64, 8), (32, 16))}
    want_k2 |= {"bwd_delta_kernel<float>", "bwd_delta_kernel<bf16>"}
    check(set(k2_usage) == want_k2, f"flash_attention_bwd: {sorted(k2_usage)}, not "
          f"{sorted(want_k2)}")
    for fn in sorted(want_k2):
        regs, stack, local = k2_usage[fn]
        sass.setdefault(fn, dict(library="flash_attention_bwd")).update(
            registers=regs, stack_bytes=stack, local_bytes=local,
            spill_bytes=k2_regs.get(fn, (None, None))[1])
    wide = [fn for fn in sorted(want_k2) if fn.endswith("<float,32,16>")
            or int((re.match(r"\w+<(\d+)", fn) or [0, 0])[1]) >= 144]
    wide = [f"{fn} {sass[fn]['registers']} registers, {sass[fn]['stack_bytes']} B stack, "
            f"{sass[fn]['local_bytes']} B local, {sass[fn]['spill_bytes']} B spilled"
            for fn in wide]
    print("K2 above head_dim 128: " + "; ".join(wide), flush=True)
    # K1 up to head_dim 256: every function there, none spilling (no stack,
    # no local memory), the widest's registers printed
    k1_usage = resource_usage(built["flash_attention"]["path"])
    want_k1 = {f"fwd_bf16_kernel<{dp}>" for dp in range(16, 257, 16)}
    want_k1 |= {"flash_fwd_kernel<float,8>", "flash_fwd_kernel<float,16>"}
    check(set(k1_usage) == want_k1, f"flash_attention: {sorted(k1_usage)}, not {sorted(want_k1)}")
    for fn in sorted(want_k1):
        regs, stack, local = k1_usage[fn]
        sass[fn].update(registers=regs, stack_bytes=stack, local_bytes=local)
    spilled = {fn: u for fn, u in k1_usage.items() if u[1] or u[2]}
    check(not spilled, f"K1 functions spill (registers, stack, local): {spilled}")
    print("K1 registers (none spills): " + ", ".join(
        f"{fn} {k1_usage[fn][0]}" for fn in ("fwd_bf16_kernel<128>", "fwd_bf16_kernel<192>",
                                             "fwd_bf16_kernel<256>", "flash_fwd_kernel<float,8>",
                                             "flash_fwd_kernel<float,16>")), flush=True)
    check(all(sass[fn]["hgmma"] > 0 for fn in bf16_fns),
          f"bf16 K1/K2 functions without HGMMA: "
          f"{[fn for fn in bf16_fns if not sass[fn]['hgmma']]}")
    missing = [fn for fn in WGMMA_FUNCTIONS if fn not in sass]
    check(not missing, f"quant_matmul lacks its wgmma prefill functions {missing}")
    check(all(sass[fn]["hgmma"] > 0 and sass[fn]["hmma"] == 0 for fn in WGMMA_FUNCTIONS),
          f"quant prefill functions not on wgmma alone: "
          f"{ {fn: sass[fn] for fn in WGMMA_FUNCTIONS} }")
    # the bf16 M = 1 decode GEMV of K3, K4 and K4b/K4c: there, without
    # spills (no stack, no local memory); mode 2 on the tensor cores (HMMA);
    # SASS instructions of the main loop per packed byte of weights a lane
    # consumes (a batch: GEMV_LOADS loads of 16 bytes)
    missing = [fn for fn in GEMV_M1_FUNCTIONS if fn not in sass]
    check(not missing, f"quant_matmul lacks its M = 1 GEMV functions {missing}")
    usage = resource_usage(built["quant_matmul"]["path"])
    loops = loop_instructions(built["quant_matmul"]["path"])
    for fn in GEMV_M1_FUNCTIONS:
        check(fn in usage, f"cuobjdump -res-usage shows no {fn}")
        regs, stack, local = usage[fn]
        body, loads = loops.get(fn) or (None, None)
        per_byte = None if body is None else body / (quant.GEMV_LOADS * 16)
        sass[fn].update(registers=regs, stack_bytes=stack, local_bytes=local,
                        loop_instructions=body, loop_loads=loads,
                        instructions_per_packed_byte=per_byte)
        print(f"{fn}: {regs} registers, {stack} bytes of stack, {local} bytes of local memory, "
              f"{sass[fn]['i2f']} I2F, {sass[fn]['hmma']} HMMA; main loop {body} instructions "
              f"with {loads} LDG"
              + ("" if per_byte is None else f", {per_byte:.3f} a packed byte"), flush=True)
        check(stack == 0 and local == 0, f"{fn} spills: {sass[fn]}")
    check(sass["gemv_m1_kernel<2>"]["hmma"] > 0 and sass["gemv_m1_kernel<2>"]["i2f"] <= 16,
          f"gemv_m1_kernel<2> off the tensor cores or widening by I2F: "
          f"{sass['gemv_m1_kernel<2>']}")
    # the bf16 M = 2..8 decode GEMV: every instance there, none spilling,
    # every mode's products on the tensor cores (HMMA), no widening by I2F
    # in its loop; instructions of the main loop per packed byte of a lane's
    # batch (GEMV_M8_BATCH_BYTES)
    missing = [fn for fn in GEMV_M8_FUNCTIONS if fn not in usage or fn not in sass]
    check(not missing, f"quant_matmul lacks its M = 2..8 GEMV functions {missing}")
    for fn in GEMV_M8_FUNCTIONS:
        regs, stack, local = usage[fn]
        body, loads = loops.get(fn) or (None, None)
        per_byte = None if body is None else body / quant.GEMV_M8_BATCH_BYTES
        sass[fn].update(registers=regs, stack_bytes=stack, local_bytes=local,
                        loop_instructions=body, loop_loads=loads,
                        instructions_per_packed_byte=per_byte)
        print(f"{fn}: {regs} registers, {stack} bytes of stack, {local} bytes of local memory, "
              f"{sass[fn]['i2f']} I2F, {sass[fn]['hmma']} HMMA; main loop {body} instructions "
              f"with {loads} LDG"
              + ("" if per_byte is None else f", {per_byte:.3f} a packed byte"), flush=True)
        check(stack == 0 and local == 0, f"{fn} spills: {sass[fn]}")
        check(sass[fn]["hmma"] > 0 and sass[fn]["i2f"] <= 16,
              f"{fn} off the tensor cores or widening by I2F: {sass[fn]}")
    # K6: every instance of the 16-byte row pass and the scalar kernel,
    # without spills
    from cambrian_tpu_torch.ops.norms import LN_INSTANCES

    ln_usage = resource_usage(built["layer_norm"]["path"])
    ln_vec = {fn: u for fn, u in ln_usage.items() if fn.startswith(LN_VEC)}
    want_vec = {f"{LN_VEC}<{t},{lanes},{chunks}>" for t in ("float", "bf16")
                for lanes, chunks in LN_INSTANCES}
    check(set(ln_vec) == want_vec, f"layer_norm: {sorted(ln_vec)} are the instances of "
          f"{LN_VEC}, not the {len(want_vec)} of 2 dtypes x norms.LN_INSTANCES")
    check(sum(fn.startswith(LN_SCALAR) for fn in ln_usage) == 2, f"layer_norm: {list(ln_usage)}")
    ln_sass = tensor_core_instructions(built["layer_norm"]["path"])
    for fn, (regs, stack, local) in sorted(ln_usage.items()):
        hgmma, hmma, i2f = ln_sass.get(fn, (None, None, None))
        sass[fn] = dict(library="layer_norm", registers=regs, stack_bytes=stack,
                        local_bytes=local, hgmma=hgmma, hmma=hmma, i2f=i2f)
    spilled = {fn: u for fn, u in ln_usage.items() if u[1] or u[2]}
    check(not spilled, f"K6 functions spill (registers, stack, local): {spilled}")
    widest = sass.get(LN_VEC + "<bf16,32,12>")
    print(f"layer_norm: {len(ln_vec)} {LN_VEC} instances, {min(u[0] for u in ln_vec.values())}-"
          f"{max(u[0] for u in ln_vec.values())} registers, none spills, "
          f"{max(v[2] for v in ln_sass.values())} I2F at most, "
          f"{sum(v[0] + v[1] for v in ln_sass.values())} tensor-core instructions; the widest "
          f"site's {LN_VEC}<bf16,32,12>: {widest}", flush=True)
    # K7: every instance of the TMA kernel (2 dtypes x dwconv.DW_INSTANCES)
    # and the first port's kernel, without spills; the TMA kernel's
    # registers and its tile loop's FFMA share (FFMA of the innermost
    # backward-branch span with the most FFMA, over its instructions)
    from cambrian_tpu_torch.ops.dwconv import DW_INSTANCES

    dw_usage = resource_usage(built["dwconv"]["path"])
    dw_loops = loop_instructions(built["dwconv"]["path"], "FFMA", innermost=True)
    want_dw = {f"{DW_TMA}<{t},{r},{c}>" for t in ("float", "bf16") for r, c in DW_INSTANCES}
    want_dw |= {f"{DW_OLD}<{t}>" for t in ("float", "bf16")}
    check(set(dw_usage) == want_dw, f"dwconv: {sorted(dw_usage)} are its kernel functions, not "
          f"{sorted(want_dw)}")
    for fn in sorted(want_dw):
        regs, stack, local = dw_usage[fn]
        body, ffma = dw_loops.get(fn) or (None, None)
        share = ffma / body if fn.startswith(DW_TMA) and body else None
        sass[fn] = dict(library="dwconv", registers=regs, stack_bytes=stack, local_bytes=local,
                        loop_instructions=body, loop_ffma=ffma, ffma_share=share)
        print(f"{fn}: {regs} registers, {stack} bytes of stack, {local} bytes of local memory"
              + ("" if share is None else
                 f"; tile loop {body} instructions, {ffma} FFMA ({share:.1%})"), flush=True)
    spilled = {fn: u for fn, u in dw_usage.items() if u[1] or u[2]}
    check(not spilled, f"K7 functions spill (registers, stack, local): {spilled}")
    # K5: every instance of the TMA kernel (the pairs of SVA_INSTANCES each dtype needs)
    # and the first port's kernel, without spills; their registers, and the
    # 8B site plan's dynamic shared memory a block (no kernel has static)
    from cambrian_tpu_torch.ops import sva_attention as sva_ops

    sva_usage = resource_usage(built["sva_attention"]["path"])
    want_sva = {f"{SVA_TMA}<{t},{lanes},{window}>" for t, elem in (("float", 4), ("bf16", 2))
                for lanes, window in sva_ops.SVA_INSTANCES if lanes <= 8 * elem}
    want_sva |= {f"{SVA_OLD}<{t}>" for t in ("float", "bf16")}
    check(set(sva_usage) == want_sva, f"sva_attention: {sorted(sva_usage)} are its kernel "
          f"functions, not {sorted(want_sva)}")
    for fn in sorted(want_sva):
        regs, stack, local = sva_usage[fn]
        sass[fn] = dict(library="sva_attention", registers=regs, stack_bytes=stack,
                        local_bytes=local)
        print(f"{fn}: {regs} registers, {stack} bytes of stack, {local} bytes of local memory",
              flush=True)
    spilled = {fn: u for fn, u in sva_usage.items() if u[1] or u[2]}
    check(not spilled, f"K5 functions spill (registers, stack, local): {spilled}")
    site = (1, 576, 19, 16, 64)       # B, Q, W, H, D of the 8B request's SVA attention
    b, n_q, w, h, d = site
    dev = torch.device("cuda")
    plan = sva_ops._sva_plan(
        b, n_q, h, w, d, torch.bfloat16, ((n_q * h * d, h * d, d, 1),) + (
            (n_q * w * h * d, w * h * d, h * d, d, 1),) * 2, True, sva_ops._sms(dev),
        lambda *a: sva_ops._occupancy(dev, 1, *a))
    smem = sva_ops.sva_smem_bytes(plan.heads, w, d, 2, plan.stages)
    fn = f"{SVA_TMA}<bf16,{plan.lanes},{plan.window}>"
    sass[fn].update(plan=list(plan), dynamic_smem_bytes=smem)
    print(f"{fn} at the 8B site {site}: plan {tuple(plan)[1:]}, "
          f"{smem} bytes of dynamic shared memory a block, {plan.blocks_per_sm} blocks an SM "
          f"({plan.blocks_per_sm * smem} bytes)", flush=True)
    missing = [fn for fn in MLP_WGMMA_FUNCTIONS if fn not in sass]
    check(not missing, f"fused_mlp lacks its wgmma GEMM functions {missing}")
    check(all(sass[fn]["hgmma"] > 0 and sass[fn]["hmma"] == 0 for fn in MLP_WGMMA_FUNCTIONS),
          f"K8 GEMM functions not on wgmma alone: "
          f"{ {fn: sass[fn] for fn in MLP_WGMMA_FUNCTIONS} }")

    rng = np.random.default_rng(SEED)
    prompts = build_prompts(cambrian_8b(), rng)
    prompt_len = len(prompts[0]["mask"])
    kernels = kernel_phase(torch, fa, prompts[0])
    quant_kernels = quant_kernel_phase(torch, quant, prompt_len, slots=CB_SLOTS)
    tiny = {q or "fp32": tiny_slice_phase(torch, fa, quant, rng, q)
            for q in (None, "int8", "int4")}
    tiny["phi3_longrope"] = tiny_slice_phase(torch, fa, quant, rng, longrope=True)
    t17 = time.perf_counter()
    eval_tiny = eval_tiny_phase(torch, fa, quant)
    print(f"phase 17 (a) (tiny eval, card against CPU): {time.perf_counter() - t17:.1f} s",
          flush=True)
    sites = {}       # K5-K8's drop-in sites, captured in the bf16 serving phase

    def eval_8b(model, counters, cfg):
        t0 = time.perf_counter()
        rec = eval_full_phase(torch, fa, quant, model, counters, cfg)
        print(f"phase 17 (b, c) (Cambrian-8B eval and its trace): {time.perf_counter() - t0:.1f} "
              f"s", flush=True)
        return rec

    full = {q or "bf16": full_width_phase(torch, fa, quant, prompts, q,
                                          sites=sites if q is None else None,
                                          then=eval_8b if q is None else None)
            for q in (None, "int8", "int4")}
    # time to first token: each quantized request's prefill beside the bf16
    # model's on the same prompt (bf16 request 0 is the cold one)
    for q in ("int8", "int4"):
        for rec in full[q]["requests"]:
            ref = full["bf16"]["requests"][rec["request"]]
            label = ("stream " if rec["stream"] else "") + ("scale-on-weights " if rec.get(
                "scale_on_weights") else "")
            print(f"prefill {q} {label}request {rec['request']}: {rec['prefill_ms']:.1f} ms, "
                  f"bf16 {ref['prefill_ms']:.1f} ms", flush=True)
    bwd_kernels = backward_kernel_phase(torch, fa)
    tiny_train = tiny_training_phase(torch, fa, quant)
    k2 = next(k for k in bwd_kernels if k["case"] == "decoder_train" and k["dtype"] == "bfloat16")
    k2_gemma = next(k for k in bwd_kernels
                    if k["case"] == "gemma_train" and k["dtype"] == "bfloat16")
    train = train_stage1_phase(torch, fa, quant, k2, cambrian_8b(), "8B", LAYERS)
    t10 = time.perf_counter()
    vision = vision_kernel_phase(torch, fa, quant, sites)
    del sites
    print(f"phase 10 (K5-K8): {time.perf_counter() - t10:.1f} s", flush=True)
    t11 = time.perf_counter()
    phi3 = phi3_phase(torch, fa, quant)
    print(f"phase 11 (Cambrian-Phi-3): {time.perf_counter() - t11:.1f} s", flush=True)
    zoo = zoo_phase(torch, fa, quant, prompts)
    families = family_phase(torch, fa, quant)
    t15 = time.perf_counter()
    gemma_train = gemma_train_phase(torch, fa, quant, k2_gemma)
    print(f"phase 15 (Cambrian-Gemma-7B stage 1): {time.perf_counter() - t15:.1f} s", flush=True)
    t16 = time.perf_counter()
    lora_train = lora_train_phase(torch, fa, quant)
    print(f"phase 16 (Cambrian-8B LoRA): {time.perf_counter() - t16:.1f} s", flush=True)

    # launches: each path's counts (8B serving, eval and training, Phi-3
    # serving and loading), read just after it, summed over paths
    paths = [f["launches"] for f in full.values()] + [train["launches"], phi3["launches"]]
    paths += [f["continuous"]["launches"] for f in full.values()]
    paths += [f["http"]["launches"] for f in full.values() if f["http"]]
    paths += [zoo["launches"], zoo["cambrian"]["launches"]] + families["launches"]
    paths += [gemma_train["launches"], lora_train["launches"], full["bf16"]["then"]["launches"]]
    launches = {name: sum(p[name] for p in paths) for name in all_counters(fa, quant)}
    path = [k for k in kernels if k["per_request"] and k["dtype"] == "bfloat16"]
    # one request's worth of launches at the path's shapes, bf16
    k1_bytes_ms = sum(k["per_request"] * k["bytes_ms"] for k in path)
    k1_ops_ms = sum(k["per_request"] * k["ops_ms"] for k in path)
    rows = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "cambrian_tpu_torch/csrc/flash_attention.cu",
        "replaces": "cambrian_tpu/ops/flash_attention.py:36",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": max(k["max_abs_err"] for k in path),
        "ms": sum(k["ms"] * k["per_request"] for k in path),
        "plain_ms": sum(k["plain_ms"] * k["per_request"] for k in path),
        "bound_ms": sum(k["bound_ms"] * k["per_request"] for k in path),
        "bound_by": "bytes" if k1_bytes_ms >= k1_ops_ms else "operations",
        "library_ms": sum(k["library_ms"] * k["per_request"] for k in path),
    }]
    k1 = rows[0]
    print(f"flash_attention_fwd: per request kernel {k1['ms']:.3f} ms, plain "
          f"{k1['plain_ms']:.3f} ms, sdpa {k1['library_ms']:.3f} ms, bound "
          f"{k1['bound_ms']:.4f} ms ({k1['bound_by']})", flush=True)
    for name, (replaces, _) in QUANT_KERNELS.items():
        recs = [r for r in quant_kernels if r["kernel"] == name and r["dtype"] == "bfloat16"]
        bytes_ms = request_sum(recs, "bytes_ms", name, prompt_len)
        ops_ms = request_sum(recs, "ops_ms", name, prompt_len)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "cambrian_tpu_torch/csrc/quant_matmul.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": request_sum(recs, "ms", name, prompt_len),
            "plain_ms": request_sum(recs, "plain_ms", name, prompt_len),
            "bound_ms": request_sum(recs, "bound_ms", name, prompt_len),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": request_sum(recs, "library_ms", name, prompt_len),
        })
        for label, m in (("decode step", 1), ("prefill", prompt_len),
                         (f"continuous-batching decode step (M = {CB_SLOTS})", CB_SLOTS)):
            # the 7 x 32 projections of one decoder forward at this M
            per = {key: LAYERS * sum(r[key] or 0.0 for r in recs if r["m"] == m)
                   for key in ("ms", "plain_ms", "library_ms", "library_int8pack_ms",
                               "bound_ms")}
            int8pack = (f" int8pack {per['library_int8pack_ms']:.3f} ms"
                        if per["library_int8pack_ms"] else "")
            flops = LAYERS * sum(2 * r["m"] * r["n"] * r["k"] for r in recs if r["m"] == m)
            print(f"{name}: decoder GEMMs per {label}: kernel {per['ms']:.3f} ms "
                  f"({flops / (per['ms'] * 1e9):.1f} TFLOP/s), "
                  f"plain {per['plain_ms']:.3f} ms, matmul {per['library_ms']:.3f} ms"
                  f"{int8pack}, bound {per['bound_ms']:.3f} ms", flush=True)
        print(f"{name}: per request {rows[-1]['ms']:.1f} ms (bound "
              f"{rows[-1]['bound_ms']:.2f} ms, matmul {rows[-1]['library_ms']:.1f} ms)",
              flush=True)
    # K3, K4 and K4b at M = CB_SLOTS: the continuous-batching decode step's
    # 7 x 32 projections on gemv_m8_kernel (the first port's gemv_kernel
    # timed beside it); launches from phase 12's routes
    for name, (replaces, _) in QUANT_KERNELS.items():
        recs = [r for r in quant_kernels if r["kernel"] == name and r["m"] == CB_SLOTS]
        step = {key: LAYERS * sum(r[key] for r in recs)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms",
                            "gemv_kernel_ms")}
        rows.append({
            "name": f"{name}_m{CB_SLOTS}",
            "route": "cuda",
            "source": "cambrian_tpu_torch/csrc/quant_matmul.cu",
            "replaces": replaces,
            "launches": sum(f["continuous"]["routes"][name].get("gemv_m8_kernel", 0)
                            for f in full.values()),
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": step["ms"],
            "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"],
            "bound_by": "bytes" if step["bytes_ms"] >= step["ops_ms"] else "operations",
            "library_ms": step["library_ms"],
            "gemv_kernel_ms": step["gemv_kernel_ms"],
        })
        check(rows[-1]["launches"] > 0, f"{name}: no gemv_m8_kernel launch at M = {CB_SLOTS} "
              f"in phase 12")
    # K1 at the encoder-study towers' shapes (phase 13): one image through
    # every tower of ZOO_TOWERS, each call at its captured shape (bf16)
    zoo_k1 = {key: 0.0 for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                                   "ops_ms")}
    for rec in zoo["towers"]:
        for shape, n in rec["k1_shapes"].items():
            if shape.startswith(f"{ZOO_BATCHES[0]}x"):
                for key in zoo_k1:
                    zoo_k1[key] += n * zoo["k1_cases"][shape][key]
    rows.append({
        "name": "flash_attention_fwd_towers",
        "route": "cuda",
        "source": "cambrian_tpu_torch/csrc/flash_attention.cu",
        "replaces": "cambrian_tpu/ops/flash_attention.py:36",
        "launches": zoo["launches"]["flash_attention_fwd"]
        + zoo["cambrian"]["launches"]["flash_attention_fwd"],
        "max_abs_err": max(c["max_abs_err"] for c in zoo["k1_cases"].values()),
        "ms": zoo_k1["ms"],
        "plain_ms": zoo_k1["plain_ms"],
        "bound_ms": zoo_k1["bound_ms"],
        "bound_by": "bytes" if zoo_k1["bytes_ms"] >= zoo_k1["ops_ms"] else "operations",
        "library_ms": zoo_k1["library_ms"],
    })
    print(f"flash_attention_fwd_towers: an image through the {len(ZOO_TOWERS)} towers: kernel "
          f"{zoo_k1['ms']:.3f} ms, plain {zoo_k1['plain_ms']:.3f} ms, sdpa "
          f"{zoo_k1['library_ms']:.3f} ms, bound {zoo_k1['bound_ms']:.4f} ms", flush=True)
    # K1 at Gemma-7B's prefill (phase 14): a request's 28 decoder calls at
    # head_dim 256 (bf16); launches: phase 14's main paths' decoder calls
    gemma_k1 = [c for c in families["k1_cases"] if c["per_request"] and c["dtype"] == "bfloat16"]
    gemma_paths = families["launches"][:3]
    gemma_launches = sum(p["flash_attention_fwd"] for p in gemma_paths) - TOWER_K1_CALLS * (
        len(families["gemma"]["requests"]) + len(families["gemma"]["quantized"])
        + FAMILY_CB_SLOTS)
    check(gemma_launches == GEMMA_LAYERS * (len(families["gemma"]["requests"])
                                            + len(families["gemma"]["quantized"])
                                            + FAMILY_CB_SLOTS),
          f"Gemma's decoder K1 launches {gemma_launches}")
    per_req = {key: sum(c[key] * c["per_request"] for c in gemma_k1)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms")}
    rows.append({
        "name": "flash_attention_fwd_gemma",
        "route": "cuda",
        "source": "cambrian_tpu_torch/csrc/flash_attention.cu",
        "replaces": "cambrian_tpu/ops/flash_attention.py:36",
        "launches": gemma_launches,
        "max_abs_err": max(c["max_abs_err"] for c in families["k1_cases"]
                           if c["dtype"] == "bfloat16"),
        "ms": per_req["ms"],
        "plain_ms": per_req["plain_ms"],
        "bound_ms": per_req["bound_ms"],
        "bound_by": "bytes" if per_req["bytes_ms"] >= per_req["ops_ms"] else "operations",
        "library_ms": per_req["library_ms"],
    })
    print(f"flash_attention_fwd_gemma: a Gemma-7B request's {GEMMA_LAYERS} prefill calls at "
          f"head_dim 256: kernel {per_req['ms']:.3f} ms, plain {per_req['plain_ms']:.3f} ms, "
          f"sdpa {per_req['library_ms']:.3f} ms, bound {per_req['bound_ms']:.4f} ms "
          f"({rows[-1]['bound_by']})", flush=True)
    # K2: per training step, 32 calls at the decoder's shape (bf16); launches
    # of the 8B paths (phases 9 and 16)
    rows.append({
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "cambrian_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "cambrian_tpu/ops/flash_attention.py:140",
        "launches": train["launches"]["flash_attention_bwd"]
        + lora_train["launches"]["flash_attention_bwd"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"] * k2["per_step"],
        "plain_ms": k2["plain_ms"] * k2["per_step"],
        "bound_ms": k2["bound_ms"] * k2["per_step"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"] * k2["per_step"],
    })
    print(f"flash_attention_bwd: per training step kernel {rows[-1]['ms']:.1f} ms, plain "
          f"{rows[-1]['plain_ms']:.1f} ms, sdpa backward {rows[-1]['library_ms']:.1f} ms, bound "
          f"{rows[-1]['bound_ms']:.2f} ms ({k2['bound_by']})", flush=True)
    # K2 at head_dim 256: per Gemma-7B training micro-batch, 28 calls at its
    # stage-1 shape (bf16); launches of phase 15's path
    rows.append({
        "name": "flash_attention_bwd_gemma",
        "route": "cuda",
        "source": "cambrian_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "cambrian_tpu/ops/flash_attention.py:140",
        "launches": gemma_train["launches"]["flash_attention_bwd"],
        "max_abs_err": k2_gemma["max_abs_err"],
        "ms": k2_gemma["ms"] * k2_gemma["per_step"],
        "plain_ms": k2_gemma["plain_ms"] * k2_gemma["per_step"],
        "bound_ms": k2_gemma["bound_ms"] * k2_gemma["per_step"],
        "bound_by": k2_gemma["bound_by"],
        "library_ms": k2_gemma["library_ms"] * k2_gemma["per_step"],
    })
    print(f"flash_attention_bwd_gemma: per Gemma-7B training step ({GEMMA_LAYERS} calls at "
          f"head_dim 256) kernel {rows[-1]['ms']:.1f} ms, plain {rows[-1]['plain_ms']:.1f} ms, "
          f"sdpa backward ({k2_gemma['sdpa_backend']}) {rows[-1]['library_ms']:.1f} ms, bound "
          f"{rows[-1]['bound_ms']:.2f} ms ({k2_gemma['bound_by']})", flush=True)
    # K5-K8: one request's drop-in sites (bf16); launches from the drop-in pass
    for kind, (_, _, replaces, source) in VISION_KERNELS.items():
        recs = [r for r in vision["records"] if r["kernel"] == kind and r["per_request"]]

        def per_request(key, recs=recs):
            return sum(r[key] * r["per_request"] for r in recs)

        rows.append({
            "name": kind,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": vision["launches"][kind],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": per_request("ms"),
            "plain_ms": per_request("plain_ms"),
            "bound_ms": per_request("bound_ms"),
            "bound_by": ("bytes" if per_request("bytes_ms") >= per_request("ops_ms")
                         else "operations"),
            "library_ms": per_request("library_ms"),
        })
        r = rows[-1]
        rate = ""
        if kind == "fused_mlp":
            flops = per_request("flops")
            rate = (f" ({flops / (r['ms'] * 1e9):.1f} TFLOP/s; {r['ms'] / r['library_ms']:.2f}x "
                    f"the library's)")
        print(f"{kind}: per request ({sum(x['per_request'] for x in recs)} sites) kernel "
              f"{r['ms']:.3f} ms{rate}, plain {r['plain_ms']:.3f} ms, library "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
    summary = {"kernels": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, build={k: v["seconds"] for k, v in built.items()}, sass=sass,
                           kernels=kernels, quant_kernels=quant_kernels, tiny=tiny, full=full,
                           bwd_kernels=bwd_kernels, tiny_train=tiny_train, train=train,
                           vision=vision, phi3=phi3, zoo=zoo, families=families,
                           gemma_train=gemma_train, lora_train=lora_train,
                           eval_tiny=eval_tiny, summary=summary), f, indent=1)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
