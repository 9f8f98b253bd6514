#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU.  It

1. builds every hand-written kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together);
2. holds each kernel against its plain PyTorch version on the card
   (``gossip_mix``: K in {1, 2, 3, 5}, ragged and misaligned N, float32
   at 2e-5 and bfloat16 at 2e-2, constants preserved by a convex
   combination), holds its streaming kernel bit-identical to the earlier
   grid-stride kernel of the same source (K in {1, 2, 3, 5, 9}, ragged and
   misaligned N, float32 and bfloat16), and times the two at K=2, N=2^28
   in turns with its plain version, ``torch.lerp`` and ``torch.matmul``
   (PyTorch calls computing the same function), beside its bound;
3. drives the port's main path through its entry point: DPASGD on a
   4-silo ring, ``gossip_impl="pallas"``, at internlm2-1.8b's full
   width (depth cut to 4 layers, random weights from seed 0), 3 rounds,
   and checks that every round went through the kernel;
4. takes one more round from the trained state with the kernel and one
   with the dense ``einsum`` mix and compares the parameters (<= 1e-5);
   before the main path, it also runs one round at the CPU tests' small
   size on the card and on the CPU from the same state and compares them
   (<= 2e-5: the CPU path is the one the tests hold against JAX);
5. times the kernel at the main path's own shape in turns with the
   grid-stride kernel, ``torch.lerp`` and its plain version, bit-identity
   included;
6. holds the standalone ``segment_max`` (K1) against its plain version on
   the card, bit for bit (B in {1, 3, 16, 64} x E in {1, 7, 261, 8192} x S
   in {1, 5, 87, 1024} x four float dtypes, with -inf entries,
   out-of-range ids and empty segments, plus a NaN case and a signed-zero
   case), and times it at the Ebone climb's shape and the sparse scoring
   shape beside its plain version, ``Tensor.scatter_reduce_`` and its
   bound; then K1's two persistent entries, ``karp_cycle_time`` (every
   Karp level of a batch of scores in one launch) and ``reach_from_zero``
   (forward and backward reachability in one launch), against their plain
   versions, bit for bit (B in {1, 3, 16, 64} x N in {1, 5, 87, 383, 1024}
   x E in {N, 3N, 8192} x one or multi-universe rows x four float dtypes,
   with -inf arcs, an acyclic row and an unreachable node, plus arcs too
   many for shared memory), and one Karp score timed at the Ebone climb's
   shape and the scoring shape beside its plain version, the per-level
   path of PRs 12-14 and its bound;
7. drives the design path: ``design_overlay("sparse_rewire", ...)`` on
   the card for the paper's five networks at their real sizes, and the
   hierarchical designer on Ebone and on a 4096-silo clustered WAN, each
   with the counts set to 0 just before it and read just after: one
   ``karp`` and one ``reach`` launch per scored climb step (n_steps + 1)
   and no standalone ``segment_max`` launch, degree bounds, strong
   connectivity, the reported tau equal to the f64 host re-price, and
   never worse than the Christofides ring (or the given incumbent); the
   Ebone design once more under the profiler (at most 300 kernels a climb
   step);
8. holds the climb's score of its seeds on the card bit-identical to the
   CPU's, on Ebone, for one universe and for padded multi-universe packs;
   then times ``gossip_mix`` at every row count K that the port's plans
   give it (the five designed overlays' plans and the 4-silo ring, chain
   and star), N = 2^26, in turns with the grid-stride kernel, bit-identity
   included;
9. trains on a designed plan: Gaia's overlay -> ``plan_from_overlay`` ->
   3 DPASGD rounds (``gossip_impl="pallas"``, 11 silos, the reduced
   internlm2-1.8b), one ``gossip_mix`` launch per round, then one round
   pallas vs einsum (<= 1e-5);
10. holds K1's fourth entry, ``timing_recursion`` (every round of the
   round-varying Eq. 4 recursion of a batch of MATCHA chains in one
   launch), against its plain version on the card, bit for bit (216 random
   pools: C in {1, 3, 24, 64} x R in {1, 2, 17, 150, 300} x U in {1, 5, 24,
   64} x N in {2, 11, 87, 256, 512} x E in {1, N, 3N, 2048}, missing
   self-loops, all -inf rows, a dst that covers only part of the nodes,
   t0, float32 and float64), and times it in turns with its plain version
   at the repo's engine shape (N = 64, a degree-8 random-geometric base
   graph, 8 budgets x 8 seeds x 300 rounds) and at Ebone's design shape (8
   budgets x 3 seeds x 150 rounds), beside its bound and its device time
   (the profiler must see all 20 launches of a timed window);
11. drives the MATCHA design path: ``design_schedule("matcha", ...)`` on
   the card at the reference's defaults on the paper's five networks,
   each with the counts set to 0 just before it and read just after: one
   ``timing`` launch and nothing else a design, every chain's tau and the
   chosen budget equal to the CPU's bit for bit; Geant under the
   time-to-eps objective; the idle share of a traced design on Ebone (its
   one timing launch seen by the profiler); and Table
   10 (AWS NA, 120 rounds, 10 Gbps and 100 Mbps access) from the card,
   each row equal to the CPU's;
12. trains on MATCHA: ``train(..., designer="matcha")`` at internlm2-1.8b's
   full width (4 of 24 layers, 4 silos, 3 rounds): finite losses, each
   round's consensus matrix equal to a host ``ScheduleSlot``'s, no
   ``gossip_mix`` launch (the mix is the reference's einsum), and one more
   round's mix on the card equal to A @ pre-mix computed on the CPU
   (1e-6 of the largest parameter, on a million columns);
13. checks that every instantiation of ``flash_attention`` (K3) runs
   its products on the tensor cores (``HGMMA`` in the library's SASS) and
   that none spills at hd 80; holds it against its plain version on the
   card (float32 at 2e-5, bfloat16 at 2e-2; B in {1, 2} x S in {128, 256,
   1024} x K in {1, 2, 8} x G in {1, 2, 4} x hd in {32, 64, 80, 128} x
   windows None, 32, 64, 100, 4096) and times it at h2o-danube-1.8b's
   prefill shape (B=2, S=T=8192, K=8, G=4, hd=80, window 4096, float32)
   in turns with the earlier CUDA-core kernel of the same source, its
   plain version and ``scaled_dot_product_attention``, beside its bound at
   the 3xTF32 rate and the float32 CUDA-core bound;
14. drives the serving path through ``repro_torch.launch.serve.serve``:
   h2o-danube-1.8b at full size (24 layers, random weights from seed 0,
   batch 2, an 8192-token prompt past the 4096 window, 32 tokens) with
   the kernel: one launch per layer in the prefill and none in decode,
   the prefill's last logits against the plain-path prefill (<= 2e-3) and
   the last decode step against a teacher-forced forward (<= 5e-3);
   internlm2-1.8b at full size (batch 4, prompt 1024, 16 tokens); and the
   reduced danube on the card against the CPU path from the same weights
   (<= 1e-4);
15. holds ``mlstm_scan`` (K4) against its plain chunked version on the
   card (B in {1, 2} x S in {128, 256, 1024} x H in {1, 4} x hd in {32,
   64, 128, 512} x chunk in {64, 128} x the forget gate biased by +2 or
   unbiased, float32 at atol 2e-4 / rtol 2e-3, bfloat16 at 2e-2, finite
   in every case) and, at xlstm-350m's forward shape (B=4, S=2048, H=4,
   hd=512, float32), holds the tensor-core kernels and the earlier
   CUDA-core kernel of the same source against plain, profiles the device
   kernels of one call and reports its scratch, and times the three in
   turns beside the 3xTF32 bound and the float32 CUDA-core bound;
16. drives the full-sequence forward of xlstm-350m at full width (12 of
   24 layers: 10 mLSTM, 2 sLSTM; random weights from seed 0, batch 4, 2048
   tokens, ``use_flash_kernel``): one ``mlstm_scan`` launch per mLSTM layer
   (10), finite logits, K4's device time summed over the 10 launches (a
   second forward under ``torch.profiler``, by kernel name, each seen
   exactly 10 times); each mLSTM layer through the kernel within 2e-3 of its
   plain path on the same input; the logits against the plain forward
   within 2e-3 or three times the difference between two plain forwards
   that differ only in chunk length (the sLSTM layers amplify rounding
   along the sequence), whichever is larger;
17. serves the same xlstm-350m (12 of 24 layers) through ``serve`` (batch
   4, prompt 2048, 129 tokens): no ``mlstm_scan`` launch in prefill or
   decode (they carry the state, as the reference's do), the last decode
   step against a teacher-forced forward through the kernel (10 launches) within 5e-3 or
   three times the rounding floor of such forwards, whichever is larger, the
   sLSTM loop's share and a profile of prefill and decode; then the
   reduced xlstm on the card against the CPU from the same weights (the
   served logits and a forward through the kernel, <= 1e-4);
18. drives the ``--dynamic`` path through ``train(..., dynamic=True)``:
   h2o-danube-1.8b at full width (1 of 24 layers, random weights from
   seed 0), Gaia's 11 silos under the churn scenario (silo 5 leaves and
   rejoins), ``gossip_impl="pallas"``, 25 rounds: an 11 -> 10 and a 10 ->
   11 migration, each equal on the card to the same migration on the CPU
   from the same state, with survivors bit-identical and joiners at the
   float64 consensus (checked on the card); the leaver's checkpoint
   re-read and equal to its pre-migration row; one ``gossip_mix`` launch
   a round; around each ``observe_round``, the K1 launches the code
   predicts (``rewire_steps + 1`` ``karp`` and ``reach`` a re-design, one
   ``timing`` a calibration); finite losses; each round's wall time, K, n
   and peak memory, each migration's and re-design's wall time;
19. runs the online controller on the card without a model: Gaia
   link failure with the ring as incumbent and the default configuration
   (at least one re-design, the slot moved twice, a closed critical
   circuit, more rounds by the deadline than the non-adaptive overlay,
   the climb's ``karp`` / ``reach`` launches as predicted) and a MATCHA
   re-fit on a degraded silo (``timing`` launches only); then both with
   the climb off, each re-design equal to the CPU's field for field;
20. holds ``flash_attention`` (K3) against its plain version at hd 128
   with the query groups of the MoE family and the last dense configs
   ((K, G) in {(4, 8), (1, 48), (8, 12)} x S in {128, 1024}, B = 2,
   causal, float32 at 2e-5) and times it at qwen3-moe-30b-a3b's prefill
   shape (B=2, S=T=1024, K=4, G=8, hd=128) in turns with its plain version
   and ``scaled_dot_product_attention``, beside its 3xTF32 bound;
21. serves qwen3-moe-30b-a3b (8 of 48 layers), deepseek-v2-lite-16b (8 of
   27: the dense MLA layer and 7 ``mla_moe``), granite-20b (4 of 52) and
   mistral-large-123b (2 of 88) at full width through ``serve`` (random
   weights from seed 0, batch 2, a 1024-token prompt, 16 tokens, float32,
   ``use_flash_kernel``): K3 launches in prefill equal to the
   ``attn``/``attn_moe`` layers (0 for deepseek), none in decode, finite
   logits, the share of (token, expert) assignments each MoE layer drops
   at the published capacity factor; at ``capacity_factor = n_experts``
   (dropless) the kernel prefill against the plain prefill (<= 2e-3), the
   last decode step against a teacher-forced plain forward (<= 5e-3), each
   attention layer through K3 against its plain path on the same input
   (<= 2e-3) and the count of tokens whose top-k expert set differs
   between the two runs; a profile and an MoE layer's parts (dispatch,
   expert products, the rest) timed by events; then the four reduced
   configs on the card against the CPU (<= 1e-4);
22. trains qwen3-moe-30b-a3b at full width (1 of 48 layers) through
   ``train`` on 2 silos of a ring, ``gossip_impl="pallas"``, 3 rounds at
   the published capacity factor: one ``gossip_mix`` launch a round,
   finite losses equal to cross entropy plus the router's aux loss, the
   round's profile; then one more round whose mix through K2 equals, bit
   for bit, K2's plain version on the same stack.
23. holds K3 against its plain version at hymba-1.5b's prefill shape (B=2,
   S=T=4096, K=5, G=5, hd=64, window 1024: 125 of a block's 128 query rows
   live) and internvl2-76b's (B=2, S=T=1280: 256 patches and a 1024-token
   prompt, K=8, G=8, hd=128, causal), float32 at 2e-5, and times each in
   turns with its plain version and a causal GQA
   ``scaled_dot_product_attention`` (at hymba's also with the window as a
   boolean mask, the same function), beside its 3xTF32 bound;
24. serves hymba-1.5b (16 of 32 layers; batch 2, a 4096-token prompt,
   four windows, 32 tokens) and internvl2-76b (4 of 80
   layers; batch 2, 256 seeded patch embeddings and a 1024-token prompt, 16
   tokens) at full width through ``serve`` with ``use_flash_kernel``: K3
   launches in prefill equal to the attention layers (16 and 4), none in
   decode, finite logits, the kernel prefill against the plain prefill (<=
   2e-3), the last decode step against a teacher-forced plain forward (<=
   5e-3), each attention layer through K3 against its plain path and each
   Mamba layer's chunked scan (output, final state, the head's output)
   against the per-token loop on the layer's recorded input (<= 2e-3); the
   scan's and the Mamba heads' share of a warm prefill by CUDA events, a
   profile of prefill and decode; then both reduced configs on the card
   against the CPU (<= 1e-4);
25. trains hymba-1.5b (16 of 32 layers) through ``train`` on 2 silos of a
   ring, ``gossip_impl="pallas"``, 3 rounds: one ``gossip_mix`` launch a
   round, finite losses, peak under 70 GiB, the round's profile; then one
   more round whose mix through K2 equals K2's plain version on the same
   stack bit for bit; and times K2 at the round's [2, 2 P] shape in turns
   with the grid-stride kernel, ``torch.lerp`` and its plain version;
26. holds K3 against its plain version at whisper-large-v3's decoder
   prefill shape (B=4, S=T=384, K=20, G=1, hd=64, causal: plain MHA, so a
   block's 128 query rows are 128 positions of one head), float32 at
   2e-5, and times it in turns with the CUDA-core kernel, its plain
   version and a causal ``scaled_dot_product_attention``, beside its
   3xTF32 bound;
27. serves whisper-large-v3 at full width with no cut (32 decoder and 32
   encoder layers; batch 4, 1500 seeded frames, a 384-token prompt, 64
   tokens: whisper's 448-token text context) through ``serve`` with
   ``use_flash_kernel``: 32 K3 launches in prefill (the decoder's causal
   self-attention; the encoder and cross-attention are bidirectional and
   stay on the chunked path), none in decode, no other kernel; each
   decoder layer's self-attention through K3 against its plain path on
   the layer's recorded input (<= 2e-3), the prefill against the plain
   prefill (<= 2e-3), the last decode step against a teacher-forced
   forward (<= 5e-3); the encoder's, the cross-attention's and K3's shares
   of a warm prefill by CUDA events, a profile of prefill and decode; then
   the reduced whisper on the card against the CPU (<= 1e-4, ids equal);
28. trains the zoo's way through ``repro_torch.launch.steps.build_train_step``:
   internlm2-1.8b at full width (4 of 24 layers) on 4 silos of a ring,
   ``gossip_impl="pallas"``, ``adamw(1e-4)``, ``flash_vjp``, 1 x 4096
   tokens a silo, 3 rounds (the reference's AdamW configuration cut to one
   card): finite losses, one ``gossip_mix`` launch a round and no K3 or K4
   launch, each round's wall, the peak, a traced round's idle share, then
   one more round whose K2 mix equals K2's plain version on the same stack
   bit for bit; ``flash_attention_vjp`` at the layer's shape (B=1,
   S=T=4096, K=8, G=2, hd=128, causal) against autograd through the chunked
   path (output 2e-5, gradients 2e-4), both timed in turns; one silo's
   local step with ``flash_vjp`` on and off (wall, peak above the state);
   one ``adamw`` update of a 2^26 row on the card against the CPU's (at
   most 1 ulp of each output's largest magnitude), timed beside its bound;
29. drives the serving step functions on silo 0's trained parameters:
   ``build_prefill_step`` with ``use_flash_kernel`` (batch 1, prompt 1024:
   4 K3 launches) and 8 ``build_decode_step`` calls (none), the first
   greedy token equal to ``serve``'s on the same parameters;
30. trains with one silo per process: phase 3's configuration (internlm2-1.8b,
   4 of 24 layers, 4 silos on a ring, ``pallas``, 3 rounds) as 4 ranks
   spawned on the one card over ``gloo``, every transfer staged through
   pinned host memory (NCCL refuses two ranks on one device): one K2 launch
   per rank a round, each rank's bytes received a round equal to its plan's
   distinct in-neighbours times P * 4, finite losses equal on every rank,
   the final rows within 1e-5 of the same configuration in one process
   (phase 3's rows, saved raw); one more round whose K2 call equals its
   plain version on the rank's stack bit for bit, and whose mixed row
   equals, bit for bit, row r of the stacked ``gossip_fused`` of the
   pre-mix rows (the sources' rows received once more, every other row
   NaN); every rank's round walls, peak, staged bytes and the staging's
   share of its rounds; then K2 timed at the per-rank shape (K = 2, N = P);
31. the same for phase 18's configuration (h2o-danube-1.8b, 1 of 24 layers,
   Gaia churn, 25 rounds; phase 18's rows) as 11 ranks: silo 5's rank idle
   between its leave and its rejoin (no launch, no byte), the migrations
   11 -> 10 -> 11, the controller's K1 launches on rank 0 only;
32. the launch tooling's dry run (``repro_torch.launch.dryrun.dryrun_one``)
   on four pairs of the assignment's shapes at full width: h2o-danube-1.8b
   ``prefill_32k`` at batch 1 through K3 (24 launches a prefill; K3 at the
   32k shape held against its plain version on the first layer's q, k, v,
   then timed in turns with its plain version and a windowed
   ``scaled_dot_product_attention``, chunked by query blocks, beside its
   bound), internlm2-1.8b ``decode_32k`` (the batch halves from the
   reference's 128 until the 3.2 GB-a-sequence cache fits), xlstm-350m
   ``long_500k`` (batch 1 at position 524,287) and internlm2-1.8b
   ``train_4k`` (one AdamW micro-step, halving from 16), a warm-up and one
   timed step each, no profile (the sweep profiles): each record ok,
   finite, its failed batches the halvings before the batch that ran, its
   step no faster than its roofline bound;
33. ``repro_torch.launch.perf_gossip`` at 4 ranks on the one card over
   staged gloo (internlm2-1.8b at full width, 1 of 24 layers, 1 x 1024
   tokens a silo, AdamW through ``build_train_step(mesh=)``): ring, chain
   and star under ``ppermute`` and ``pallas``, ring under ``einsum``, one
   round each from the same state (the CLI takes two: a warm-up and a
   timed round; one keeps this phase inside the script's time limit);
   every rank's bytes
   received equal to ``recv_bytes_per_round``, one K2 launch per rank a
   round under ``pallas`` and none otherwise, each plan's rows equal
   across its lowerings bit for bit where the CPU tests show them so (ring,
   star) and elsewhere (chain) within AdamW's 2 lr rounds, the bound the
   CPU tests hold AdamW rounds to; the star/ring traffic ratio 3;
   then K2 timed at the star's per-rank shape (K = 4, N = P).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
then exits non-zero and prints no result.  Without a CUDA device, or
outside the repository, it exits non-zero as well.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
F32_FLOPS = 67e12           # H100 SXM float32 rate outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM dense TF32 tensor-core rate
F64_FLOPS = 34e12           # H100 SXM float64 rate outside the tensor cores (NVIDIA data sheet)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# K3's sweep against its plain version, and h2o-danube-1.8b's prefill shape
# (B, S = T, K, G, hd, window) where it is timed
K3_SWEEP = {"B": (1, 2), "S": (128, 256, 1024), "K": (1, 2, 8), "G": (1, 2, 4),
            "hd": (32, 64, 80, 128), "window": (None, 32, 64, 100, 4096)}
K3_MAIN = (2, 8192, 8, 4, 80, 4096)
# serving runs at full size: (arch, batch, prompt length, tokens generated)
SERVE_RUNS = (("h2o-danube-1.8b", 2, 8192, 32), ("internlm2-1.8b", 4, 1024, 16))
# K4's sweep against its plain version (the forget gate's pre-activation
# biased by +2 as the reference's tests, or unbiased as the model's
# initialisation), its tolerances (atol, rtol: the reference's K4 sweep in
# float32), and xlstm-350m's forward shape (B, S, H, hd) where it is timed
K4_SWEEP = {"B": (1, 2), "S": (128, 256, 1024), "H": (1, 4), "hd": (32, 64, 128, 512),
            "chunk": (64, 128), "forget_bias": (2.0, 0.0)}
MLSTM_TOL = {"float32": (2e-4, 2e-3), "bfloat16": (2e-2, 2e-2)}
K4_MAIN = (4, 2048, 4, 512)
# xlstm-350m at full width, depth cut to the first 12 of its 24 blocks (10
# mLSTM, 2 sLSTM) to keep the script inside its time limit: the layers kept,
# the forward (batch, tokens: the xLSTM paper's training context) and a
# serving run (batch, prompt length, tokens)
XLSTM_LAYERS = 12
XLSTM_FORWARD = (4, 2048)
XLSTM_SERVE = (4, 2048, 129)
# K3 at hd 128 with the query groups (K, G) of qwen3-moe-30b-a3b, granite-20b
# (MQA) and mistral-large-123b, and qwen3-moe-30b-a3b's prefill shape
# (B, S = T, K, G, hd) where it is timed
K3_ZOO = {"KG": ((4, 8), (1, 48), (8, 12)), "S": (128, 1024)}
K3_QWEN3 = (2, 1024, 4, 8, 128)
# the MoE family and the last dense configs served at full width, depth cut
# so that the float32 weights fit one card: (arch, layers kept), and the run
# (batch, prompt length, tokens generated)
ZOO_SERVE = (("qwen3-moe-30b-a3b", 8), ("deepseek-v2-lite-16b", 8), ("granite-20b", 4),
             ("mistral-large-123b", 2))
ZOO_RUN = (2, 1024, 16)
# DPASGD on the MoE model: (arch, layers kept, silos on a ring, rounds)
MOE_TRAIN = ("qwen3-moe-30b-a3b", 1, 2, 3)
# K3 at hymba-1.5b's prefill shape (G = 5, hd 64, its 1024-token window)
# and internvl2-76b's (256 patches + a 1024-token prompt, G = 8, hd 128):
# (B, S = T, K, G, hd, window)
K3_HYBRID_VLM = {"hymba-1.5b": (2, 4096, 5, 5, 64, 1024),
                 "internvl2-76b": (2, 1280, 8, 8, 128, None)}
# the hybrid and the vision-prefix backbone served at full width: (arch,
# layers kept, batch, prompt length, tokens generated); hymba's 4096-token
# prompt is four windows, so its ring buffers wrap
HYBRID_VLM_SERVE = (("hymba-1.5b", 16, 2, 4096, 32), ("internvl2-76b", 4, 2, 1024, 16))
# DPASGD on hymba: (arch, layers kept, silos on a ring, rounds)
HYMBA_TRAIN = ("hymba-1.5b", 16, 2, 3)
# K3 at whisper-large-v3's decoder prefill shape (B, S = T, K, G, hd): plain
# MHA (G = 1), hd 64, causal
K3_WHISPER = (4, 384, 20, 1, 64)
# whisper-large-v3 served at full width, no cut (32 + 32 layers, 1500 seeded
# frames): (batch, prompt length, tokens generated); prompt plus tokens is
# whisper's 448-token text context (arXiv:2212.04356)
WHISPER_SERVE = (4, 384, 64)
# the zoo's training side: the reference's AdamW configuration
# (launch/perf_gossip.py: internlm2-1.8b, flash_vjp, adamw(1e-4), 4096-token
# sequences, s = 1) cut to one card: (arch, layers kept, silos on a ring,
# tokens a silo, rounds); flash_attention_vjp at its attention layers' shape
# (B, S = T, K, G, hd); the serving step functions on silo 0's trained
# parameters (batch, prompt length, decode steps)
ZOO_TRAIN = ("internlm2-1.8b", 4, 4, 4096, 3)
FLASH_VJP_SHAPE = (1, 4096, 8, 2, 128)
STEPS_SERVE = (1, 1024, 8)
# one silo per process on the card: the train phase's configuration (arch,
# layers kept, ranks on a ring, rounds) and the dynamic phase's (arch, layers
# kept, rounds; Gaia's 11 silos under churn), and the columns of a chunk of
# the check of the mixed rows against the stacked mix
DIST_TRAIN = ("internlm2-1.8b", 4, 4, 3)
DIST_DYNAMIC = ("h2o-danube-1.8b", 1, 25)
DIST_CHUNK = 1 << 22
# the launch tooling on the card: dry-run pairs (arch, shape, starting batch,
# None for the reference's; prefill through K3), the timed steps of each
# after its warm-up, and K3's query chunk for the windowed
# scaled_dot_product_attention at the 32k shape; perf_gossip's one-card run
# (ranks, layers kept, tokens a silo, rounds an entry: the CLI's two cut to
# one for the script's time limit)
DRYRUN_PAIRS = (("h2o-danube-1.8b", "prefill_32k", 1, True),
                ("internlm2-1.8b", "decode_32k", None, False),
                ("xlstm-350m", "long_500k", None, False),
                ("internlm2-1.8b", "train_4k", None, False))
DRYRUN_REPS = 1
SDPA_CHUNK = 4096
PERF_GOSSIP = (4, 1, 1024, 1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
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


def bound_ms(K: int, N: int, elem_bytes: int) -> tuple:
    """Least time for the mix: (K+1)*N elements moved, 2*K*N flops."""
    t_bytes = (K + 1) * N * elem_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * K * N / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gb_per_s(K: int, N: int, elem_bytes: int, ms: float) -> float:
    return (K + 1) * N * elem_bytes / (ms * 1e-3) / 1e9


def kernel_phase(torch, dev) -> dict:
    from repro_torch.kernels import gossip_mix
    from repro_torch.kernels.gossip_mix import gossip_mix_cuda, gossip_mix_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for K in (1, 2, 3, 5):
            for N in (1, 3, 1001, 4099, 65543, 1 << 20):
                for misaligned in (False, True):
                    base = torch.randn(K * N + 1, generator=gen, device=dev).to(dtype)
                    blocks = (base[1:] if misaligned else base[:-1]).view(K, N)
                    w = torch.softmax(torch.randn(K, generator=gen, device=dev), 0)
                    got = gossip_mix(blocks, w)
                    torch.cuda.synchronize()
                    ref = gossip_mix_ref(blocks, w)
                    err = float((got.float() - ref.float()).abs().max())
                    ok = torch.allclose(got.float(), ref.float(),
                                        atol=TOL[dtype_name], rtol=TOL[dtype_name])
                    check(ok, f"gossip_mix {dtype_name} K={K} N={N} "
                              f"misaligned={misaligned}: max abs err {err}")
                    if dtype_name == "float32":
                        worst = max(worst, err)
    K, N = 4, 5000
    const = torch.arange(N, dtype=torch.float32, device=dev).expand(K, N).contiguous()
    out = gossip_mix(const, torch.full((K,), 0.25, device=dev))
    check(torch.allclose(out, const[0], rtol=1e-6, atol=0.0),
          "convex combination does not preserve a constant vector")
    print(f"kernel gossip_mix: sweep K in (1,2,3,5) x 6 sizes x aligned/misaligned "
          f"x f32/bf16 within tolerance (f32 max abs err {worst:.3g}); constants preserved")

    # the streaming kernel against the grid-stride kernel it replaced: the same bits
    n_same = 0
    for dtype in (torch.float32, torch.bfloat16):
        for K in (1, 2, 3, 5, 9):
            for N in (1, 7, 4099, 65539, 1 << 20):
                for offset in (0, 3):
                    base = torch.randn(K * N + offset, generator=gen, device=dev).to(dtype)
                    blocks = base[offset:].view(K, N)
                    w = torch.softmax(torch.randn(K, generator=gen, device=dev), 0)
                    check(torch.equal(gossip_mix_cuda(blocks, w),
                                      gossip_mix_cuda(blocks, w, grid_stride=True)),
                          f"gossip_mix streaming vs grid-stride kernel {dtype} K={K} N={N} "
                          f"offset={offset}: not bit-identical")
                    n_same += 1
    print(f"kernel gossip_mix: streaming kernel bit-identical to the grid-stride kernel over "
          f"K in (1,2,3,5,9) x 5 sizes x aligned/misaligned x f32/bf16 ({n_same} cases)")

    K, N = 2, 1 << 28
    blocks = torch.randn((K, N), generator=gen, device=dev)
    w = torch.tensor([0.5, 0.5], device=dev)
    got = gossip_mix(blocks, w)
    err = float((got - gossip_mix_ref(blocks, w)).abs().max())
    check(err <= TOL["float32"], f"gossip_mix at K=2 N=2^28: max abs err {err}")
    check(torch.equal(got, gossip_mix_cuda(blocks, w, grid_stride=True)),
          "gossip_mix at K=2 N=2^28: streaming and grid-stride kernels differ")
    del got
    times = k2_in_turns(torch, blocks, w, reps=20, slow_reps=5)
    bound, by = bound_ms(K, N, 4)
    mean = {name: sum(t) / len(t) for name, t in times.items()}
    print(f"kernel gossip_mix K=2 N=2^28 f32, in turns: ms {fmt_times(times['kernel'])}  "
          f"grid-stride entry ms {fmt_times(times['grid_stride'])}  plain_ms "
          f"{fmt_times(times['plain'])}  library_ms torch.lerp {fmt_times(times['lerp'])} "
          f"torch.matmul {fmt_times(times['matmul'])}  bound_ms {bound:.4f} ({by})  "
          f"max_abs_err {err:.3g}  achieved {gb_per_s(K, N, 4, mean['kernel']):.1f} GB/s")
    return {"ms_2p28": mean["kernel"], "grid_stride_ms_2p28": mean["grid_stride"],
            "lerp_ms_2p28": mean["lerp"], "plain_ms_2p28": mean["plain"]}


def fmt_times(ts) -> str:
    return " / ".join(f"{t:.4f}" for t in ts)


def k2_in_turns(torch, blocks, w, reps: int, slow_reps: int) -> dict:
    """K2's streaming kernel, its grid-stride kernel, the plain version and
    the yardsticks (``torch.lerp``: the same convex combination of two
    rows, (1-w1)*b0 + w1*b1 with w0 + w1 = 1; ``torch.matmul`` below 2^31
    elements), timed in turns and then in the reverse order."""
    from repro_torch.kernels import gossip_mix
    from repro_torch.kernels.gossip_mix import gossip_mix_cuda, gossip_mix_ref

    K, N = blocks.shape
    check(K == 2 and abs(float(w.sum()) - 1.0) < 1e-6, "lerp yardstick needs K=2 convex weights")
    runs = {"kernel": (lambda: gossip_mix(blocks, w), reps),
            "grid_stride": (lambda: gossip_mix_cuda(blocks, w, grid_stride=True), reps),
            "lerp": (lambda: torch.lerp(blocks[0], blocks[1], w[1]), reps),
            "plain": (lambda: gossip_mix_ref(blocks, w), slow_reps)}
    if N < 2**31:
        runs["matmul"] = (lambda: torch.matmul(w, blocks), slow_reps)
    times = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        fn, n = runs[name]
        times[name].append(time_ms(torch, fn, reps=n, warmup=1))
    return times


def parity_phase(torch, dev) -> None:
    """One DPASGD round at the CPU tests' small size, on the card and on
    the CPU from the same state: the CPU path is the one
    tests/test_torch_dpasgd.py holds against the JAX package (2e-5)."""
    from repro_torch.configs import get_config
    from repro_torch.data import FederatedBatcher, SyntheticLMStream
    from repro_torch.fed import DPASGDConfig, init_state, make_train_step, plan_for_n_silos
    from repro_torch.launch.train import batch_to_device
    from repro_torch.optim import momentum

    cpu = torch.device("cpu")
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(), n_silos=4)
    opt = momentum(0.05, 0.9)
    step = make_train_step(cfg, DPASGDConfig(local_steps=2, gossip_impl="pallas"),
                           opt, plan_for_n_silos("ring", 4))
    host = init_state(cfg, opt, seed=0, device=cpu)
    card = {k: v.to(dev, copy=True) if torch.is_tensor(v) else v for k, v in host.items()}
    raw = FederatedBatcher(SyntheticLMStream(cfg.vocab_size, 16, n_silos=4), 2, 2).batch(0)
    host, m_host = step(host, batch_to_device(raw, cpu))
    card, m_card = step(card, batch_to_device(raw, dev))
    diff = float((card["params"].cpu() - host["params"]).abs().max())
    dloss = abs(float(m_card["loss"]) - float(m_host["loss"]))
    print(f"parity: one round at {cfg.n_layers} layers d_model {cfg.d_model}, card vs CPU: "
          f"max abs param diff {diff:.3g}, loss diff {dloss:.3g} (tolerance 2e-5)")
    check(diff <= 2e-5 and dloss <= 2e-5, f"card and CPU rounds differ: params {diff}, loss {dloss}")


def save_rows(params, path: str) -> None:
    """A run's final ``[n, P]`` float32 rows, raw, row after row: what the
    distributed phase of the same configuration holds its ranks' rows to."""
    with open(path, "wb") as f:
        for row in params:
            row.cpu().numpy().tofile(f)


def train_phase(torch, dev, ref_path: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.fed import make_train_step
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.train import batch_to_device, train

    cfg = get_config("internlm2-1.8b", n_layers=4)
    print(f"train: {cfg.arch_id} d_model {cfg.d_model} heads {cfg.n_heads} "
          f"kv_heads {cfg.n_kv_heads} head_dim {cfg.head_dim} d_ff {cfg.d_ff} "
          f"vocab {cfg.vocab_size} layers {cfg.n_layers} (of 24), 4 silos, ring, pallas")
    torch.cuda.reset_peak_memory_stats()
    steps = 3
    reset_launch_counts()
    res = train(cfg, silos=4, topology="ring", gossip_impl="pallas", local_steps=2,
                batch_per_silo=4, seq_len=64, steps=steps, device=dev,
                log=lambda line: print(line, flush=True))
    launches = dict(LAUNCHES)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    save_rows(res.state["params"], ref_path)  # before the next round moves them
    for i, (loss, sec) in enumerate(zip(res.losses, res.step_seconds)):
        print(f"train: round {i} wall {sec:.4f} s loss {loss:.6f}")
    print(f"train: peak device memory {peak / 2**30:.2f} GiB; "
          f"gossip_mix launches {launches['gossip_mix']} in {steps} rounds")
    check(all(math.isfinite(x) for x in res.losses), f"non-finite loss {res.losses}")
    check(launches["gossip_mix"] == steps,
          f"gossip_mix launched {launches['gossip_mix']} times in {steps} rounds")
    P = res.state["params"].shape[1]
    check(res.state["params"].shape == (4, P) and P == 630_736_896,
          f"state params shape {tuple(res.state['params'].shape)}")

    # one more round from the same state: kernel mix vs dense einsum mix
    state = res.state
    batch = batch_to_device(res.batcher.batch(steps), dev)
    fused = {"params": state["params"].clone(), "opt_state": state["opt_state"].clone(),
             "step": state["step"]}
    step_fused = make_train_step(res.cfg, dataclasses.replace(res.fed, gossip_impl="pallas"),
                                 res.optimizer, res.plan)
    fused, _ = step_fused(fused, batch)
    del fused["opt_state"]
    step_dense = make_train_step(res.cfg, dataclasses.replace(res.fed, gossip_impl="einsum"),
                                 res.optimizer, res.plan)
    dense, _ = step_dense(state, batch)
    diff = float((fused["params"] - dense["params"]).abs().max())
    print(f"train: one round pallas vs einsum from the same state: max abs param diff {diff:.3g}")
    check(diff <= 1e-5, f"pallas and einsum rounds differ by {diff}")
    return {"launches": launches["gossip_mix"], "n_elems": 4 * P,
            "K": len(res.plan.terms), "peak_bytes": peak,
            "round_s": res.step_seconds, "losses": res.losses}


def slice_shape_phase(torch, dev, K: int, N: int) -> dict:
    """The kernel at the main path's shape: one round's [K, n_silos*P] stack,
    in turns with the grid-stride kernel it replaced, torch.lerp and the
    plain version."""
    from repro_torch.kernels import gossip_mix
    from repro_torch.kernels.gossip_mix import gossip_mix_cuda, gossip_mix_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    blocks = torch.randn((K, N), generator=gen, device=dev)
    w = torch.tensor([0.5] * K, device=dev)
    got = gossip_mix(blocks, w)
    err = float((got - gossip_mix_ref(blocks, w)).abs().max())
    check(err <= TOL["float32"], f"gossip_mix at K={K} N={N}: max abs err {err}")
    check(torch.equal(got, gossip_mix_cuda(blocks, w, grid_stride=True)),
          f"gossip_mix at K={K} N={N}: streaming and grid-stride kernels differ")
    del got
    times = k2_in_turns(torch, blocks, w, reps=5, slow_reps=3)
    mean = {name: sum(t) / len(t) for name, t in times.items()}
    bound, by = bound_ms(K, N, 4)
    print(f"kernel gossip_mix K={K} N={N} f32 (main path), in turns: ms "
          f"{fmt_times(times['kernel'])}  grid-stride entry ms {fmt_times(times['grid_stride'])}  "
          f"plain_ms {fmt_times(times['plain'])}  library_ms torch.lerp "
          f"{fmt_times(times['lerp'])}  bound_ms {bound:.4f} ({by})  max_abs_err {err:.3g}  "
          f"achieved {gb_per_s(K, N, 4, mean['kernel']):.1f} GB/s ({bound / mean['kernel']:.1%} "
          f"of the bound; lerp {bound / mean['lerp']:.1%})")
    return {"ms": mean["kernel"], "grid_stride_ms": mean["grid_stride"],
            "plain_ms": mean["plain"], "library_ms": mean["lerp"], "bound_ms": bound,
            "bound_by": by, "max_abs_err": err}


def same_values(torch, got, ref) -> bool:
    """Bit for bit, except that the two zeros compare equal (the kernel's
    max(-0, +0) is +0; the plain version may return either): equal values
    where the plain version has a number, NaN exactly where it has NaN."""
    nan = torch.isnan(ref)
    return bool(torch.equal(torch.isnan(got), nan)) and bool((got[~nan] == ref[~nan]).all())


def device_kernels(torch, fn, lead_in: bool = False) -> tuple:
    """Run ``fn`` under ``torch.profiler`` (CUDA activity) and return
    (traced wall s, {kernel name: (launches, device us)}).  An empty dict
    means the profiler saw no device events.  Late in a long run the
    profiler drops the first device events of a window (more than eight
    of them late in this script's run) and now and then the last one;
    with ``lead_in`` the window opens with 64 spin kernels
    (``torch.cuda._sleep``) and closes with 8, all left out of the
    result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def spin(n: int) -> None:
        for _ in range(n):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if lead_in:
            spin(64)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if lead_in:
            spin(8)
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and not (lead_in and "spin_kernel" in ev.key):
            kernels[ev.key] = (ev.count, float(getattr(ev, "self_device_time_total", 0.0)))
    return wall, kernels


def complete_profile(torch, fn, complete, what: str, tries: int = 3) -> tuple:
    """``device_kernels`` with the lead-in, repeated until ``complete``
    holds for a window's kernels, in case the profiler drops a launch past
    the spin kernels.  Returns (traced wall s, {kernel name: (launches,
    device us)}, windows taken), and fails when none of ``tries`` windows
    is complete."""
    for window in range(1, tries + 1):
        wall, kernels = device_kernels(torch, fn, lead_in=True)
        if complete(kernels):
            return wall, kernels, window
    check(False, f"{what}: the profiler saw {kernels} in each of {tries} windows")


def segmax_bound_ms(B: int, E: int, S: int) -> float:
    """Least time of the segment max: each f32 value and int32 id read
    once, each f32 output written once, over the memory rate (one compare
    per edge is far below the operation bound)."""
    return (B * E * (4 + 4) + B * S * 4) / HBM_BYTES_PER_S * 1e3


def segmax_kernel_phase(torch, dev) -> dict:
    from repro_torch.kernels import edge_segment_max
    from repro_torch.kernels.segment_max import edge_segment_max_ref

    gen = torch.Generator(device=dev).manual_seed(2)
    dtypes = (torch.float32, torch.float64, torch.float16, torch.bfloat16)
    n_cases = 0
    worst = 0.0
    for B in (1, 3, 16, 64):
        for E in (1, 7, 261, 8192):
            for S in (1, 5, 87, 1024):
                base = torch.randn((B, E), generator=gen, device=dev)
                base[torch.rand((B, E), generator=gen, device=dev) < 0.15] = float("-inf")
                ids = torch.randint(-1, S + 1, (B, E), generator=gen, device=dev,
                                    dtype=torch.int32)
                for dtype in dtypes:
                    vals = base.to(dtype)
                    got = edge_segment_max(vals, ids, S)
                    torch.cuda.synchronize()
                    ref = edge_segment_max_ref(vals, ids, S)
                    check(got.dtype == dtype and same_values(torch, got.float(), ref.float()),
                          f"segment_max B={B} E={E} S={S} {dtype} differs from its plain version")
                    fin = torch.isfinite(ref)
                    if bool(fin.any()):
                        worst = max(worst, float((got.float() - ref.float())[fin].abs().max()))
                    n_cases += 1
    vals = torch.tensor([[1.0, float("nan"), 2.0, -0.0, 0.0, -0.0, 3.0]], device=dev)
    ids = torch.tensor([[0, 0, 1, 2, 2, 3, 9]], dtype=torch.int32, device=dev)
    got = edge_segment_max(vals, ids, 5).cpu()
    check(bool(torch.isnan(got[0, 0])) and got[0, 1] == 2.0, "segment_max NaN case")
    check(got[0, 2] == 0.0 and bool(torch.signbit(got[0, 3])) and bool(torch.isneginf(got[0, 4])),
          "segment_max signed-zero / empty-segment case")
    print(f"kernel segment_max: sweep B in (1,3,16,64) x E in (1,7,261,8192) x S in "
          f"(1,5,87,1024) x f32/f64/f16/bf16 ({n_cases} cases) bit-identical to the plain "
          f"version (max abs err {worst:.3g}); NaN and signed-zero cases pass")

    shapes = {}
    for name, (B, E, S) in (("ebone_climb", (16, 261, 87)), ("scoring", (8, 8192, 1024))):
        vals = torch.randn((B, E), generator=gen, device=dev)
        ids = torch.randint(0, S, (B, E), generator=gen, device=dev, dtype=torch.int32)
        ids64 = ids.long()
        got, ref = edge_segment_max(vals, ids, S), edge_segment_max_ref(vals, ids, S)
        fin = torch.isfinite(ref)  # some segments stay empty (-inf)
        err = float((got - ref)[fin].abs().max())
        check(same_values(torch, got, ref), f"segment_max at {name} shape: max abs err {err}")
        ms = time_ms(torch, lambda: edge_segment_max(vals, ids, S), reps=200, warmup=5)
        plain = time_ms(torch, lambda: edge_segment_max_ref(vals, ids, S), reps=50, warmup=2)
        out = torch.full((B, S), float("-inf"), device=dev)
        # yardstick only, never called by the port: one scatter_reduce_ with in-range ids
        library = time_ms(torch, lambda: out.scatter_reduce_(1, ids64, vals, "amax"),
                          reps=200, warmup=5)
        bound = segmax_bound_ms(B, E, S)
        # the event-timed loop above is paced by the host's launches; the
        # profiler's device time is the kernel's own
        _, kernels = device_kernels(torch, lambda: [edge_segment_max(vals, ids, S)
                                                    for _ in range(100)])
        own = [(c, us) for k, (c, us) in kernels.items() if "segment_max_kernel" in k]
        dev_ms = own[0][1] / own[0][0] / 1e3 if own else None
        dev_txt = f"{dev_ms:.5f}" if dev_ms is not None else "not measured"
        print(f"kernel segment_max B={B} E={E} S={S} f32 ({name}): ms {ms:.4f}  "
              f"device_ms {dev_txt}  plain_ms {plain:.4f}  library_ms scatter_reduce_ "
              f"{library:.4f}  bound_ms {bound:.6f} (bytes)  max_abs_err {err:.3g}")
        shapes[name] = {"ms": ms, "plain_ms": plain, "library_ms": library,
                        "bound_ms": bound, "bound_by": "bytes", "max_abs_err": max(err, worst)}
    return shapes


KARP_SHAPES = (("ebone_climb", (16, 261, 87)), ("scoring", (8, 8192, 1024)))


def karp_bound(B: int, E: int, N: int, elem_bytes: int) -> tuple:
    """Least time of a batch of Karp scores: the arcs (two int32 ids and a
    weight) read once and the [B] scores written once over the memory
    rate, or the 2*B*N*E adds and maxima of the N levels plus 3*B*N*N
    subtractions, divisions and minima of the final formula over the
    float32 rate, whichever is larger."""
    t_bytes = (B * E * (8 + elem_bytes) + B * elem_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * B * N * E + 3 * B * N * N) / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def karp_case(torch, gen, dev, B: int, N: int, E: int, padded: bool):
    """Arc lists as the climb builds them: a self-loop per node, random
    arcs, a fifth of them absent (-inf); row 0 acyclic (a path), node N - 1
    unreachable where N > 2, and with ``padded`` each row living on its
    first m_b nodes (a multi-universe pack: the rest -inf and absent).
    Returns (src, dst, w as float32, present)."""
    src = torch.randint(0, N, (B, E), generator=gen, device=dev, dtype=torch.int32)
    dst = torch.randint(0, N, (B, E), generator=gen, device=dev, dtype=torch.int32)
    k = min(N, E)
    src[:, :k] = torch.arange(k, dtype=torch.int32, device=dev)
    dst[:, :k] = src[:, :k]
    w = torch.rand((B, E), generator=gen, device=dev) * 19.5 + 0.5
    present = torch.rand((B, E), generator=gen, device=dev) >= 0.2
    if N > 2:
        present &= (src != N - 1) & (dst != N - 1)
    if padded:
        m = torch.randint(1, N + 1, (B, 1), generator=gen, device=dev)
        present &= (src < m) & (dst < m)
    if N > 1:
        m0 = min(N - 1 if N <= 2 else N - 2, E)  # the path stops short of node N - 1
        present[0] = False
        src[0, :m0] = torch.arange(m0, dtype=torch.int32, device=dev)
        dst[0, :m0] = src[0, :m0] + 1
        present[0, :m0] = True
    w = torch.where(present, w, float("-inf"))
    return src, dst, w, present & (src != dst)


def per_level_karp(torch, src, dst, w, N: int):
    """The Karp score as PRs 12-14 ran it on the card, a yardstick only:
    per level a gather, an add and one standalone segment_max launch,
    then the final formula."""
    from repro_torch.kernels import edge_segment_max
    from repro_torch.kernels.segment_max import karp_from_step

    src64 = src.long()
    return karp_from_step(lambda cur: edge_segment_max(torch.gather(cur, 1, src64) + w, dst, N),
                          w.shape[0], N, w.dtype, w.device)


def karp_kernel_phase(torch, dev) -> dict:
    """Both persistent K1 entries against their plain versions on the
    card, bit for bit, then one Karp score timed at the Ebone climb's
    shape and at the scoring shape."""
    from repro_torch.kernels import LAUNCHES, karp_cycle_time, reach_from_zero
    from repro_torch.kernels.segment_max import karp_cycle_time_ref, reach_from_zero_ref

    gen = torch.Generator(device=dev).manual_seed(4)
    dtypes = (torch.float32, torch.float64, torch.float16, torch.bfloat16)
    n_karp = n_reach = 0
    launches = dict(LAUNCHES)
    for B in (1, 3, 16, 64):
        for N in (1, 5, 87, 383, 1024):
            for E in (N, 3 * N, 8192):
                for padded in (False, True):
                    src, dst, w32, present = karp_case(torch, gen, dev, B, N, E, padded)
                    for dtype in dtypes:
                        w = w32.to(dtype)
                        got = karp_cycle_time(src, dst, w, N)
                        torch.cuda.synchronize()
                        ref = karp_cycle_time_ref(src, dst, w, N)
                        check(got.dtype == dtype and torch.equal(got, ref),
                              f"karp B={B} N={N} E={E} padded={padded} {dtype} differs from "
                              f"its plain version: {got.tolist()[:4]} vs {ref.tolist()[:4]}")
                        check(N == 1 or bool(torch.isneginf(got[0])),
                              f"karp B={B} N={N} E={E}: the acyclic row is not -inf")
                        n_karp += 1
                    got = reach_from_zero(src, dst, present, N)
                    torch.cuda.synchronize()
                    ref = reach_from_zero_ref(src, dst, present, N)
                    check(torch.equal(got, ref), f"reach B={B} N={N} E={E} padded={padded} "
                                                 f"differs from its plain version")
                    check(N <= 2 or not bool(got[:, :, N - 1].any()),
                          f"reach B={B} N={N} E={E}: the isolated node was reached")
                    n_reach += 1
    # arcs past shared memory: read from global memory at every level
    for dtype in dtypes:
        src, dst, w32, present = karp_case(torch, gen, dev, 2, 300, 30000, True)
        w = w32.to(dtype)
        check(torch.equal(karp_cycle_time(src, dst, w, 300), karp_cycle_time_ref(src, dst, w, 300)),
              f"karp with arcs in global memory ({dtype}) differs from its plain version")
        n_karp += 1
    check(torch.equal(reach_from_zero(src, dst, present, 300),
                      reach_from_zero_ref(src, dst, present, 300)),
          "reach with arcs in global memory differs from its plain version")
    n_reach += 1
    check(LAUNCHES["karp"] - launches["karp"] == n_karp
          and LAUNCHES["reach"] - launches["reach"] == n_reach,
          "the sweep's launches were not counted one per call")
    print(f"kernel karp: sweep B in (1,3,16,64) x N in (1,5,87,383,1024) x E in (N,3N,8192) x "
          f"one/multi-universe x f32/f64/f16/bf16, plus E=30000 ({n_karp} cases): bit-identical "
          f"to the plain version; acyclic rows -inf")
    print(f"kernel reach: the same graphs, forward and backward ({n_reach} cases): identical to "
          f"the plain version; isolated nodes unreached")

    shapes = {}
    for name, (B, E, N) in KARP_SHAPES:
        src, dst, w, present = karp_case(torch, gen, dev, B, N, E, False)
        w[0] = torch.rand(E, generator=gen, device=dev) + 1.0  # every row cyclic here
        got = karp_cycle_time(src, dst, w, N)
        ref = karp_cycle_time_ref(src, dst, w, N)
        err = float((got - ref).abs().max())
        check(torch.equal(got, ref), f"karp at {name} shape: max abs err {err}")
        levels = per_level_karp(torch, src, dst, w, N)
        check(torch.equal(levels, ref), f"per-level karp at {name} shape differs from plain")
        reps = 200 if N < 512 else 20
        ms = time_ms(torch, lambda: karp_cycle_time(src, dst, w, N), reps=reps, warmup=3)
        plain = time_ms(torch, lambda: karp_cycle_time_ref(src, dst, w, N), reps=3, warmup=1)
        per_level = time_ms(torch, lambda: per_level_karp(torch, src, dst, w, N), reps=3, warmup=1)
        bound, by = karp_bound(B, E, N, 4)
        _, kernels = device_kernels(torch, lambda: [karp_cycle_time(src, dst, w, N)
                                                    for _ in range(20)])
        own = [(c, us) for k, (c, us) in kernels.items() if "karp_kernel" in k]
        dev_ms = own[0][1] / own[0][0] / 1e3 if own else None
        dev_txt = f"{dev_ms:.5f}" if dev_ms is not None else "not measured"
        r_ms = time_ms(torch, lambda: reach_from_zero(src, dst, present, N), reps=reps, warmup=3)
        r_plain = time_ms(torch, lambda: reach_from_zero_ref(src, dst, present, N), reps=3)
        print(f"kernel karp B={B} E={E} N={N} f32 ({name}): ms {ms:.4f}  device_ms {dev_txt}  "
              f"plain_ms {plain:.4f}  per-level path (gather + add + segment_max a level) ms "
              f"{per_level:.4f} ({per_level / ms:.1f}x the kernel)  library_ms null  bound_ms "
              f"{bound:.6f} ({by})  max_abs_err {err:.3g}")
        print(f"kernel reach B={B} E={E} N={N} ({name}): ms {r_ms:.4f}  plain_ms {r_plain:.4f}")
        if name == "ebone_climb":
            check(per_level >= 10 * ms, f"karp at the Ebone climb shape: {ms:.4f} ms is not "
                                        f"10x below the per-level path's {per_level:.4f} ms")
        shapes[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain, "per_level_ms": per_level,
                        "bound_ms": bound, "bound_by": by, "max_abs_err": err, "library_ms": None,
                        "reach_ms": r_ms, "reach_plain_ms": r_plain}
    return shapes


def clustered_wan(n: int, n_clusters: int, seed: int = 0, comp_ms: float = 5.0):
    """The repo's sparse clustered WAN (the generator of
    benchmarks/sparse_search_bench.py, built here on the port's types):
    contiguous silo-id clusters with a low-latency intra ring + two chords,
    and high-latency bidirectional border pairs joining consecutive
    clusters, always including (last of c, first of c+1).  Returns
    ``(gc, cluster labels aligned with gc.silos)``."""
    import numpy as np

    from repro_torch.core import ConnectivityGraph, SiloParams

    rng = np.random.default_rng(seed)
    bounds = np.linspace(0, n, n_clusters + 1).astype(int)
    members = [list(range(bounds[c], bounds[c + 1])) for c in range(n_clusters)]
    members = [m for m in members if m]
    lat, bw = {}, {}

    def link(a: int, b: int, l: float) -> None:
        lat[(a, b)] = lat[(b, a)] = l
        bw[(a, b)] = bw[(b, a)] = float(rng.uniform(0.5, 2.0))

    labels = [0] * n
    for c, mem in enumerate(members):
        m = len(mem)
        for k, a in enumerate(mem):
            labels[a] = c
            link(a, mem[(k + 1) % m], float(rng.uniform(1.0, 5.0)))
            for off in (2, 3):
                if m > off + 1:
                    link(a, mem[(k + off) % m], float(rng.uniform(1.0, 5.0)))
        nxt = members[(c + 1) % len(members)]
        link(mem[-1], nxt[0], float(rng.uniform(20.0, 60.0)))
        link(int(mem[rng.integers(m)]), int(nxt[rng.integers(len(nxt))]),
             float(rng.uniform(20.0, 60.0)))
    params = {i: SiloParams(comp_ms, float(rng.uniform(5.0, 10.0)), float(rng.uniform(5.0, 10.0)))
              for i in range(n)}
    return ConnectivityGraph(tuple(range(n)), lat, bw, params), labels


def check_overlay(gc, tp, ov, max_degree: int, no_worse_than: float, what: str) -> int:
    """Degree bound, strong connectivity, the reported tau equal to the
    f64 host re-price of the edges, and no worse than ``no_worse_than``.
    Returns the overlay's largest in- or out-degree."""
    import numpy as np

    from repro_torch.core import (batched_cycle_time_auto, batched_is_strongly_connected_sparse,
                                  batched_overlay_delay_edges)

    arcs = [e for e in ov.edges if e[0] != e[1]]
    out_deg, in_deg = {}, {}
    for (i, j) in arcs:
        check(gc.has_edge(i, j), f"{what}: arc {(i, j)} not in the connectivity graph")
        out_deg[i] = out_deg.get(i, 0) + 1
        in_deg[j] = in_deg.get(j, 0) + 1
    deg = max(max(out_deg.values()), max(in_deg.values()))
    check(deg <= max_degree, f"{what}: degree {deg} above {max_degree}")
    eb = batched_overlay_delay_edges(gc, tp, arcs, np.ones((1, len(arcs)), dtype=bool))
    check(bool(batched_is_strongly_connected_sparse(eb)[0]), f"{what}: not strongly connected")
    tau = float(batched_cycle_time_auto(eb)[0])
    check(tau == ov.cycle_time_ms, f"{what}: reported tau {ov.cycle_time_ms} != host re-price {tau}")
    check(tau <= no_worse_than, f"{what}: tau {tau} worse than {no_worse_than}")
    return deg


def design_phase(torch, dev, wan=(4096, 64)) -> dict:
    """The design path on the card, one design at a time with the launch
    counts set to 0 just before it and read just after.  ``wan`` is the
    clustered WAN's (silos, clusters)."""
    import numpy as np

    from repro_torch.core import (NETWORK_NAMES, WORKLOADS, Overlay, TrainingParams,
                                  batched_cycle_time_auto, batched_overlay_delay_edges,
                                  cluster_silos, design_overlay, make_underlay, ring_overlay,
                                  search_overlays_hierarchical)
    from repro_torch.kernels import LAUNCHES, reset_launch_counts

    M, Tc = WORKLOADS["inaturalist"]
    tp = TrainingParams(model_size_mbits=M, local_steps=1)
    launches = 0
    overlays = {}

    def run(fn):
        nonlocal launches
        reset_launch_counts()
        t0 = time.perf_counter()
        ov = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = LAUNCHES["karp"]
        check(LAUNCHES["reach"] == n_launch and LAUNCHES["segment_max"] == 0,
              f"design launched karp {n_launch}, reach {LAUNCHES['reach']} and segment_max "
              f"{LAUNCHES['segment_max']} times: expected one reach per karp and no segment_max")
        launches += n_launch
        return ov, wall, n_launch

    rows = []
    for net in NETWORK_NAMES:
        gc = make_underlay(net).connectivity_graph(comp_time_ms=Tc)  # 10 Gbps access links
        n = gc.num_silos
        ring = ring_overlay(gc, tp)
        ov, wall, n_launch = run(lambda: design_overlay("sparse_rewire", gc, tp, device=dev))
        check(n_launch == 96 + 1, f"{net}: karp launched {n_launch} times, expected 96 + 1")
        deg = check_overlay(gc, tp, ov, 8, ring.cycle_time_ms, f"{net} sparse_rewire")
        print(f"design {net}: n {n}  ring tau {ring.cycle_time_ms:.6f} ms  sparse_rewire tau "
              f"{ov.cycle_time_ms:.6f} ms  arcs {len(ov.edges)}  max degree {deg}  "
              f"wall {wall:.4f} s  karp launches {n_launch}  reach launches {n_launch}")
        rows.append({"net": net, "n": n, "ring_tau": ring.cycle_time_ms,
                     "tau": ov.cycle_time_ms, "wall_s": wall, "launches": n_launch})
        overlays[net] = (gc, ov)

    # Where a design's time goes: Ebone's design again under the profiler,
    # its device busy time against the untraced wall above.
    gc = overlays["ebone"][0]
    traced, kernels = device_kernels(
        torch, lambda: design_overlay("sparse_rewire", gc, tp, device=dev))
    if kernels:
        busy = sum(us for _, us in kernels.values()) / 1e6
        n_kernels = sum(c for c, _ in kernels.values())
        k1 = sum(us for k, (_, us) in kernels.items()
                 if "karp_kernel" in k or "reach_kernel" in k) / 1e6
        untraced = rows[-1]["wall_s"]
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
        print(f"design ebone profile: traced wall {traced:.4f} s, device busy {busy:.4f} s "
              f"over {n_kernels} kernels ({n_kernels / 97:.0f} per climb step), "
              f"karp + reach {k1:.4f} s; idle share of the untraced {untraced:.4f} s design "
              f"{1 - busy / untraced:.4f}")
        check(n_kernels / 97 <= 300, f"ebone design: {n_kernels / 97:.0f} kernels a climb step")
        for name, (count, us) in top:
            print(f"  design kernel {us / 1e3:9.3f} ms  x{count:<6d} {name[:100]}")
    else:
        print("design ebone profile: device time not measured (no device events)")

    # The hierarchical designer's multi-universe climb: its intra climbs run
    # under delta_max - 1 and a border silo joining two neighbouring clusters
    # gains up to one more arc each way, so its bound is delta_max + 1.
    multi = [c for c in cluster_silos(gc, seed=0) if len(c) >= 2]
    nmax = max(len(c) for c in multi)
    ring = ring_overlay(gc, tp)
    ov, wall, n_launch = run(lambda: design_overlay("hierarchical", gc, tp, device=dev))
    check(n_launch == 64 + 1, f"ebone hierarchical: karp launched {n_launch} times, expected 64 + 1")
    deg = check_overlay(gc, tp, ov, 8 + 1, ring.cycle_time_ms, "ebone hierarchical")
    print(f"design ebone hierarchical: n {gc.num_silos}  clusters {len(multi)} (largest {nmax})  "
          f"ring tau {ring.cycle_time_ms:.6f} ms  tau {ov.cycle_time_ms:.6f} ms  arcs "
          f"{len(ov.edges)}  max degree {deg}  wall {wall:.4f} s  karp launches {n_launch}  "
          f"reach launches {n_launch}")
    rows.append({"net": "ebone_hierarchical", "n": gc.num_silos, "ring_tau": ring.cycle_time_ms,
                 "tau": ov.cycle_time_ms, "wall_s": wall, "launches": n_launch})

    n, k = wan
    gc, labels = clustered_wan(n, k, seed=2)
    incumbent = Overlay(name="ring", cycle_time_ms=float("inf"),
                        edges=tuple((i, (i + 1) % n) for i in range(n)))
    inc_eb = batched_overlay_delay_edges(gc, tp, list(incumbent.edges),
                                         np.ones((1, n), dtype=bool))
    inc_tau = float(batched_cycle_time_auto(inc_eb)[0])
    ov, wall, n_launch = run(lambda: search_overlays_hierarchical(
        gc, tp, labels=labels, n_restarts=1, n_steps=24, delta_max=8, seed=0,
        incumbent=incumbent, device=dev))
    nmax = max(labels.count(c) for c in range(k))
    check(n_launch == 24 + 1, f"wan hierarchical: karp launched {n_launch} times, expected 24 + 1")
    deg = check_overlay(gc, tp, ov, 8 + 1, inc_tau, "wan hierarchical")
    print(f"design wan hierarchical: n {n}  clusters {k} (largest {nmax})  identity-ring tau "
          f"{inc_tau:.6f} ms  tau {ov.cycle_time_ms:.6f} ms  arcs {len(ov.edges)}  max degree "
          f"{deg}  wall {wall:.4f} s  karp launches {n_launch}  reach launches {n_launch}")
    rows.append({"net": f"wan{n}_hierarchical", "n": n, "ring_tau": inc_tau,
                 "tau": ov.cycle_time_ms, "wall_s": wall, "launches": n_launch})
    return {"rows": rows, "launches": launches, "overlays": overlays}


def climb_parity_phase(torch, dev) -> None:
    """The climb's score of its seeds (n_steps=0) on Ebone: the card
    (persistent Karp and reachability kernels) against the CPU
    (degree-padded gather and the plain hop loop), bit for
    bit, for one universe and for padded multi-universe packs."""
    import numpy as np

    from repro_torch.core import WORKLOADS, TrainingParams, cluster_silos, make_underlay
    from repro_torch.core.topologies import (_on_device, _pack_universes, _seed_states,
                                             _universe, rewire_climb)

    M, Tc = WORKLOADS["inaturalist"]
    tp = TrainingParams(model_size_mbits=M, local_steps=1)
    gc = make_underlay("ebone").connectivity_graph(comp_time_ms=Tc)
    index = {v: k for k, v in enumerate(gc.silos)}
    single = _universe(gc, tp, index) + _seed_states(
        gc, tp, index, 16, 2 * gc.num_silos, 8, np.random.default_rng(0), None)[:3]
    multi = [c for c in cluster_silos(gc, seed=0) if len(c) >= 2]
    packed, _ = _pack_universes(gc, tp, multi, 2, 7, np.random.default_rng(0), None)
    cpu = torch.device("cpu")
    for mode, arrays, delta in (("single", single, 8), ("multi", packed, 7)):
        taus = []
        for d in (dev, cpu):
            res = rewire_climb(*_on_device(d, *arrays[:6]), np.float32(M),
                               *_on_device(d, *arrays[6:]),
                               generator=torch.Generator(device=d).manual_seed(0),
                               n_steps=0, delta_max=delta, multi=mode == "multi")
            taus.append(res[3].cpu())
        finite = int(torch.isfinite(taus[0]).sum())
        check(finite > 0 and torch.equal(taus[0], taus[1]),
              f"ebone climb score ({mode}) differs between card and CPU")
        print(f"climb parity ebone ({mode}, {len(taus[0])} restarts, {finite} feasible): "
              f"card == CPU bit for bit")


def design_slice_phase(torch, dev, gaia) -> int:
    """Gaia's designed overlay -> plan -> 3 DPASGD rounds through the
    kernel, then one round pallas vs einsum from the same state."""
    from repro_torch.configs import get_config
    from repro_torch.data import FederatedBatcher, SyntheticLMStream
    from repro_torch.fed import DPASGDConfig, init_state, make_train_step, plan_from_overlay
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.train import batch_to_device
    from repro_torch.optim import momentum

    gc, ov = gaia
    n = gc.num_silos
    plan = plan_from_overlay(ov, n)
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(), n_silos=n)
    opt = momentum(0.05, 0.9)
    fed = DPASGDConfig(local_steps=2, gossip_impl="pallas")
    step = make_train_step(cfg, fed, opt, plan)
    state = init_state(cfg, opt, seed=0, device=dev)
    batcher = FederatedBatcher(SyntheticLMStream(cfg.vocab_size, 16, n_silos=n), 2, 2)
    rounds = 3
    reset_launch_counts()
    losses = []
    for r in range(rounds):
        state, metrics = step(state, batch_to_device(batcher.batch(r), dev))
        losses.append(float(metrics["loss"]))
    launches = LAUNCHES["gossip_mix"]
    print(f"slice: gaia sparse_rewire ({len(ov.edges)} arcs, tau {ov.cycle_time_ms:.6f} ms) -> "
          f"plan with {plan.num_transfers} transfers -> {rounds} DPASGD rounds at "
          f"{cfg.n_layers} layers d_model {cfg.d_model}, {n} silos: losses "
          f"{[round(x, 6) for x in losses]}; gossip_mix launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(launches == rounds, f"gossip_mix launched {launches} times in {rounds} rounds")
    batch = batch_to_device(batcher.batch(rounds), dev)
    fused = {"params": state["params"].clone(), "opt_state": state["opt_state"].clone(),
             "step": state["step"]}
    fused, _ = step(fused, batch)
    dense, _ = make_train_step(cfg, dataclasses.replace(fed, gossip_impl="einsum"),
                               opt, plan)(state, batch)
    diff = float((fused["params"] - dense["params"]).abs().max())
    print(f"slice: one round pallas vs einsum on the designed plan: max abs param diff {diff:.3g}")
    check(diff <= 1e-5, f"pallas and einsum rounds on the designed plan differ by {diff}")
    return launches


def k2_plans_phase(torch, dev, overlays, N: int = 1 << 26) -> None:
    """K2 at every row count K that the port's plans give it: the plans of
    the designed overlays and the 4-silo ring, chain (``mst``) and star.
    At each K, N float32 elements a row: the streaming kernel (K fixed at
    compile time at 2, a run-time row loop otherwise) bit-identical to the
    grid-stride kernel, and the two timed in turns."""
    from repro_torch.fed import plan_for_n_silos, plan_from_overlay
    from repro_torch.kernels import gossip_mix
    from repro_torch.kernels.gossip_mix import gossip_mix_cuda

    ks = {f"{kind} 4": len(plan_for_n_silos(kind, 4).terms) for kind in ("ring", "mst", "star")}
    ks.update({f"{net} sparse_rewire": len(plan_from_overlay(ov, gc.num_silos).terms)
               for net, (gc, ov) in overlays.items()})
    gen = torch.Generator(device=dev).manual_seed(5)
    for K in sorted(set(ks.values())):
        blocks = torch.randn((K, N), generator=gen, device=dev)
        w = torch.softmax(torch.randn(K, generator=gen, device=dev), 0)
        check(torch.equal(gossip_mix(blocks, w), gossip_mix_cuda(blocks, w, grid_stride=True)),
              f"gossip_mix at K={K} N={N}: streaming and grid-stride kernels differ")
        runs = {"kernel": lambda: gossip_mix(blocks, w),
                "grid_stride": lambda: gossip_mix_cuda(blocks, w, grid_stride=True)}
        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            times[name].append(time_ms(torch, runs[name], reps=10))
        mean = {name: sum(t) / len(t) for name, t in times.items()}
        bound, by = bound_ms(K, N, 4)
        plans = ", ".join(name for name, k in ks.items() if k == K)
        print(f"kernel gossip_mix K={K} ({plans}) N={N} f32, in turns: ms "
              f"{fmt_times(times['kernel'])}  grid-stride entry ms "
              f"{fmt_times(times['grid_stride'])}  bound_ms {bound:.4f} ({by}); grid-stride / "
              f"kernel {mean['grid_stride'] / mean['kernel']:.3f}")
        del blocks


def timing_bound(C: int, R: int, U: int, E: int, N: int, elem_bytes: int) -> tuple:
    """Least time of the timing recursion: each input read once -- the
    [U, E] distinct weight rows, the [E] src and dst ids and the [C, R]
    round ids -- and the [C, R+1, N] start times written once, over the
    memory rate; or its 2*C*R*E adds and maxima over the float64 (float32)
    rate, whichever is larger."""
    t_bytes = (U * E * elem_bytes + E * 8 + C * R * 4 + C * (R + 1) * N * elem_bytes) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * C * R * E / (F64_FLOPS if elem_bytes == 8 else F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def geometric_gc(n: int, degree: int, seed: int = 0):
    """The repo's MATCHA engine network (the generator of
    benchmarks/matcha_budget.py, built here on the port's types): n silos
    at random points of the unit square, latency 10 + 100 x distance ms,
    10 Gbps access, and a random base graph of about ``degree`` pairs a
    silo.  Returns ``(gc, pairs)``."""
    import numpy as np

    from repro_torch.core import ConnectivityGraph, SiloParams

    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, 1.0, (n, 2))
    lat, bw = {}, {}
    for i in range(n):
        for j in range(n):
            if i != j:
                lat[(i, j)] = 10.0 + 100.0 * float(np.hypot(*(xy[i] - xy[j])))
                bw[(i, j)] = 1.0
    params = {v: SiloParams(comp_time_ms=float(rng.uniform(2.0, 6.0)), uplink_gbps=10.0,
                            downlink_gbps=10.0) for v in range(n)}
    gc = ConnectivityGraph(silos=tuple(range(n)), latency_ms=lat, available_bw_gbps=bw,
                           silo_params=params)
    pairs = sorted({(i, int(j)) for i in range(n) for j in rng.choice(n, degree, replace=False)
                    if i < j})
    return gc, pairs


def timing_case(torch, gen, dev, C, R, U, E, N, dtype, carry, with_t0, partial):
    """A MATCHA-like pool on the card: a self-loop per node first, random
    arcs after (their dst in the lower half of the nodes with ``partial``),
    a share of the arcs absent (-inf); with ``carry`` some rows drop some
    self-loops and the last row is all -inf."""
    k = min(N, E)
    src = torch.randint(0, N, (E,), generator=gen, device=dev, dtype=torch.int32)
    dst = torch.randint(0, max(N // 2, 1) if partial else N, (E,), generator=gen, device=dev,
                        dtype=torch.int32)
    src[:k] = torch.arange(k, dtype=torch.int32, device=dev)
    dst[:k] = src[:k]
    w = torch.rand((U, E), generator=gen, device=dev, dtype=torch.float64) * 80 + 0.5
    w[:, k:][torch.rand((U, E - k), generator=gen, device=dev) < 0.4] = float("-inf")
    if carry:
        w[:, :k][torch.rand((U, k), generator=gen, device=dev) < 0.3] = float("-inf")
        w[U - 1] = float("-inf")
    ids = torch.randint(0, U, (C, R), generator=gen, device=dev, dtype=torch.int32)
    t0 = (torch.rand((C, N), generator=gen, device=dev, dtype=torch.float64) * 100).to(dtype) \
        if with_t0 else None
    return src, dst, w.to(dtype), ids, t0


def timing_kernel_phase(torch, dev) -> dict:
    """K1's fourth entry, the round-varying Eq. 4 recursion of MATCHA
    pricing, against its plain version on the card, bit for bit, over a
    sweep of random pools; then timed in turns with it at the repo's
    engine shape and at Ebone's design shape."""
    import random

    import numpy as np

    from repro_torch.core import (DEFAULT_MATCHA_BUDGETS, WORKLOADS, MatchaSchedule, TrainingParams,
                                  greedy_edge_coloring, make_underlay,
                                  matcha_schedule_from_connectivity)
    from repro_torch.core.schedule import _sweep_inputs
    from repro_torch.kernels import LAUNCHES, timing_recursion
    from repro_torch.kernels.segment_max import timing_recursion_ref

    gen = torch.Generator(device=dev).manual_seed(6)
    pick = random.Random(6)
    before = LAUNCHES["timing"]
    n_cases = 0
    for i in range(216):
        C, R = pick.choice((1, 3, 24, 64)), pick.choice((1, 2, 17, 150, 300))
        U, N = pick.choice((1, 5, 24, 64)), pick.choice((2, 11, 87, 256, 512))
        E = pick.choice((1, N, 3 * N, 2048))
        dtype = (torch.float32, torch.float64)[i % 2]
        carry, with_t0, partial = i % 3 == 0, i % 4 == 1, i % 5 == 2
        src, dst, w, ids, t0 = timing_case(torch, gen, dev, C, R, U, E, N, dtype, carry,
                                           with_t0, partial)
        got = timing_recursion(src, dst, w, ids, N, t0)
        torch.cuda.synchronize()
        ref = timing_recursion_ref(src, dst, w, ids, N, t0)
        check(got.dtype == dtype and torch.equal(got, ref),
              f"timing C={C} R={R} U={U} E={E} N={N} {dtype} carry={carry} t0={with_t0} "
              f"partial={partial} differs from its plain version")
        n_cases += 1
    check(LAUNCHES["timing"] - before == n_cases, "the sweep's launches were not counted one per call")
    print(f"kernel timing_recursion: sweep C in (1,3,24,64) x R in (1,2,17,150,300) x U in "
          f"(1,5,24,64) x N in (2,11,87,256,512) x E in (1,N,3N,2048), missing self-loops, all--inf "
          f"rows, partial dst cover, t0, f32/f64 ({n_cases} cases): bit-identical to the plain "
          f"version")

    M, Tc = WORKLOADS["inaturalist"]
    tp = TrainingParams(model_size_mbits=M, local_steps=1)
    gc, pairs = geometric_gc(64, 8)
    matchings = tuple(tuple(m) for m in greedy_edge_coloring(pairs))
    engine = [MatchaSchedule(matchings=matchings, budget=b) for b in DEFAULT_MATCHA_BUDGETS]
    ebone = make_underlay("ebone").connectivity_graph(comp_time_ms=Tc)
    eb_matchings = matcha_schedule_from_connectivity(ebone).matchings
    designs = [MatchaSchedule(matchings=eb_matchings, budget=b) for b in DEFAULT_MATCHA_BUDGETS]
    shapes = {}
    for name, (scheds, g, R, seeds) in (("engine", (engine, gc, 300, tuple(range(8)))),
                                        ("ebone_design", (designs, ebone, 150, (0, 1, 2)))):
        arrays = _sweep_inputs(scheds, g, tp, R, seeds)
        src, dst, w, ids = (torch.from_numpy(a).to(dev) for a in arrays)
        N, (U, E), (C, _) = g.num_silos, w.shape, ids.shape
        got = timing_recursion(src, dst, w, ids, N)
        ref = timing_recursion_ref(src, dst, w, ids, N)
        err = float((got - ref).abs().max())
        check(torch.equal(got, ref), f"timing at the {name} shape: max abs err {err}")
        runs = {"kernel": (lambda: timing_recursion(src, dst, w, ids, N), 50),
                "plain": (lambda: timing_recursion_ref(src, dst, w, ids, N), 3)}
        times = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            fn, reps = runs[k]
            times[k].append(time_ms(torch, fn, reps=reps, warmup=1))
        mean = {k: sum(t) / len(t) for k, t in times.items()}
        bound, by = timing_bound(C, R, U, E, N, 8)
        def timing_own(kernels):
            return [(c, us) for k, (c, us) in kernels.items() if "timing_kernel" in k]

        _, kernels, windows = complete_profile(
            torch, lambda: [timing_recursion(src, dst, w, ids, N) for _ in range(20)],
            lambda ks: [c for c, _ in timing_own(ks)] == [20],
            f"timing at the {name} shape (timing_kernel 20 times)")
        dev_ms = timing_own(kernels)[0][1] / 20 / 1e3
        _, plain_kernels = device_kernels(torch, lambda: timing_recursion_ref(src, dst, w, ids, N),
                                          lead_in=True)
        plain_launches = sum(c for c, _ in plain_kernels.values())
        print(f"kernel timing_recursion C={C} R={R} U={U} E={E} N={N} f64 ({name}), in turns: ms "
              f"{fmt_times(times['kernel'])}  device_ms {dev_ms:.5f} (profile window {windows})  "
              f"plain_ms {fmt_times(times['plain'])} ({plain_launches} device kernels a call)  "
              f"library_ms null  bound_ms {bound:.6f} ({by})  max_abs_err {err:.3g}")
        shapes[name] = {"ms": mean["kernel"], "device_ms": dev_ms, "plain_ms": mean["plain"],
                        "bound_ms": bound, "bound_by": by, "max_abs_err": err,
                        "library_ms": None, "plain_launches": plain_launches}
    return shapes


def matcha_design_phase(torch, dev) -> dict:
    """MATCHA designs on the card at the reference's defaults (8 budgets x
    3 seeds x 150 rounds) on the paper's five networks, each with the
    counts set to 0 just before it and read just after: one ``timing``
    launch a design, every chain's tau equal to the CPU's bit for bit and
    the same budget chosen.  Then the time-to-eps objective on Geant, the
    idle share of a design on Ebone, and Table 10 from the card."""
    from repro_torch.core import (DEFAULT_MATCHA_BUDGETS, NETWORK_NAMES, WORKLOADS,
                                  MatchaSchedule, TrainingParams, average_cycle_times_batched,
                                  design_schedule, make_underlay,
                                  matcha_schedule_from_connectivity,
                                  matcha_schedule_from_underlay, ring_overlay)
    from repro_torch.core.schedule import _estimate_from_chains, _sweep_inputs
    from repro_torch.kernels import LAUNCHES, reset_launch_counts, timing_recursion

    M, Tc = WORKLOADS["inaturalist"]
    tp = TrainingParams(model_size_mbits=M, local_steps=1)
    seeds = (0, 1, 2)
    rows, launches, graphs = [], 0, {}
    for net in NETWORK_NAMES:
        gc = make_underlay(net).connectivity_graph(comp_time_ms=Tc)
        graphs[net] = gc
        reset_launch_counts()
        t0 = time.perf_counter()
        sched = design_schedule("matcha", gc, tp, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = dict(LAUNCHES)
        check(n_launch["timing"] == 1 and sum(n_launch.values()) == 1,
              f"{net}: a MATCHA design launched {n_launch}, expected one timing launch")
        launches += n_launch["timing"]
        cpu_sched = design_schedule("matcha", gc, tp, device="cpu")
        check(sched == cpu_sched, f"{net}: card chose budget {sched.budget}, CPU {cpu_sched.budget}")
        cands = [MatchaSchedule(matchings=sched.matchings, budget=b) for b in DEFAULT_MATCHA_BUDGETS]
        card = average_cycle_times_batched(cands, gc, tp, rounds=150, seeds=seeds, device=dev)
        cpu = average_cycle_times_batched(cands, gc, tp, rounds=150, seeds=seeds, device="cpu")
        check(bool((card == cpu).all()), f"{net}: card and CPU chains differ: {card} vs {cpu}")
        est = _estimate_from_chains(card[DEFAULT_MATCHA_BUDGETS.index(sched.budget)])
        ring = ring_overlay(gc, tp).cycle_time_ms
        print(f"matcha design {net}: n {gc.num_silos}  matchings {sched.num_matchings}  budget "
              f"{sched.budget:g}  tau {est.tau_ms:.6f} ms  ci95 {est.ci95_ms:.6f}  ring tau "
              f"{ring:.6f} ms  ring/matcha {ring / est.tau_ms:.4f}  wall {wall:.4f} s  timing "
              f"launches 1; {card.size} chains card == CPU bit for bit, same budget")
        rows.append({"net": net, "n": gc.num_silos, "budget": sched.budget, "tau": est.tau_ms,
                     "ci95": est.ci95_ms, "ring_tau": ring, "wall_s": wall})

    gc = graphs["geant"]
    s_card = design_schedule("matcha", gc, tp, objective="time_to_eps", device=dev)
    s_cpu = design_schedule("matcha", gc, tp, objective="time_to_eps", device="cpu")
    from repro_torch.core import schedule_rho

    rho = schedule_rho(s_card, gc, rounds=128, seed=0)
    check(s_card == s_cpu, f"geant time_to_eps: card budget {s_card.budget}, CPU {s_cpu.budget}")
    print(f"matcha design geant (time_to_eps): budget {s_card.budget:g}  rho {rho:.6f}; "
          f"card == CPU")

    # The idle share of a design on Ebone: the device's busy time under the
    # profiler over the traced design's own wall time, beside an untraced
    # design timed just before it.
    gc = graphs["ebone"]
    t0 = time.perf_counter()
    design_schedule("matcha", gc, tp, device=dev)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    traced, kernels, windows = complete_profile(
        torch, lambda: design_schedule("matcha", gc, tp, device=dev),
        lambda ks: [c for k, (c, _) in ks.items() if "timing_kernel" in k] == [1],
        "matcha design ebone profile (timing_kernel once)")
    busy = sum(us for _, us in kernels.values()) / 1e6
    n_kernels = sum(c for c, _ in kernels.values())
    k1 = sum(us for k, (_, us) in kernels.items() if "timing_kernel" in k) / 1e6
    print(f"matcha design ebone profile: traced wall {traced:.4f} s (untraced just before "
          f"{untraced:.4f} s), device busy {busy:.6f} s over {n_kernels} kernels, timing_kernel "
          f"{k1:.6f} s; idle share of the traced design {1 - busy / traced:.4f} (profile window "
          f"{windows})")
    # the same design's stages on the host clock: the activation masks, the
    # rest of the host work (dedup, Eq. 3 pricing of the distinct rows),
    # and the recursion with its copies to and from the card
    cands = [MatchaSchedule(matchings=matcha_schedule_from_connectivity(gc).matchings, budget=b)
             for b in DEFAULT_MATCHA_BUDGETS]
    t0 = time.perf_counter()
    for c in cands:
        for seed in seeds:
            c.activation_masks(150, seed)
    t_masks = time.perf_counter() - t0
    t0 = time.perf_counter()
    arrays = _sweep_inputs(cands, gc, tp, 150, seeds)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    times = timing_recursion(*(torch.from_numpy(a).to(dev) for a in arrays), gc.num_silos)
    times[:, 150].max(dim=1).values.cpu()
    t_dev = time.perf_counter() - t0
    print(f"matcha design ebone stages (host clock): activation masks {t_masks:.4f} s, dedup + "
          f"Eq. 3 pricing of {arrays[2].shape[0]} distinct rows x {arrays[2].shape[1]} arcs "
          f"{t_host - t_masks:.4f} s ({arrays[2].nbytes / 2**20:.1f} MiB of weights), copy + "
          f"recursion + read-back {t_dev:.4f} s")

    budgets = (1.0, 0.8, 0.6, 0.5, 0.4, 0.2, 0.1)
    print("matcha table 10 (AWS NA, ring speedup vs MATCHA+, 120 rounds): access " +
          " ".join(f"Cb={cb:g}" for cb in budgets))
    for access in (10.0, 0.1):
        u = make_underlay("aws_na", access_capacity_gbps=access)
        gc = u.connectivity_graph(comp_time_ms=Tc)
        ring = ring_overlay(gc, tp).cycle_time_ms
        scheds = [matcha_schedule_from_underlay(u, cb) for cb in budgets]
        card = average_cycle_times_batched(scheds, gc, tp, rounds=120, seeds=(0,), device=dev)
        cpu = average_cycle_times_batched(scheds, gc, tp, rounds=120, seeds=(0,), device="cpu")
        check(bool((card == cpu).all()), f"table 10 at {access} Gbps: card and CPU differ")
        print(f"matcha table 10 {access:g} Gbps: " + " ".join(f"{t / ring:.4f}" for t in card[:, 0])
              + "  (card == CPU)")
    return {"rows": rows, "launches": launches}


def matcha_train_phase(torch, dev) -> dict:
    """Static ``--designer matcha`` training at internlm2-1.8b's full width
    (4 of 24 layers, 4 silos, s = 2, 4 x 64 tokens a silo, 3 rounds): each
    round's consensus matrix is the host ScheduleSlot's, and no gossip_mix
    launch (the mix is the reference's einsum); then one more round's mix
    on the card against A @ pre-mix computed on the CPU."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import MatchaSchedule, greedy_edge_coloring
    from repro_torch.fed import ScheduleSlot
    from repro_torch.fed.dpasgd import make_train_step
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.train import batch_to_device, train

    cfg = get_config("internlm2-1.8b", n_layers=4)
    steps = 3
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = train(cfg, silos=4, gossip_impl="einsum", local_steps=2, batch_per_silo=4, seq_len=64,
                steps=steps, device=dev, designer="matcha", matcha_budget=0.5,
                log=lambda line: print(line, flush=True))
    launches = dict(LAUNCHES)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    host = ScheduleSlot(MatchaSchedule(matchings=tuple(tuple(m) for m in
                                                       greedy_edge_coloring(pairs)),
                                       budget=0.5), 4)
    sched = res.schedule_slot.schedule
    for i, (loss, sec) in enumerate(zip(res.losses, res.step_seconds)):
        print(f"matcha train: round {i} wall {sec:.4f} s loss {loss:.6f} matchings "
              f"{sched.round_active(i)} ({len(sched.round_edges(i))} arcs)")
        check(np.array_equal(res.consensus[i], host.matrix_for_round(i)),
              f"matcha train round {i}: the step's matrix is not the host ScheduleSlot's")
    print(f"matcha train: peak device memory {peak / 2**30:.2f} GiB; gossip_mix launches "
          f"{launches['gossip_mix']}; each round's matrix == the host ScheduleSlot's")
    check(all(math.isfinite(x) for x in res.losses), f"non-finite loss {res.losses}")
    check(launches["gossip_mix"] == 0, f"matcha training launched gossip_mix {launches}")

    # One more round through the same step, at the first round past the
    # run whose sampled matrix is not the identity: the local steps update
    # the state's buffer in place and the mix returns a new one, so the
    # old buffer holds the pre-mix parameters.  What the card mixed is held
    # against A @ pre-mix in float64 on the CPU, on a random million of
    # the columns.
    k = next(i for i in range(steps, steps + 100)
             if not np.array_equal(host.matrix_for_round(i), np.eye(4)))
    A = res.schedule_slot.matrix_for_round(k)
    step_fn = make_train_step(res.cfg, res.fed, res.optimizer, None, consensus_arg=True)
    pre = res.state["params"]
    new, _ = step_fn(res.state, batch_to_device(res.batcher.batch(k), dev), A)
    idx = torch.randint(0, pre.shape[1], (1 << 20,), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    pre_cols = pre[:, idx].double().cpu()
    got = new["params"][:, idx].double().cpu()
    want = torch.from_numpy(np.asarray(A, dtype=np.float64)) @ pre_cols
    err = float((got - want).abs().max())
    scale = float(pre_cols.abs().max())
    print(f"matcha train: round {k}'s mix on the card (matchings {sched.round_active(k)}) "
          f"against A @ pre-mix in float64 on the CPU over {idx.numel()} columns: max abs err "
          f"{err:.3g} (largest |param| {scale:.3g}, limit {1e-6 * scale:.3g})")
    check(err <= 1e-6 * scale, f"matcha train round {k}: the card's mix is not A @ pre-mix "
          f"(max abs err {err})")
    check(not torch.equal(got, pre_cols), f"matcha train round {k}: the mix changed nothing")
    out = {"round_s": res.step_seconds, "losses": res.losses, "peak_bytes": peak}
    del new, pre, res
    return out


def attn_pairs(S: int, T: int, causal: bool, window) -> int:
    """Visible (query, key) pairs of one (batch, head) at positions
    0..S-1 against 0..T-1."""
    total = 0
    for q in range(S):
        lo = 0 if window is None else max(0, q - window + 1)
        hi = min(T - 1, q) if causal else T - 1
        total += max(0, hi - lo + 1)
    return total


def attn_bound_ms(B: int, S: int, T: int, K: int, G: int, hd: int, window,
                  elem_bytes: int, passes: float = 1.0, rate: float = F32_FLOPS) -> tuple:
    """Least time of the attention: 4*hd operations (the score's and the
    value product's multiply-adds) per visible pair, ``passes`` times over
    at ``rate``, or q, k, v read once and the output written once at the
    memory rate."""
    ops = 4 * hd * attn_pairs(S, T, True, window) * B * K * G
    t_ops = passes * ops / rate * 1e3
    t_bytes = (2 * B * S * K * G * hd + 2 * B * T * K * hd) * elem_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_sass_counts(lib_path) -> dict:
    """``HGMMA`` instructions in each function of the K3 library's SASS
    (``cuobjdump -sass``), or None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?([a-z_]+_kernel)I(.+?)EE", line)
        if m:
            fn = f"{m.group(1)}<{m.group(2)}>"
            counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    return counts


def flash_build_phase() -> None:
    """The tensor-core K3 runs its products on the tensor cores (HGMMA in
    every instantiation's SASS) and spills nothing at danube's hd 80."""
    from repro_torch.kernels._build import BUILD_DIR, library_path

    counts = flash_sass_counts(library_path("flash_attention"))
    if counts is None:
        src = (ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu").read_text()
        print("kernel flash_attention: HGMMA count not measured (no cuobjdump); the source "
              f"holds wgmma.mma_async: {'wgmma.mma_async' in src}")
        check("wgmma.mma_async" in src, "flash_attention.cu holds no wgmma")
    else:
        tc = {k: v for k, v in counts.items() if k.startswith("flash_attention_kernel")}
        print("kernel flash_attention: HGMMA instructions in the SASS: " + ", ".join(
            f"{k} {v}" for k, v in sorted(counts.items())))
        check(len(tc) == 8 and all(v > 0 for v in tc.values()),
              f"tensor-core K3 instantiations without HGMMA: {tc}")
    log = (BUILD_DIR / "flash_attention.log").read_text()
    fn = ""
    for line in log.splitlines():
        m = re.search(r"Function properties for .*?([a-z_]+_kernel)I(.+?)EE", line)
        if m:
            fn = f"{m.group(1)}<{m.group(2)}>"
        elif fn.startswith("flash_attention_kernel") and "Li80" in fn and "spill" in line:
            check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                  f"{fn} spills at hd 80: {line.strip()}")


def flash_kernel_phase(torch, dev) -> dict:
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_ref

    flash_build_phase()
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_cases = 0
    sw = K3_SWEEP
    for B in sw["B"]:
        for S in sw["S"]:
            for K in sw["K"]:
                for G in sw["G"]:
                    for hd in sw["hd"]:
                        q = torch.randn((B, S, K, G, hd), generator=gen, device=dev)
                        k = torch.randn((B, S, K, hd), generator=gen, device=dev)
                        v = torch.randn((B, S, K, hd), generator=gen, device=dev)
                        for name, dtype in (("float32", torch.float32),
                                            ("bfloat16", torch.bfloat16)):
                            qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
                            for window in sw["window"]:
                                got = flash_attention(qd, kd, vd, causal=True, window=window)
                                torch.cuda.synchronize()
                                ref = flash_attention_ref(qd, kd, vd, causal=True, window=window)
                                err = float((got.float() - ref.float()).abs().max())
                                check(got.dtype == dtype and torch.allclose(
                                    got.float(), ref.float(), atol=TOL[name], rtol=TOL[name]),
                                    f"flash_attention {name} B={B} S={S} K={K} G={G} hd={hd} "
                                    f"window={window}: max abs err {err}")
                                worst[name] = max(worst[name], err)
                                n_cases += 1
    print(f"kernel flash_attention: sweep " + " x ".join(f"{k} {v}" for k, v in sw.items())
          + f" x f32/bf16 ({n_cases} cases) within tolerance (max abs err f32 "
          f"{worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g})")

    B, S, K, G, hd, window = K3_MAIN
    q = torch.randn((B, S, K, G, hd), generator=gen, device=dev)
    k = torch.randn((B, S, K, hd), generator=gen, device=dev)
    v = torch.randn((B, S, K, hd), generator=gen, device=dev)
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    got = flash_attention(q, k, v, causal=True, window=window)
    err = float((got - ref).abs().max())
    check(torch.allclose(got, ref, atol=TOL["float32"], rtol=TOL["float32"]),
          f"flash_attention at the danube prefill shape: max abs err {err}")
    simt = flash_attention_cuda(q, k, v, causal=True, window=window, simt=True)
    simt_err = float((simt - ref).abs().max())
    check(torch.allclose(simt, ref, atol=TOL["float32"], rtol=TOL["float32"]),
          f"CUDA-core flash_attention at the danube prefill shape: max abs err {simt_err}")
    # All three against float64 on the last 64 query positions of batch 0.
    rows = slice(S - 64, S)
    pos = torch.arange(S, device=dev)
    scores = torch.einsum("skgd,tkd->skgt", q[0, rows].double() * hd ** -0.5, k[0].double())
    seen = (pos[None, :] <= pos[rows, None]) & (pos[rows, None] - pos[None, :] < window)
    scores = torch.where(seen[:, None, None, :], scores, -1e30)
    exact = torch.einsum("skgt,tkd->skgd", torch.softmax(scores, -1), v[0].double())
    f64_err = {name: float((x[0, rows].double() - exact).abs().max())
               for name, x in (("kernel", got), ("cuda-core", simt), ("plain", ref))}
    print("kernel flash_attention at the danube prefill shape against float64 (last 64 "
          "positions of batch 0): max abs err " + ", ".join(
              f"{name} {err:.3g}" for name, err in f64_err.items()))
    del got, simt, scores, exact
    # Yardstick only, never called by the port: one scaled_dot_product_attention
    # over [B, H, S, hd] with the kv heads grouped and a boolean causal+window mask.
    F = torch.nn.functional
    qh = q.reshape(B, S, K * G, hd).transpose(1, 2)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
    try:
        sdpa = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, enable_gqa=True)
        sdpa_err = float((sdpa.transpose(1, 2).reshape(q.shape) - ref).abs().max())
        sdpa_txt = f"max abs diff to plain {sdpa_err:.3g}"
        del sdpa
    except torch.OutOfMemoryError as exc:
        sdpa_txt = f"not measured ({str(exc).splitlines()[0][:80]})"
        sdpa_fn = None
    else:
        def sdpa_fn():
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, enable_gqa=True)
    del ref
    torch.cuda.empty_cache()
    # In turns on one card: kernel, CUDA-core kernel, plain, SDPA, then back.
    runs = {"kernel": (lambda: flash_attention(q, k, v, causal=True, window=window), 5),
            "simt": (lambda: flash_attention_cuda(q, k, v, causal=True, window=window,
                                                  simt=True), 5),
            "plain": (lambda: flash_attention_ref(q, k, v, causal=True, window=window), 2),
            "sdpa": (sdpa_fn, 2)}
    times = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        fn, reps = runs[name]
        if fn is not None:
            times[name].append(time_ms(torch, fn, reps=reps, warmup=1))
    mean = {name: sum(t) / len(t) if t else None for name, t in times.items()}
    bound, by = attn_bound_ms(B, S, S, K, G, hd, window, 4, passes=3, rate=TF32_FLOPS)
    bound_f32, _ = attn_bound_ms(B, S, S, K, G, hd, window, 4)
    pairs = attn_pairs(S, S, True, window) * B * K * G

    def fmt(name):
        return " / ".join(f"{t:.4f}" for t in times[name]) or "not measured"

    print(f"kernel flash_attention B={B} S=T={S} K={K} G={G} hd={hd} window={window} f32 "
          f"(danube prefill), in turns: ms {fmt('kernel')}  cuda-core entry ms {fmt('simt')}  "
          f"plain_ms {fmt('plain')}  library_ms scaled_dot_product_attention {fmt('sdpa')} "
          f"({sdpa_txt})  bound_ms {bound:.4f} ({by}, 3xTF32 at {TF32_FLOPS / 1e12:.0f} "
          f"TFLOP/s; {pairs} visible pairs)  float32 CUDA-core bound {bound_f32:.4f}  "
          f"max_abs_err {err:.3g} (cuda-core {simt_err:.3g})  achieved "
          f"{4 * hd * pairs / (mean['kernel'] * 1e-3) / 1e12:.2f} TFLOP/s of fp32-accurate "
          f"products ({mean['simt'] / mean['kernel']:.2f}x the CUDA-core entry)")
    return {"ms": mean["kernel"], "simt_ms": mean["simt"], "plain_ms": mean["plain"],
            "library_ms": mean["sdpa"], "bound_ms": bound, "bound_by": by,
            "bound_f32_ms": bound_f32, "max_abs_err": max(err, worst["float32"])}


def serve_profile(torch, params, cfg, prompts, max_len: int, decode_step_s: float,
                  focus: str = "flash_attention", vision_embeds=None, enc_frames=None) -> dict:
    """Where a full-size prefill's and a decode step's time goes:
    ``torch.profiler`` device time by kernel against the traced and the
    untraced wall; ``focus`` names the hand-written kernel whose share is
    printed; a VLM's prefill takes ``vision_embeds``, an encoder-decoder's
    ``enc_frames``.  Returns the decode step's kernels and device-busy
    seconds."""
    from repro_torch.models import transformer as T

    def top(kernels, n=6):
        for name, (count, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:n]:
            print(f"  serve kernel {us / 1e3:9.3f} ms  x{count:<6d} {name[:100]}")

    with torch.no_grad():
        state = {}
        traced, kernels = device_kernels(torch, lambda: state.update(cache=T.prefill(
            params, cfg, prompts, max_len, cache_dtype=torch.float32,
            vision_embeds=vision_embeds, enc_frames=enc_frames)[1]))
        if not kernels:
            print("serve profile: device time not measured (no device events)")
            return {}
        busy = sum(us for _, us in kernels.values()) / 1e6
        mine = sum(us for k, (_, us) in kernels.items() if f"{focus}_kernel" in k) / 1e6
        print(f"serve profile {cfg.arch_id} prefill: traced wall {traced:.4f} s, device busy "
              f"{busy:.4f} s over {sum(c for c, _ in kernels.values())} kernels, "
              f"{focus} {mine:.4f} s ({mine / busy:.3f} of busy)")
        top(kernels)
        tok = prompts[:, -1]
        steps = 4
        pos = cfg.vision_prefix_len + prompts.shape[1]

        def decode():
            for i in range(steps):
                T.decode_step(params, cfg, tok, state["cache"], pos + i)

        traced, kernels = device_kernels(torch, decode)
    busy = sum(us for _, us in kernels.values()) / 1e6 / steps
    n = sum(c for c, _ in kernels.values()) / steps
    print(f"serve profile {cfg.arch_id} decode: {steps} steps, traced wall "
          f"{traced / steps:.4f} s a step, device busy {busy:.5f} s a step over {n:.0f} kernels; "
          f"idle share of the untraced {decode_step_s:.4f} s step {1 - busy / decode_step_s:.4f}")
    top(kernels)
    return {"decode_kernels": n, "decode_busy_s": busy}


def serve_phase(torch, dev) -> dict:
    """The serving path at full size, each run with the counts set to 0
    just before it and read just after, then checked against the plain
    path, a teacher-forced forward and the CPU."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import serve
    from repro_torch.models import init_params, model_specs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_map

    out = {}
    for arch, batch, prompt_len, gen in SERVE_RUNS:
        cfg = get_config(arch, use_flash_kernel=True)
        print(f"serve: {arch} d_model {cfg.d_model} heads {cfg.n_heads} kv_heads "
              f"{cfg.n_kv_heads} head_dim {cfg.head_dim} d_ff {cfg.d_ff} vocab "
              f"{cfg.vocab_size} window {cfg.sliding_window} layers {cfg.n_layers}; batch "
              f"{batch}, prompt {prompt_len}, {gen} tokens, float32, flash kernel")
        params = init_params(model_specs(cfg), seed=0, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        res = serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=0, device=dev,
                    params=params, log=lambda line: print(f"serve: {line}", flush=True))
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        fa = res.launches["prefill"]["flash_attention"]
        check(launches["flash_attention"] == fa == cfg.n_layers,
              f"{arch}: flash_attention launched {launches['flash_attention']} times, "
              f"expected {cfg.n_layers} (one per layer)")
        check(res.launches["decode"]["flash_attention"] == 0, f"{arch}: decode launched K3")
        check(bool(torch.isfinite(res.prefill_logits).all()), f"{arch}: non-finite prefill logits")
        with torch.no_grad():
            plain, _ = T.prefill(params, dataclasses.replace(cfg, use_flash_kernel=False),
                                 res.prompts, prompt_len + gen, cache_dtype=torch.float32)
        d_prefill = float((res.prefill_logits - plain).abs().max())
        check(torch.allclose(res.prefill_logits, plain, atol=2e-3, rtol=2e-3),
              f"{arch}: kernel prefill vs plain prefill max abs diff {d_prefill}")
        del plain
        seq = torch.cat([res.prompts, res.ids[:, :-1]], dim=1)
        with torch.no_grad():  # the chunked path: the length is not a multiple of 128
            full = T.forward(params, dataclasses.replace(cfg, remat=False,
                                                         use_flash_kernel=False), seq)[:, -1]
        d_decode = float((res.logits - full).abs().max())
        check(torch.allclose(res.logits, full, atol=5e-3, rtol=5e-3),
              f"{arch}: last decode step vs teacher-forced forward max abs diff {d_decode}")
        serve_profile(torch, params, cfg, res.prompts, prompt_len + gen,
                      res.decode_s / (gen - 1))
        del full, params, seq
        print(f"serve: {arch} prefill {res.prefill_s:.4f} s  decode {res.decode_tok_s:.2f} tok/s "
              f"({gen - 1} steps x batch {batch} in {res.decode_s:.4f} s)  peak device memory "
              f"{peak / 2**30:.2f} GiB  flash_attention launches prefill {fa} decode "
              f"{res.launches['decode']['flash_attention']}  kernel vs plain prefill logits "
              f"{d_prefill:.3g} (tol 2e-3)  last decode vs forward {d_decode:.3g} (tol 5e-3)")
        out[arch] = {"prefill_s": res.prefill_s, "decode_tok_s": res.decode_tok_s,
                     "peak_bytes": peak, "launches": fa}
        del res
        torch.cuda.empty_cache()

    # card (kernel) vs CPU (plain version) at the reduced size, same weights
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(), use_flash_kernel=True)
    params = init_params(model_specs(cfg), seed=0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128))
    runs = [serve(cfg, batch=2, prompt_len=128, gen=4, device=d, prompts=prompts,
                  params=p, log=lambda line: None)
            for d, p in ((dev, tree_map(lambda t: t.to(dev), params)), ("cpu", params))]
    d_pre = float((runs[0].prefill_logits.cpu() - runs[1].prefill_logits).abs().max())
    d_last = float((runs[0].logits.cpu() - runs[1].logits).abs().max())
    print(f"serve parity: reduced danube (2 layers, d_model {cfg.d_model}, window "
          f"{cfg.sliding_window}) at prompt 128, card vs CPU: prefill logits {d_pre:.3g}, "
          f"last decode logits {d_last:.3g} (tolerance 1e-4); ids equal "
          f"{bool(torch.equal(runs[0].ids.cpu(), runs[1].ids))}")
    check(runs[0].launches["prefill"]["flash_attention"] == cfg.n_layers,
          "reduced danube on the card did not go through the kernel")
    check(torch.equal(runs[0].ids.cpu(), runs[1].ids) and d_pre <= 1e-4 and d_last <= 1e-4,
          f"card and CPU serving differ: prefill {d_pre}, last {d_last}")
    return out


def mlstm_ops(B: int, S: int, H: int, hd: int) -> int:
    """The mLSTM scan's operations, counted as the reference kernel's work
    at its chunk of 128 (whatever chunk the kernel uses): per (batch, head,
    chunk) the q.k^T tile (128*129*hd multiply-adds, the causal half and
    the diagonal), the inter-chunk q.S and the state update (128*hd^2
    each), 2 operations a multiply-add."""
    return 2 * B * H * (S // 128) * (128 * 129 * hd + 2 * 128 * hd * hd)


def mlstm_bound_ms(B: int, S: int, H: int, hd: int, elem_bytes: int, passes: float = 1.0,
                   rate: float = F32_FLOPS) -> tuple:
    """Least time of the mLSTM scan: its operations ``passes`` times over
    at ``rate``, or q, k, v and the two gates read once and h written once
    at the memory rate."""
    t_ops = passes * mlstm_ops(B, S, H, hd) / rate * 1e3
    t_bytes = (4 * B * S * H * hd * elem_bytes + 2 * B * S * H * 4) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def short_kernel_name(name: str) -> str:
    """``mlstm_state_kernel<float>`` out of a demangled device kernel name."""
    m = re.search(r"(\w+_kernel)(<[^>]*>)?", name)
    return m.group(1) + (m.group(2) or "") if m else name[:60]


def mlstm_inputs(torch, gen, B, S, H, hd, forget_bias, dev):
    """q, k, v at 0.5 N(0, 1) and log-sigmoid gates; the forget gate's
    pre-activation biased by ``forget_bias``: 2 as the reference's tests,
    0 as the model's initialisation (in-chunk spans past exp's limit)."""
    q, k, v = (0.5 * torch.randn((B, S, H, hd), generator=gen, device=dev) for _ in range(3))
    F = torch.nn.functional
    li = F.logsigmoid(torch.randn((B, S, H), generator=gen, device=dev))
    lf = F.logsigmoid(torch.randn((B, S, H), generator=gen, device=dev) + forget_bias)
    return q, k, v, li, lf


def mlstm_kernel_phase(torch, dev) -> dict:
    """K4 against its plain chunked version over the sweep, with both gate
    draws (f32 at the reference's 2e-4 / 2e-3, bf16 at 2e-2, finite in
    every case), then at xlstm-350m's forward shape: the kernel and the
    CUDA-core entry against plain, the device kernels of one call, and the
    three timed in turns beside both bounds."""
    from repro_torch.kernels import mlstm_scan
    from repro_torch.kernels.mlstm_scan import (device_kernels_per_call, mlstm_chunked_ref,
                                                mlstm_scan_cuda, scratch_shapes)

    gen = torch.Generator(device=dev).manual_seed(4)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_cases = 0
    sw = K4_SWEEP
    for B in sw["B"]:
        for S in sw["S"]:
            for H in sw["H"]:
                for hd in sw["hd"]:
                    for bias in sw["forget_bias"]:
                        q, k, v, li, lf = mlstm_inputs(torch, gen, B, S, H, hd, bias, dev)
                        for name, dtype in (("float32", torch.float32),
                                            ("bfloat16", torch.bfloat16)):
                            qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
                            for chunk in sw["chunk"]:
                                got = mlstm_scan(qd, kd, vd, li, lf, chunk=chunk)
                                torch.cuda.synchronize()
                                ref = mlstm_chunked_ref(qd, kd, vd, li, lf, chunk=chunk)
                                err = float((got.float() - ref.float()).abs().max())
                                atol, rtol = MLSTM_TOL[name]
                                check(got.dtype == dtype and bool(torch.isfinite(got).all())
                                      and torch.allclose(got.float(), ref.float(),
                                                         atol=atol, rtol=rtol),
                                      f"mlstm_scan {name} B={B} S={S} H={H} hd={hd} "
                                      f"chunk={chunk} forget bias {bias}: max abs err {err}")
                                worst[name] = max(worst[name], err)
                                n_cases += 1
    print(f"kernel mlstm_scan: sweep " + " x ".join(f"{k} {v}" for k, v in sw.items())
          + f" x f32/bf16 ({n_cases} cases) finite and within tolerance (max abs err f32 "
          f"{worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g})")

    B, S, H, hd = K4_MAIN
    q, k, v, li, lf = mlstm_inputs(torch, gen, B, S, H, hd, 0.0, dev)
    got = mlstm_scan(q, k, v, li, lf)
    simt = mlstm_scan_cuda(q, k, v, li, lf, simt=True)
    ref = mlstm_chunked_ref(q, k, v, li, lf)
    err = float((got - ref).abs().max())
    simt_err = float((simt - ref).abs().max())
    for name, x in (("kernel", got), ("CUDA-core entry", simt)):
        check(bool(torch.isfinite(x).all()) and torch.allclose(
            x, ref, atol=MLSTM_TOL["float32"][0], rtol=MLSTM_TOL["float32"][1]),
            f"mlstm_scan {name} at the xlstm-350m shape: max abs err "
            f"{float((x - ref).abs().max())}")
    del got, simt, ref
    # device kernels of one call, by name, and the scratch it allocates
    calls = 5
    def k4_seen(kernels):
        return {short_kernel_name(name): (n, us) for name, (n, us) in kernels.items()
                if "mlstm_" in name}

    _, kernels, windows = complete_profile(
        torch, lambda: [mlstm_scan(q, k, v, li, lf) for _ in range(calls)],
        lambda ks: (len(k4_seen(ks)) == device_kernels_per_call(S)
                    and {n for n, _ in k4_seen(ks).values()} == {calls}),
        f"mlstm_scan in {calls} calls ({device_kernels_per_call(S)} device kernels once a call)")
    seen = k4_seen(kernels)
    per_call_txt = ", ".join(f"{name} {us / n:.1f} us" for name, (n, us) in
                             sorted(seen.items())) + \
        f" (mean of {calls} calls, profile window {windows})"
    scratch = sum(math.prod(shape) * 4 for shape in scratch_shapes(B, S, H, hd))
    # In turns on one card: kernel, CUDA-core kernel, plain, then back.
    runs = {"kernel": (lambda: mlstm_scan(q, k, v, li, lf), 10),
            "simt": (lambda: mlstm_scan_cuda(q, k, v, li, lf, simt=True), 5),
            "plain": (lambda: mlstm_chunked_ref(q, k, v, li, lf), 3)}
    times = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        fn, reps = runs[name]
        times[name].append(time_ms(torch, fn, reps=reps, warmup=1))
    mean = {name: sum(t) / len(t) for name, t in times.items()}
    bound, by = mlstm_bound_ms(B, S, H, hd, 4, passes=3, rate=TF32_FLOPS)
    bound_f32, _ = mlstm_bound_ms(B, S, H, hd, 4)
    ops = mlstm_ops(B, S, H, hd)
    print(f"kernel mlstm_scan B={B} S={S} H={H} hd={hd} f32 unbiased gates (xlstm-350m "
          f"forward), in turns: ms {fmt_times(times['kernel'])}  cuda-core entry ms "
          f"{fmt_times(times['simt'])}  plain_ms {fmt_times(times['plain'])}  library_ms none "
          f"(no single PyTorch call computes the scan)  bound_ms {bound:.4f} ({by}, 3xTF32 at "
          f"{TF32_FLOPS / 1e12:.0f} TFLOP/s; {ops:.4g} operations at chunk 128)  float32 "
          f"CUDA-core bound {bound_f32:.4f}  max_abs_err {err:.3g} (cuda-core {simt_err:.3g})  "
          f"achieved {ops / (mean['kernel'] * 1e-3) / 1e12:.2f} TFLOP/s of the bound's "
          f"operations ({mean['simt'] / mean['kernel']:.2f}x the CUDA-core entry)")
    print(f"kernel mlstm_scan: {device_kernels_per_call(S)} device kernels per call "
          f"({per_call_txt}), scratch {scratch} bytes ({scratch / 2**20:.1f} MiB: "
          f"chunk states {scratch_shapes(B, S, H, hd)[0]}, scores "
          f"{scratch_shapes(B, S, H, hd)[1]}, float32)")
    return {"ms": mean["kernel"], "simt_ms": mean["simt"], "plain_ms": mean["plain"],
            "library_ms": None, "bound_ms": bound, "bound_by": by, "bound_f32_ms": bound_f32,
            "max_abs_err": max(err, worst["float32"]), "scratch_bytes": scratch}


def forward_at_chunk(torch, params, cfg, tokens, chunk: int, record=None):
    """``transformer.forward`` with every mLSTM layer's plain scan at
    ``chunk`` (the model's own is 128), so two plain runs differ only by
    rounding; with ``record`` a list, each mLSTM layer's (params, input,
    output) is appended to it."""
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T

    orig = SSM.mlstm_forward

    def run(p, c, x, *args, **kwargs):
        out = orig(p, c, x, chunk, **kwargs)
        if record is not None:
            record.append((p, x, out))
        return out

    SSM.mlstm_forward = run
    try:
        with torch.no_grad():
            return T.forward(params, cfg, tokens)
    finally:
        SSM.mlstm_forward = orig


def rounding_floor(torch, params, cfg, tokens, ref, last_only=False) -> float:
    """The largest logit difference between ``ref`` (the plain forward at
    chunk 128) and the plain forward at chunk 64 and at chunk 32: the same
    function, rounded otherwise.  xLSTM's sLSTM layers amplify such a
    difference along the sequence, so two correct float32 forwards of a
    long sequence differ by this much."""
    plain = dataclasses.replace(cfg, use_flash_kernel=False)
    floor = 0.0
    for chunk in (64, 32):
        other = forward_at_chunk(torch, params, plain, tokens, chunk)
        if last_only:
            other = other[:, -1]
        floor = max(floor, float((other - ref).abs().max()))
        del other
    return floor


def xlstm_forward_phase(torch, dev) -> dict:
    """The full-sequence forward of xlstm-350m at full width (12 of 24
    layers) through K4:
    one launch per mLSTM layer; each mLSTM layer through the kernel
    against its plain path on the same input (<= 2e-3); the logits against
    the plain forward, within three times the rounding floor of two plain
    forwards (or 2e-3 where that is larger)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.kernels.mlstm_scan import device_kernels_per_call
    from repro_torch.models import init_params, model_specs
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T

    B, S = XLSTM_FORWARD
    cfg = get_config("xlstm-350m", n_layers=XLSTM_LAYERS, use_flash_kernel=True, remat=False)
    n_mlstm = cfg.block_pattern.count("mlstm")
    print(f"forward: {cfg.arch_id} d_model {cfg.d_model} heads {cfg.n_heads} mLSTM head_dim "
          f"{cfg.ssm.expand * cfg.d_model // cfg.n_heads} vocab {cfg.vocab_size} layers "
          f"{cfg.n_layers} ({n_mlstm} mLSTM, {cfg.n_layers - n_mlstm} sLSTM); batch {B}, "
          f"{S} tokens, float32, mlstm kernel")
    params = init_params(model_specs(cfg), seed=0, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)))
    tokens = tokens.to(dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        logits = T.forward(params, cfg, tokens)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    check(launches["mlstm_scan"] == n_mlstm,
          f"xlstm forward launched mlstm_scan {launches['mlstm_scan']} times, "
          f"expected {n_mlstm}")
    check(bool(torch.isfinite(logits).all()), "xlstm forward: non-finite logits")
    # K4's device time within the forward: its kernels, by name, summed over the launches
    with torch.no_grad():
        def k4_of(kernels):
            return {short_kernel_name(name): v for name, v in kernels.items() if "mlstm_" in name}

        traced_s, kernels, windows = complete_profile(
            torch, lambda: T.forward(params, cfg, tokens),
            lambda ks: (len(k4_of(ks)) == device_kernels_per_call(S)
                        and {n for n, _ in k4_of(ks).values()} == {n_mlstm}),
            f"xlstm forward profile ({device_kernels_per_call(S)} mlstm_scan device kernels "
            f"{n_mlstm} times each)")
    k4 = k4_of(kernels)
    k4_s = sum(us for _, us in k4.values()) * 1e-6
    busy_s = sum(us for _, us in kernels.values()) * 1e-6
    print(f"forward profile: {cfg.arch_id} [{B}x{S}] traced wall {traced_s:.4f} s, device "
          f"busy {busy_s:.4f} s over {sum(n for n, _ in kernels.values())} kernels; "
          f"mlstm_scan device time {k4_s:.4f} s over its {n_mlstm} launches (" +
          ", ".join(f"{name} {n} x {us / n:.1f} us" for name, (n, us) in sorted(k4.items())) +
          f"; profile window {windows})")
    record = []
    t0 = time.perf_counter()
    plain = forward_at_chunk(torch, params, dataclasses.replace(cfg, use_flash_kernel=False),
                             tokens, 128, record)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(bool(torch.isfinite(plain).all()), "xlstm plain forward: non-finite logits")
    layer_err = 0.0
    with torch.no_grad():
        for p, x, out in record:
            got = SSM.mlstm_forward(p, cfg, x)
            err = float((got - out).abs().max())
            check(torch.allclose(got, out, atol=2e-3, rtol=2e-3),
                  f"xlstm mLSTM layer through mlstm_scan vs plain: max abs diff {err}")
            layer_err = max(layer_err, err)
    del record
    diff = float((logits - plain).abs().max())
    floor = rounding_floor(torch, params, cfg, tokens, plain)
    tol = max(2e-3, 3 * floor)
    print(f"forward: {cfg.arch_id} [{B}x{S}] wall {kernel_s:.4f} s through mlstm_scan "
          f"({launches['mlstm_scan']} launches), plain {plain_s:.4f} s; each mLSTM layer "
          f"through the kernel vs plain on the same input max abs diff {layer_err:.3g} "
          f"(tolerance 2e-3); logits kernel vs plain {diff:.3g}, plain at chunk 64 and 32 vs "
          f"128 {floor:.3g} (tolerance max(2e-3, 3 x that) = {tol:.3g}); max |logit| "
          f"{float(plain.abs().max()):.4g}")
    check(diff <= tol, f"xlstm forward, kernel vs plain: max abs logit diff {diff} > {tol}")
    del logits, plain, params
    torch.cuda.empty_cache()
    return {"launches": launches["mlstm_scan"], "kernel_s": kernel_s, "plain_s": plain_s,
            "layer_err": layer_err, "logit_diff": diff, "floor": floor, "k4_device_s": k4_s}


def xlstm_serve_phase(torch, dev) -> dict:
    """xlstm-350m (12 of 24 layers) served through ``serve``: the mLSTM kernel
    runs no time in prefill and decode (they carry the state, as in the
    reference); the last decode step against a teacher-forced forward
    through the kernel; the sLSTM loop's share; then the reduced model on
    the card against the CPU."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import serve
    from repro_torch.models import init_params, model_specs
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_map

    batch, prompt_len, gen = XLSTM_SERVE
    cfg = get_config("xlstm-350m", n_layers=XLSTM_LAYERS, use_flash_kernel=True)
    print(f"serve: {cfg.arch_id} layers {cfg.n_layers} (of 24); batch {batch}, prompt {prompt_len}, "
          f"{gen} tokens, float32 states, use_flash_kernel")
    params = init_params(model_specs(cfg), seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=0, device=dev,
                params=params, log=lambda line: print(f"serve: {line}", flush=True))
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches["mlstm_scan"] == 0 and res.launches["prefill"]["mlstm_scan"] == 0
          and res.launches["decode"]["mlstm_scan"] == 0,
          f"xlstm serving launched mlstm_scan: {res.launches}")
    check(bool(torch.isfinite(res.prefill_logits).all()), "xlstm: non-finite prefill logits")
    seq = torch.cat([res.prompts, res.ids[:, :-1]], dim=1)
    fcfg = dataclasses.replace(cfg, remat=False)
    with torch.no_grad():
        reset_launch_counts()
        full = T.forward(params, fcfg, seq)[:, -1]
        torch.cuda.synchronize()
        forced = LAUNCHES["mlstm_scan"]
    n_mlstm = cfg.block_pattern.count("mlstm")
    check(forced == n_mlstm, f"teacher-forced forward launched mlstm_scan {forced} times")
    d_decode = float((res.logits - full).abs().max())
    plain = forward_at_chunk(torch, params, dataclasses.replace(fcfg, use_flash_kernel=False),
                             seq, 128)[:, -1]
    floor = max(float((full - plain).abs().max()),
                rounding_floor(torch, params, fcfg, seq, plain, last_only=True))
    tol_decode = max(5e-3, 3 * floor)
    check(d_decode <= tol_decode,
          f"xlstm: last decode step vs teacher-forced forward max abs diff {d_decode} > "
          f"{tol_decode}")
    del full, seq, plain

    # the sLSTM loop's share of a prefill's and of the decode steps' wall
    spent = {"forward": 0.0, "decode": 0.0}
    orig = {"forward": SSM.slstm_forward, "decode": SSM.slstm_decode}

    def timed(kind):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[kind](*args, **kwargs)
            torch.cuda.synchronize()
            spent[kind] += time.perf_counter() - t0
            return out
        return run

    SSM.slstm_forward, SSM.slstm_decode = timed("forward"), timed("decode")
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache = T.prefill(params, cfg, res.prompts, prompt_len + gen,
                                 cache_dtype=torch.float32)
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t0
            tok = res.ids[:, 0]
            t0 = time.perf_counter()
            steps = 8
            for i in range(steps):
                logits, cache = T.decode_step(params, cfg, tok, cache, prompt_len + i)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            dec_s = time.perf_counter() - t0
    finally:
        SSM.slstm_forward, SSM.slstm_decode = orig["forward"], orig["decode"]
    del cache
    print(f"serve profile {cfg.arch_id}: sLSTM loop {spent['forward']:.4f} s of a "
          f"{pre_s:.4f} s prefill ({spent['forward'] / pre_s:.3f}); sLSTM decode "
          f"{spent['decode'] / steps:.5f} s of a {dec_s / steps:.5f} s step "
          f"({spent['decode'] / dec_s:.3f}; both timed with a synchronise around each sLSTM layer)")
    prof = serve_profile(torch, params, cfg, res.prompts, prompt_len + gen,
                         res.decode_s / (gen - 1), focus="mlstm_scan")
    print(f"serve: {cfg.arch_id} prefill {res.prefill_s:.4f} s  decode {res.decode_tok_s:.2f} "
          f"tok/s ({gen - 1} steps x batch {batch} in {res.decode_s:.4f} s)  peak device memory "
          f"{peak / 2**30:.2f} GiB  mlstm_scan launches prefill "
          f"{res.launches['prefill']['mlstm_scan']} decode {res.launches['decode']['mlstm_scan']}"
          f" teacher-forced forward {forced}  last decode vs forward {d_decode:.3g} (tolerance "
          f"max(5e-3, 3 x {floor:.3g}, the largest last-token difference among forwards "
          f"through the kernel and the plain path at chunk 128, 64 and 32) = {tol_decode:.3g})")
    out = {"prefill_s": res.prefill_s, "decode_tok_s": res.decode_tok_s, "peak_bytes": peak,
           "slstm_share": spent["forward"] / pre_s, "d_decode": d_decode, **prof}
    del res, params
    torch.cuda.empty_cache()

    # card (kernel) vs CPU (plain version) at the reduced size, same weights
    cfg = dataclasses.replace(get_config("xlstm-350m").reduced(), use_flash_kernel=True)
    params = init_params(model_specs(cfg), seed=0, device="cpu")
    card = tree_map(lambda t: t.to(dev), params)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128))
    runs = [serve(cfg, batch=2, prompt_len=128, gen=4, device=d, prompts=prompts,
                  params=p, log=lambda line: None) for d, p in ((dev, card), ("cpu", params))]
    d_pre = float((runs[0].prefill_logits.cpu() - runs[1].prefill_logits).abs().max())
    d_last = float((runs[0].logits.cpu() - runs[1].logits).abs().max())
    tokens = torch.from_numpy(prompts)
    with torch.no_grad():
        reset_launch_counts()
        fwd_card = T.forward(card, dataclasses.replace(cfg, remat=False), tokens.to(dev))
        torch.cuda.synchronize()
        fwd_launches = LAUNCHES["mlstm_scan"]
        fwd_cpu = T.forward(params, dataclasses.replace(cfg, remat=False), tokens)
    d_fwd = float((fwd_card.cpu() - fwd_cpu).abs().max())
    ids_equal = bool(torch.equal(runs[0].ids.cpu(), runs[1].ids))
    print(f"serve parity: reduced xlstm ({cfg.block_pattern}, d_model {cfg.d_model}) at prompt "
          f"128, card vs CPU: prefill logits {d_pre:.3g}, last decode logits {d_last:.3g}, "
          f"forward through mlstm_scan ({fwd_launches} launch) {d_fwd:.3g} (tolerance 1e-4); "
          f"ids equal {ids_equal}")
    check(fwd_launches == cfg.block_pattern.count("mlstm"),
          f"reduced xlstm forward launched mlstm_scan {fwd_launches} times")
    check(ids_equal and max(d_pre, d_last, d_fwd) <= 1e-4,
          f"card and CPU xlstm differ: prefill {d_pre}, last {d_last}, forward {d_fwd}")
    return out


CHURN_STEPS = 25  # phase 18's rounds: Gaia churn, 11 -> 10 -> 11 silos


def redesign_launches(rd, rewire_steps: int, n_silos: int) -> dict:
    """The K1 launches one re-design makes on the card, as the code
    predicts them: a fixed-pool re-design runs the rewire climb (one
    ``karp`` and one ``reach`` launch per scored climb step, ``rewire_steps
    + 1`` each, when it has 2 to 383 silos and the climb is on) and one
    calibration (``timing``); a MATCHA re-fit runs the budget sweep and a
    calibration (two ``timing`` launches) and no climb."""
    if rd.schedule.is_randomized:
        return {"karp": 0, "reach": 0, "timing": 2}
    climb = rewire_steps + 1 if rewire_steps and 2 <= n_silos < 384 else 0
    return {"karp": climb, "reach": climb, "timing": 1}


def dynamic_train_phase(torch, dev, ref_path: str) -> dict:
    """``train(..., dynamic=True)`` on Gaia churn at h2o-danube-1.8b's full
    width (1 of 24 layers, 11 -> 10 -> 11 silos, 25 rounds, pallas): each
    migration on the card equal to the same migration on the CPU, survivors
    and joiners verified on the card, the leaver's checkpoint re-read, one
    gossip_mix launch a round, and each observed round's K1 launches as the
    code predicts them."""
    import os
    import tempfile

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.dynamics import ControllerConfig
    from repro_torch.dynamics import controller as ctl_mod
    from repro_torch.fed import migrate_silo_state
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.train import train
    from repro_torch.models import ParamLayout, model_specs, state_to_tree

    cfg = get_config("h2o-danube-1.8b", n_layers=1)
    layout = ParamLayout(model_specs(cfg))
    print(f"dynamic train: {cfg.arch_id} d_model {cfg.d_model} vocab {cfg.vocab_size} layers "
          f"{cfg.n_layers} (of 24), P {layout.size}, Gaia churn, pallas, {CHURN_STEPS} rounds")
    migrations, observed = [], []

    def on_migration(info):
        # the same migration on the CPU from the same pre-migration state,
        # one buffer at a time; the leavers' rows for the checkpoint check
        old, new = info["old_state"], info["new_state"]
        t = time.perf_counter()
        same = {}
        for key in ("params", "opt_state"):
            host = migrate_silo_state({"params": old[key].cpu(), "opt_state": None, "step": 0},
                                      info["old_active"], info["new_active"])[0]["params"]
            same[key] = torch.equal(new[key].cpu(), host)
            del host
        rows = {v: {k: old[k][info["old_active"].index(v)].cpu() for k in ("params", "opt_state")}
                for v in info["left"]}
        migrations.append(dict(info, cpu_equal=same, cpu_check_s=time.perf_counter() - t,
                               rows=rows, step=old["step"], old_state=None, new_state=None))

    observe = ctl_mod.OnlineTopologyController.observe_round

    def observe_counted(self, duration_ms):
        before = dict(LAUNCHES)
        rd = observe(self, duration_ms)
        observed.append(({k: LAUNCHES[k] - before[k] for k in LAUNCHES}, rd, len(self.gc.silos)))
        return rd

    with tempfile.TemporaryDirectory() as tmp:
        final_path = os.path.join(tmp, "final.msgpack")
        ctl_mod.OnlineTopologyController.observe_round = observe_counted
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            res = train(cfg, dynamic=True, underlay="gaia", scenario="churn", gossip_impl="pallas",
                        designer="auto", local_steps=2, batch_per_silo=4, seq_len=64,
                        steps=CHURN_STEPS, verify_migration=True,
                        churn_checkpoint=os.path.join(tmp, "leavers"), checkpoint=final_path,
                        device=dev, on_migration=on_migration,
                        log=lambda line: print(line, flush=True))
        finally:
            ctl_mod.OnlineTopologyController.observe_round = observe
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        final_gb = os.path.getsize(final_path) / 1e9
        checkpointed = 0
        for m in migrations:
            for v, path in zip(m["left"], m["checkpoints"]):
                got = load_checkpoint(path, state_to_tree(dict(m["rows"][v], step=m["step"]),
                                                          layout))
                for key in ("params", "opt_state"):
                    row = layout.flatten_into(got[key], torch.empty(layout.size))
                    check(torch.equal(row, m["rows"][v][key]),
                          f"leaver {v}'s checkpoint {key} is not its pre-migration row")
                check(int(got["step"]) == m["step"], f"leaver {v}'s checkpoint step")
                checkpointed += 1
                print(f"dynamic train: leaver silo {v} checkpoint ({os.path.getsize(path) / 1e9:.3f}"
                      f" GB) re-read by load_checkpoint == its pre-migration row (params and "
                      f"momentum, step {m['step']})")
    save_rows(res.state["params"], ref_path)
    for i, (rec, sec, loss) in enumerate(zip(res.rounds, res.step_seconds, res.losses)):
        print(f"dynamic train: round {i} wall {sec:.4f} s K {rec['K']} n {rec['n']} peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB loss {loss:.6f}")
    check(all(math.isfinite(x) for x in res.losses), f"non-finite loss {res.losses}")
    moves = [(len(m["old_active"]), len(m["new_active"])) for m in migrations]
    check((11, 10) in moves and (10, 11) in moves, f"membership moves {moves}")
    for m in migrations:
        print(f"dynamic train: migration {len(m['old_active'])} -> {len(m['new_active'])} (left "
              f"{list(m['left'])}, joined {list(m['joined'])}) wall {m['wall_s']:.4f} s on the "
              f"card; survivors bit-identical {m['survivors_ok']}, joiners at the float64 "
              f"consensus {m['joiners_ok']}; card == CPU migration {m['cpu_equal']} (checked in "
              f"{m['cpu_check_s']:.1f} s)")
        check(m["survivors_ok"] and m["joiners_ok"], f"migration invariants {m['left'], m['joined']}")
        check(all(m["cpu_equal"].values()), f"the card's migration is not the CPU's: {m['cpu_equal']}")
    check(checkpointed >= 1, "no leaver checkpoint was written")
    check(launches["gossip_mix"] == CHURN_STEPS,
          f"gossip_mix launched {launches['gossip_mix']} times in {CHURN_STEPS} rounds")
    rewire_steps = ControllerConfig().rewire_steps
    for i, (d, rd, n) in enumerate(observed):
        check(d["gossip_mix"] == 0 and d["segment_max"] == 0, f"round {i}: observe launched {d}")
        want = ({"karp": 0, "reach": 0, "timing": 0} if rd is None
                else redesign_launches(rd, rewire_steps, n))
        got = {k: d[k] for k in want}
        if rd is not None:
            print(f"dynamic train: re-design at round {i} ({'membership -> ' + str(len(rd.membership)) + ' silos' if rd.membership else 'strike'}"
                  f") -> {rd.schedule.name}: elapsed {rd.elapsed_s:.4f} s, {rd.n_candidates} "
                  f"candidates, predicted tau {rd.predicted_tau_ms:.3f} ms, launches {got}")
        check(got == want, f"round {i}: observe_round launched {got}, the code predicts {want}")
    redesigns = res.controller.redesigns
    check(launches["timing"] == 1 + len(redesigns),
          f"timing launches {launches['timing']}, calibrations {1 + len(redesigns)}")
    peak = max(r["peak_bytes"] for r in res.rounds)
    print(f"dynamic train: {len(redesigns)} re-designs, {res.membership_slot.version} membership "
          f"swaps, launches {launches}; peak device memory {peak / 2**30:.2f} GiB; final "
          f"checkpoint {final_gb:.2f} GB; train() wall {wall:.1f} s")
    out = {"launches": launches, "round_s": res.step_seconds, "peak_bytes": peak,
           "K": res.rounds[-1]["K"], "n_elems": len(res.active) * layout.size,
           "migration_s": [m["wall_s"] for m in migrations],
           "redesign_s": [rd.elapsed_s for rd in redesigns], "wall_s": wall}
    del res, migrations
    return out


def _controller_loop(dev, case: str, config, counted: bool = False):
    """The reference tests' Gaia loops without a model: ``linkfail`` with
    the ring as incumbent and a PlanSlot, or ``matcha``: a degraded silo
    under ``schedule_family="matcha"`` with a ScheduleSlot.  Returns the
    controller, the slot, the per-round K1 launches and the rounds
    completed by the deadline."""
    import repro_torch.core as C
    import repro_torch.dynamics as D
    from repro_torch.fed import PlanSlot, ScheduleSlot, plan_from_overlay
    from repro_torch.kernels import LAUNCHES

    M, Tc = C.WORKLOADS["inaturalist"]
    u = C.make_underlay("gaia")
    gc = u.connectivity_graph(comp_time_ms=Tc)
    tp = C.TrainingParams(model_size_mbits=M, local_steps=1)
    ring = C.ring_overlay(gc, tp)
    tau = ring.cycle_time_ms
    if case == "linkfail":
        deadline = 400 * tau
        sc = D.link_failure_scenario(u, Tc, t_fail_ms=deadline / 3, overlay_edges=ring.edges,
                                     horizon_ms=deadline)
        slot = PlanSlot(plan_from_overlay(ring, gc.num_silos))
        kw = {"plan_slot": slot}
        rounds = None
    else:
        sc = D.silo_degrade_scenario(u, Tc, silo=3, t_ms=30 * tau, factor=0.02,
                                     horizon_ms=300 * tau)
        slot = ScheduleSlot(C.FixedSchedule(ring), gc.num_silos, silos=gc.silos)
        kw = {"schedule_slot": slot}
        rounds, deadline = 100, None
    tl = D.DynamicTimeline(sc, tp)
    tl.set_overlay(ring.edges)

    def provider():
        ep = tl.current_epoch()
        return D.active_subgraph(ep.gc, ep.active)

    ctl = D.OnlineTopologyController(gc, tp, ring, config=config, connectivity_provider=provider,
                                     device=dev, **kw)
    per_round, k = [], 0
    while (tl.now_ms < deadline) if rounds is None else (k < rounds):
        before = dict(LAUNCHES)
        rd = ctl.observe_round(tl.step())
        per_round.append(({n: LAUNCHES[n] - before[n] for n in LAUNCHES}, rd))
        if rd is not None:
            tl.set_schedule(rd.schedule)
        k += 1
    done = (sum(1 for f in tl.round_finish_ms[1:] if f <= deadline) if deadline else None)
    baseline = (D.simulate_dynamic(sc, tp, ring.edges, num_rounds=500).rounds_completed_by(deadline)
                if deadline else None)
    return ctl, slot, per_round, done, baseline


def redesign_record(rd) -> tuple:
    """The fields of a re-design two runs must share (not its wall time)."""
    sched = rd.schedule
    return (rd.round_idx, None if rd.overlay is None else rd.overlay.edges,
            None if not sched.is_randomized else (sched.matchings, sched.budget, sched.sample_seed),
            rd.predicted_tau_ms, rd.n_candidates, rd.bottleneck, rd.membership, rd.measured_ms,
            rd.expected_window_ms)


def controller_phase(torch, dev) -> dict:
    """The online controller on the card without a model: Gaia link failure
    (rewire climb on: karp/reach launches as predicted) and a MATCHA re-fit
    on a degraded silo (timing launches only), then both with the climb off,
    each re-design equal to the CPU's field for field."""
    from repro_torch.dynamics import ControllerConfig

    t0 = time.perf_counter()
    cfg = ControllerConfig(seed=0)
    ctl, slot, per_round, done, baseline = _controller_loop(dev, "linkfail", cfg)
    check(len(ctl.redesigns) >= 1 and slot.version >= 2,
          f"linkfail: {len(ctl.redesigns)} re-designs, slot version {slot.version}")
    rd = ctl.redesigns[0]
    check(len(rd.bottleneck) >= 2 and rd.bottleneck[0] == rd.bottleneck[-1],
          f"linkfail: the critical circuit {rd.bottleneck} does not close")
    check(done > baseline, f"linkfail: {done} rounds by the deadline, non-adaptive {baseline}")
    karp = reach = 0
    for i, (d, r) in enumerate(per_round):
        want = ({"karp": 0, "reach": 0, "timing": 0} if r is None
                else redesign_launches(r, cfg.rewire_steps, len(ctl.gc.silos)))
        got = {k: d[k] for k in want}
        check(got == want, f"linkfail round {i}: launched {got}, the code predicts {want}")
        karp, reach = karp + d["karp"], reach + d["reach"]
    print(f"controller linkfail (card, rewire on): {len(ctl.redesigns)} re-designs, first at round "
          f"{rd.round_idx} -> {rd.overlay.name} tau {rd.predicted_tau_ms:.3f} ms ({rd.n_candidates}"
          f" candidates in {rd.elapsed_s:.4f} s), bottleneck {rd.bottleneck}; slot version "
          f"{slot.version}; {done} rounds by the deadline against {baseline} non-adaptive; karp "
          f"launches {karp}, reach {reach}")
    mcfg = ControllerConfig(seed=0, schedule_family="matcha", matcha_budgets=(0.1, 0.2, 0.3, 0.5),
                            matcha_rounds=80, matcha_seeds=(0, 1))
    ctl, slot, per_round, _, _ = _controller_loop(dev, "matcha", mcfg)
    check(len(ctl.redesigns) >= 1 and ctl.redesigns[0].schedule.is_randomized
          and slot.schedule.is_randomized, "matcha: no re-fit to a randomized schedule")
    timing = 0
    for i, (d, r) in enumerate(per_round):
        want = ({"karp": 0, "reach": 0, "timing": 0} if r is None
                else redesign_launches(r, mcfg.rewire_steps, 11))
        got = {k: d[k] for k in want}
        check(got == want, f"matcha round {i}: launched {got}, the code predicts {want}")
        timing += d["timing"]
    rd = ctl.redesigns[0]
    print(f"controller matcha (card): re-fit at round {rd.round_idx} -> {rd.schedule.name}@"
          f"{rd.schedule.budget:g} tau {rd.predicted_tau_ms:.3f} ms in {rd.elapsed_s:.4f} s; "
          f"timing launches {timing}, karp and reach 0")
    for case, c in (("linkfail", dataclasses.replace(cfg, rewire_restarts=0)),
                    ("matcha", dataclasses.replace(mcfg, rewire_restarts=0))):
        card = [redesign_record(r) for r in _controller_loop(dev, case, c)[0].redesigns]
        cpu = [redesign_record(r) for r in _controller_loop("cpu", case, c)[0].redesigns]
        print(f"controller parity {case} (rewire_restarts=0): {len(card)} re-designs, card == CPU "
              f"{card == cpu}")
        check(card == cpu and card, f"controller {case}: the card's re-designs are not the CPU's")
    return {"wall_s": time.perf_counter() - t0}


TRACED_STEPS = 30  # the traced phase's rounds: Gaia link failure, the detector trips at round 22
TRACE_INTERVAL = 5  # rounds between the traced run's ``round`` records


def check_trace_records(torch, records, problems, n_redesigns: int) -> dict:
    """The traced phase's checks on one flight-recorder trace: valid, the
    card's metadata, a regression and the re-designs blamed on Gaia sites,
    epochs 0 and 1, ``round`` records at their cadence, the span totals and
    the counters.  Returns the records by kind."""
    from repro_torch.core import GAIA_SITES

    names = [name for name, _ in GAIA_SITES]
    check(not problems, f"trace problems: {problems}")
    by_kind = {}
    for rec in records:
        by_kind.setdefault(rec["kind"], []).append(rec)
    meta = records[0]["meta"]
    check(meta["device_kind"] == torch.cuda.get_device_name(0)
          and meta["torch_version"] == torch.__version__ and meta["silo_names"] == names,
          f"run_start metadata {meta}")
    check(len(by_kind.get("regression", [])) >= 1, "the trace holds no regression record")
    rds = by_kind.get("redesign", [])
    check(len(rds) == n_redesigns and all(
        r["bottleneck_names"] and set(r["bottleneck_names"]) <= set(names) for r in rds),
        f"re-design records {rds}")
    epochs = [r["index"] for r in by_kind.get("epoch", [])]
    check(epochs[:2] == [0, 1], f"epoch records {epochs}")
    steps = [r["step"] for r in by_kind.get("round", [])]
    check(steps == list(range(0, TRACED_STEPS, TRACE_INTERVAL)), f"round records at {steps}")
    end = records[-1]
    check(end["kind"] == "run_end", f"last record {end['kind']}")
    span_s = end["spans"]
    check({"controller.redesign", "train.step", "designer.search_jit"} <= set(span_s)
          and span_s["train.step"]["count"] == TRACED_STEPS, f"span totals {sorted(span_s)}")
    h2d = end["metrics"]["train.h2d_bytes"]
    check(h2d == TRACED_STEPS * 11 * 2 * 2 * 4 * 64 * 4, f"train.h2d_bytes {h2d}")
    check(end["summary"]["recompiles"] == 1 + n_redesigns,
          f"recompiles {end['summary']['recompiles']}, re-designs {n_redesigns}")
    return by_kind


def traced_dynamic_phase(torch, dev) -> dict:
    """``train(..., dynamic=True)`` under a Gaia link failure at
    h2o-danube-1.8b's full width (1 of 24 layers, 11 silos, pallas), in
    turns untraced, traced, traced, untraced: every run's losses,
    re-designs, final state and K1/K2 launches must be the first run's
    bits, K2 one a round, K1 as the code predicts; each trace must pass
    :func:`check_trace_records`."""
    import os
    import statistics
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.dynamics import ControllerConfig
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.train import train
    from repro_torch.obs import events

    cfg = get_config("h2o-danube-1.8b", n_layers=1)
    order = (False, True, True, False)
    print(f"traced dynamic train: {cfg.arch_id} layers {cfg.n_layers} (of 24), Gaia linkfail, "
          f"pallas, {TRACED_STEPS} rounds a run, in turns untraced, traced, traced, untraced "
          f"(metrics interval {TRACE_INTERVAL})")
    kw = dict(dynamic=True, underlay="gaia", scenario="linkfail", gossip_impl="pallas",
              designer="auto", local_steps=2, batch_per_silo=4, seq_len=64, steps=TRACED_STEPS,
              device=dev)
    rewire_steps = ControllerConfig().rewire_steps
    first = None
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for k, traced in enumerate(order):
            path = os.path.join(tmp, f"trace{k}.jsonl")
            what = f"run {k} ({'traced' if traced else 'untraced'})"
            lines = []
            reset_launch_counts()
            t0 = time.perf_counter()
            res = train(cfg, trace_out=path if traced else None, metrics_interval=TRACE_INTERVAL,
                        log=lines.append, **kw)
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            for line in lines:
                if "re-design" in line or "summary" in line:
                    print(f"traced dynamic train {what}: {line}")
            rds = res.controller.redesigns
            run = dict(traced=traced, losses=res.losses, round_s=res.step_seconds,
                       launches=launches, redesigns=[redesign_record(rd) for rd in rds],
                       wall_s=wall)
            if first is None:
                first = dict(run, state={key: res.state[key].cpu()
                                         for key in ("params", "opt_state")})
                check(all(map(math.isfinite, run["losses"])) and run["redesigns"],
                      f"{what}: losses {run['losses']}, re-designs {run['redesigns']}")
                check(launches["gossip_mix"] == TRACED_STEPS,
                      f"{what}: gossip_mix launched {launches['gossip_mix']} times in "
                      f"{TRACED_STEPS} rounds")
                want = {key: sum(redesign_launches(rd, rewire_steps, 11)[key] for rd in rds)
                        for key in ("karp", "reach")}
                want["timing"] = 1 + sum(redesign_launches(rd, rewire_steps, 11)["timing"]
                                         for rd in rds)
                got = {key: launches[key] for key in want}
                check(got == want, f"{what} launched K1 {got}, the code predicts {want}")
            else:
                check(run["losses"] == first["losses"], f"{what}: losses differ from run 0's")
                check(run["redesigns"] == first["redesigns"], f"{what}: re-designs differ")
                check(launches == first["launches"],
                      f"{what}: launches {launches} against run 0's {first['launches']}")
                same = {key: torch.equal(res.state[key].cpu(), first["state"][key])
                        for key in ("params", "opt_state")}
                check(all(same.values()), f"{what}: final state differs from run 0's: {same}")
            if traced:
                records, problems = events.validate_trace(path)
                by_kind = check_trace_records(torch, records, problems, len(rds))
                span_s = records[-1]["spans"]
                run.update(trace_bytes=os.path.getsize(path), records=len(records),
                           spans=span_s, step_span_s=span_s["train.step"]["total_s"])
                engine = {name[len("engine."):]: round(v["total_s"], 6)
                          for name, v in span_s.items() if name.startswith("engine.")}
                designers = ", ".join(f"{name} {v['total_s']:.4f}" for name, v in span_s.items()
                                      if name.startswith("designer."))
                kinds = ", ".join(f"{kind} {len(v)}" for kind, v in sorted(by_kind.items()))
                print(f"traced dynamic train {what}: trace {run['trace_bytes']} bytes, "
                      f"{len(records)} records ({kinds}); "
                      f"span totals s: train.step {run['step_span_s']:.4f} over {TRACED_STEPS}, "
                      f"controller.redesign {span_s['controller.redesign']['total_s']:.4f}, "
                      f"controller.calibrate {span_s['controller.calibrate']['total_s']:.4f}, "
                      f"{designers}, engine {engine}; train.step {run['step_span_s']:.4f} s "
                      f"against the round walls' {sum(run['round_s']):.4f} s (share "
                      f"{run['step_span_s'] / sum(run['round_s']):.4f}, gap "
                      f"{sum(run['round_s']) - run['step_span_s']:.4f} s)")
            runs.append(run)
            del res
            gc.collect()
            torch.cuda.empty_cache()

    def walls(xs):
        return f"median {statistics.median(xs):.4f} range {min(xs):.4f}..{max(xs):.4f}"

    print("traced dynamic train: round walls s " + "; ".join(
        f"run {k} ({'traced' if r['traced'] else 'untraced'}) {walls(r['round_s'])}"
        for k, r in enumerate(runs)))
    traced_med = statistics.median(x for r in runs if r["traced"] for x in r["round_s"])
    plain_med = statistics.median(x for r in runs if not r["traced"] for x in r["round_s"])
    print(f"traced dynamic train: median round wall traced {traced_med:.4f} s, untraced "
          f"{plain_med:.4f} s ({traced_med / plain_med - 1:+.4f}); losses, re-designs "
          f"({len(first['redesigns'])}), final state and launches {first['launches']} the same "
          f"bits in all {len(runs)} runs; train() walls s {[round(r['wall_s'], 1) for r in runs]}")
    traced_runs = [r for r in runs if r["traced"]]
    out = {"launches": first["launches"], "traced_median_s": traced_med,
           "plain_median_s": plain_med, "trace_bytes": traced_runs[-1]["trace_bytes"],
           "records": traced_runs[-1]["records"],
           "step_span_s": [r["step_span_s"] for r in traced_runs],
           "round_sum_s": [sum(r["round_s"]) for r in traced_runs]}
    del runs, first
    return out


def flash_zoo_phase(torch, dev) -> dict:
    """K3 at hd 128 with the query groups of the MoE family and the last
    dense configs, against its plain version; then timed at
    qwen3-moe-30b-a3b's prefill shape in turns with its plain version and
    ``scaled_dot_product_attention``, beside its bound."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_ref

    gen = torch.Generator(device=dev).manual_seed(20)
    worst, n_cases = 0.0, 0
    for K, G in K3_ZOO["KG"]:
        for S in K3_ZOO["S"]:
            q = torch.randn((2, S, K, G, 128), generator=gen, device=dev)
            k = torch.randn((2, S, K, 128), generator=gen, device=dev)
            v = torch.randn((2, S, K, 128), generator=gen, device=dev)
            got = flash_attention(q, k, v, causal=True, window=None)
            ref = flash_attention_ref(q, k, v, causal=True, window=None)
            err = float((got - ref).abs().max())
            check(torch.allclose(got, ref, atol=TOL["float32"], rtol=TOL["float32"]),
                  f"flash_attention hd 128 K={K} G={G} S={S}: max abs err {err}")
            worst, n_cases = max(worst, err), n_cases + 1
    print(f"kernel flash_attention: hd 128 x (K, G) {K3_ZOO['KG']} x S {K3_ZOO['S']}, B 2, "
          f"causal, f32 ({n_cases} cases) within tolerance 2e-5 (max abs err {worst:.3g})")

    B, S, K, G, hd = K3_QWEN3
    q = torch.randn((B, S, K, G, hd), generator=gen, device=dev)
    k = torch.randn((B, S, K, hd), generator=gen, device=dev)
    v = torch.randn((B, S, K, hd), generator=gen, device=dev)
    ref = flash_attention_ref(q, k, v, causal=True, window=None)
    got = flash_attention(q, k, v, causal=True, window=None)
    err = float((got - ref).abs().max())
    check(torch.allclose(got, ref, atol=TOL["float32"], rtol=TOL["float32"]),
          f"flash_attention at the qwen3-moe prefill shape: max abs err {err}")
    # Yardstick only, never called by the port: one causal GQA
    # scaled_dot_product_attention over [B, H, S, hd].
    F = torch.nn.functional
    qh = q.reshape(B, S, K * G, hd).transpose(1, 2)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=True)

    sdpa_err = float((sdpa().transpose(1, 2).reshape(q.shape) - ref).abs().max())
    del got, ref
    runs = {"kernel": (lambda: flash_attention(q, k, v, causal=True, window=None), 20),
            "plain": (lambda: flash_attention_ref(q, k, v, causal=True, window=None), 5),
            "sdpa": (sdpa, 10)}
    times = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        fn, reps = runs[name]
        times[name].append(time_ms(torch, fn, reps=reps, warmup=1))
    mean = {name: sum(t) / len(t) for name, t in times.items()}
    bound, by = attn_bound_ms(B, S, S, K, G, hd, None, 4, passes=3, rate=TF32_FLOPS)
    bound_f32, _ = attn_bound_ms(B, S, S, K, G, hd, None, 4)
    pairs = attn_pairs(S, S, True, None) * B * K * G
    print(f"kernel flash_attention B={B} S=T={S} K={K} G={G} hd={hd} causal f32 (qwen3-moe "
          f"prefill), in turns: ms {fmt_times(times['kernel'])}  plain_ms "
          f"{fmt_times(times['plain'])}  library_ms scaled_dot_product_attention "
          f"{fmt_times(times['sdpa'])} (max abs diff to plain {sdpa_err:.3g})  bound_ms "
          f"{bound:.4f} ({by}, 3xTF32 at {TF32_FLOPS / 1e12:.0f} TFLOP/s; {pairs} visible "
          f"pairs)  float32 CUDA-core bound {bound_f32:.4f}  max_abs_err {err:.3g}  achieved "
          f"{4 * hd * pairs / (mean['kernel'] * 1e-3) / 1e12:.2f} TFLOP/s of fp32-accurate "
          f"products ({bound / mean['kernel']:.1%} of the bound)")
    return {"ms": mean["kernel"], "plain_ms": mean["plain"], "library_ms": mean["sdpa"],
            "bound_ms": bound, "bound_by": by, "max_abs_err": max(err, worst)}


@contextlib.contextmanager
def recording(module, name: str, record: list, keep):
    """Replace ``module.name`` by a wrapper that appends ``keep(args,
    result)`` to ``record`` after each call."""
    orig = getattr(module, name)

    def run(*args, **kwargs):
        out = orig(*args, **kwargs)
        record.append(keep(args, out))
        return out

    setattr(module, name, run)
    try:
        yield record
    finally:
        setattr(module, name, orig)


def topk_sets_differ(torch, a, b) -> int:
    """Tokens whose set of chosen experts differs between two dispatches."""
    return int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())


def moe_layer_parts(torch, p, cfg, x, prefill_s: float, n_moe: int) -> dict:
    """One MoE layer's parts on its recorded prefill input, timed by CUDA
    events: the router and the dispatch, the three expert products, and the
    whole layer (the rest: the combine, the aux loss, shared experts); each
    times the MoE layers over ``prefill_s``, a prefill's wall (one that
    recorded the input, after the timed one, so warm)."""
    from repro_torch.models import moe as MOE

    m = cfg.moe
    cap = MOE.capacity(cfg, x.shape[1])
    F = torch.nn.functional

    def dispatch():
        return MOE._dispatch_group(x, (x @ p["router"]).to(torch.float32), m.top_k,
                                   m.n_experts, cap)

    buf = dispatch()[0]

    def experts():
        g = F.silu(torch.einsum("gecd,edf->gecf", buf, p["w_gate"]))
        u = torch.einsum("gecd,edf->gecf", buf, p["w_up"])
        return torch.einsum("gecf,efd->gecd", g * u, p["w_down"])

    t = {"dispatch": time_ms(torch, dispatch, reps=5),
         "experts": time_ms(torch, experts, reps=5),
         "layer": time_ms(torch, lambda: MOE.moe_forward(p, cfg, x), reps=5)}
    t["rest"] = t["layer"] - t["dispatch"] - t["experts"]
    print(f"serve moe layer {cfg.arch_id} [{x.shape[0]}x{x.shape[1]}] buffer "
          f"{tuple(buf.shape)} (cap {cap}): " + ", ".join(
              f"{k} {v:.4f} ms ({n_moe * v * 1e-3 / prefill_s:.3f} of a {prefill_s:.4f} s "
              f"prefill over {n_moe} layers)" for k, v in t.items()))
    return t


def attention_layers_gate(torch, records, cfg, arch: str) -> float:
    """Each recorded attention layer's ``(params, input, positions)``
    through K3 (``cfg``) against the plain path on the same input (<=
    2e-3); the largest difference.
    A function of its own, so that no loop variable holds a view of the
    model's parameters after it returns."""
    from repro_torch.models import attention as A

    plain_cfg = dataclasses.replace(cfg, use_flash_kernel=False)
    worst = 0.0
    with torch.no_grad():
        for p, x, positions in records:
            got = A.attn_forward(p, cfg, x, positions)
            ref = A.attn_forward(p, plain_cfg, x, positions)
            err = float((got - ref).abs().max())
            check(torch.allclose(got, ref, atol=2e-3, rtol=2e-3),
                  f"{arch}: attention layer through K3 vs plain max abs diff {err}")
            worst = max(worst, err)
    return worst


def zoo_serve_phase(torch, dev) -> dict:
    """The MoE family and the last dense configs served at full width
    through ``serve``, each run with the counts set to 0 just before it and
    read just after; the dropless whole-model checks; the reduced configs on
    the card against the CPU."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import serve
    from repro_torch.models import ParamLayout, init_params, model_specs
    from repro_torch.models import attention as A
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_map

    batch, prompt_len, gen = ZOO_RUN
    out = {}
    for arch, layers in ZOO_SERVE:
        cfg = get_config(arch, n_layers=layers, use_flash_kernel=True)
        n_attn = sum(kind in ("attn", "attn_moe") for kind in cfg.block_pattern)
        n_moe = sum(kind.endswith("_moe") for kind in cfg.block_pattern)
        P = ParamLayout(model_specs(cfg)).size
        moe_txt = (f"; {cfg.moe.n_experts} experts top-{cfg.moe.top_k} d_expert "
                   f"{cfg.moe.d_expert} shared {cfg.moe.n_shared}, capacity factor "
                   f"{cfg.moe.capacity_factor}" if cfg.moe else "")
        print(f"serve: {arch} d_model {cfg.d_model} heads {cfg.n_heads} kv_heads "
              f"{cfg.n_kv_heads} head_dim {cfg.head_dim} d_ff {cfg.d_ff} mlp {cfg.mlp_variant} "
              f"vocab {cfg.vocab_size}{moe_txt}; layers {layers} of "
              f"{get_config(arch).n_layers} ({n_attn} through K3, {n_moe} MoE); P {P} "
              f"({P * 4 / 1e9:.2f} GB float32); batch {batch}, prompt {prompt_len}, {gen} "
              f"tokens, flash kernel")
        params = init_params(model_specs(cfg), seed=0, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        routed = []
        with recording(MOE, "_dispatch_group", routed, lambda a, r: r[1][4]):
            res = serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=0, device=dev,
                        params=params, log=lambda line: print(f"serve: {line}", flush=True))
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        fa = res.launches["prefill"]["flash_attention"]
        check(launches["flash_attention"] == fa == n_attn,
              f"{arch}: flash_attention launched {launches['flash_attention']} times, "
              f"expected {n_attn} (one per attn / attn_moe layer)")
        check(res.launches["decode"]["flash_attention"] == 0, f"{arch}: decode launched K3")
        check(bool(torch.isfinite(res.prefill_logits).all() and torch.isfinite(res.logits).all()),
              f"{arch}: non-finite logits")
        dropped = [float(1 - keep.float().mean()) for keep in routed
                   if keep.shape[1] == prompt_len]
        check(len(dropped) == n_moe, f"{arch}: {len(dropped)} MoE prefill dispatches")
        if n_moe:
            print(f"serve: {arch} prefill at capacity factor {cfg.moe.capacity_factor} (cap "
                  f"{MOE.capacity(cfg, prompt_len)}): share of (token, expert) assignments "
                  f"dropped per MoE layer " + " ".join(f"{d:.4f}" for d in dropped))
        del routed

        # dropless: prefill, decode and forward route each token alike
        cfg0 = cfg
        if cfg.moe:
            cfg0 = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
            print(f"serve: {arch} dropless checks at capacity_factor {cfg0.moe.capacity_factor} "
                  f"(cap {MOE.capacity(cfg0, prompt_len)})")
        plain_cfg = dataclasses.replace(cfg0, use_flash_kernel=False)
        gates = {"kernel": [], "plain": [], "forced": []}
        attn_in = []
        res0 = res
        if cfg0 is not cfg:
            with recording(MOE, "_dispatch_group", gates["kernel"], lambda a, r: r[1][0]):
                res0 = serve(cfg0, batch=batch, prompt_len=prompt_len, gen=gen, seed=0,
                             device=dev, params=params, log=lambda line: None)
        with torch.no_grad(), \
                recording(MOE, "_dispatch_group", gates["plain"], lambda a, r: r[1][0]), \
                recording(A, "attn_forward", attn_in, lambda a, r: (a[0], a[2], a[3])):
            plain, _ = T.prefill(params, plain_cfg, res0.prompts, prompt_len + gen,
                                 cache_dtype=torch.float32)
        d_prefill = float((res0.prefill_logits - plain).abs().max())
        check(torch.allclose(res0.prefill_logits, plain, atol=2e-3, rtol=2e-3),
              f"{arch}: kernel prefill vs plain prefill max abs diff {d_prefill}")
        del plain
        # each GQA layer's input to the plain prefill, through K3 and through plain
        layer_err = attention_layers_gate(torch, attn_in, cfg0, arch)
        check(len(attn_in) == n_attn, f"{arch}: {len(attn_in)} attention layers recorded")
        del attn_in
        seq = torch.cat([res0.prompts, res0.ids[:, :-1]], dim=1)
        with torch.no_grad(), recording(MOE, "_dispatch_group", gates["forced"],
                                        lambda a, r: r[1][0]):
            # the teacher-forced forward's last position: prefill of the
            # whole sequence on the plain path, which slices before the head
            forced, _ = T.prefill(params, plain_cfg, seq, seq.shape[1],
                                  cache_dtype=torch.float32)
        d_decode = float((res0.logits - forced).abs().max())
        check(torch.allclose(res0.logits, forced, atol=5e-3, rtol=5e-3),
              f"{arch}: last decode step vs teacher-forced forward max abs diff {d_decode}")
        del forced, seq
        pre_k = [g for g in gates["kernel"] if g.shape[1] == prompt_len]
        dec_k = [g for g in gates["kernel"] if g.shape[1] == 1][-n_moe:] if n_moe else []
        diff_prefill = sum(topk_sets_differ(torch, a, b) for a, b in zip(pre_k, gates["plain"]))
        diff_decode = sum(topk_sets_differ(torch, a, b[:, -1:])
                          for a, b in zip(dec_k, gates["forced"]))
        del gates
        print(f"serve: {arch} {'dropless' if cfg.moe else 'checks'}: kernel vs plain prefill "
              f"logits {d_prefill:.3g} (tol "
              f"2e-3), each K3 attention layer vs plain on its input {layer_err:.3g} (tol 2e-3, "
              f"{n_attn} layers), last decode vs teacher-forced forward {d_decode:.3g} (tol "
              f"5e-3); tokens whose top-k expert set differs: prefill kernel vs plain "
              f"{diff_prefill} of {n_moe * batch * prompt_len}, last decode step vs forward "
              f"{diff_decode} of {n_moe * batch}")
        if res0 is not res:
            del res0
        prof = {}
        if n_moe:
            prof = serve_profile(torch, params, cfg, res.prompts, prompt_len + gen,
                                 res.decode_s / (gen - 1))
            first = []
            with recording(MOE, "moe_forward", first, lambda a, r: (a[0], a[2])), \
                    torch.no_grad():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                T.prefill(params, cfg, res.prompts, prompt_len + gen, cache_dtype=torch.float32)
                torch.cuda.synchronize()
                prof["warm_prefill_s"] = time.perf_counter() - t0
            p, x = first[0]
            with torch.no_grad():
                prof["moe_parts_ms"] = moe_layer_parts(torch, p, cfg, x, prof["warm_prefill_s"],
                                                       n_moe)
            del first, p, x
        print(f"serve: {arch} prefill {res.prefill_s:.4f} s  decode {res.decode_tok_s:.2f} tok/s "
              f"({gen - 1} steps x batch {batch} in {res.decode_s:.4f} s)  peak device memory "
              f"{peak / 2**30:.2f} GiB  P {P}  flash_attention launches prefill {fa} decode "
              f"{res.launches['decode']['flash_attention']}")
        out[arch] = {"prefill_s": res.prefill_s, "decode_tok_s": res.decode_tok_s,
                     "peak_bytes": peak, "launches": fa, "P": P, "dropped": dropped,
                     "d_prefill": d_prefill, "d_decode": d_decode, "layer_err": layer_err,
                     "topk_differ": (diff_prefill, diff_decode), **prof}
        del res, params
        gc.collect()
        torch.cuda.empty_cache()

    # card (kernel) vs CPU (plain version) at the reduced size, same weights
    for arch, _ in ZOO_SERVE:
        cfg = dataclasses.replace(get_config(arch).reduced(), use_flash_kernel=True)
        n_attn = sum(kind in ("attn", "attn_moe") for kind in cfg.block_pattern)
        params = init_params(model_specs(cfg), seed=0, device="cpu")
        prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128))
        runs = [serve(cfg, batch=2, prompt_len=128, gen=4, device=d, prompts=prompts,
                      params=p, log=lambda line: None)
                for d, p in ((dev, tree_map(lambda t: t.to(dev), params)), ("cpu", params))]
        d_pre = float((runs[0].prefill_logits.cpu() - runs[1].prefill_logits).abs().max())
        d_last = float((runs[0].logits.cpu() - runs[1].logits).abs().max())
        same_ids = bool(torch.equal(runs[0].ids.cpu(), runs[1].ids))
        print(f"serve parity: reduced {arch} ({cfg.block_pattern}, d_model {cfg.d_model}) at "
              f"prompt 128, card vs CPU: prefill logits {d_pre:.3g}, last decode logits "
              f"{d_last:.3g} (tolerance 1e-4); ids equal {same_ids}; K3 launches "
              f"{runs[0].launches['prefill']['flash_attention']}")
        check(runs[0].launches["prefill"]["flash_attention"] == n_attn,
              f"reduced {arch} on the card launched K3 "
              f"{runs[0].launches['prefill']['flash_attention']} times, expected {n_attn}")
        check(same_ids and d_pre <= 1e-4 and d_last <= 1e-4,
              f"reduced {arch}: card and CPU serving differ: prefill {d_pre}, last {d_last}")
    return out


@contextlib.contextmanager
def mix_against_plain(torch, record: list, chunk: int = 1 << 28):
    """Each K2 call of a DPASGD round is followed by K2's plain version on
    the same stack, column chunk by chunk: ``record`` gets (bit-identical,
    max abs diff) per call.  Two local-step passes need not agree to the
    bit on the card, so the comparison takes the stack the round built."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.gossip_mix import gossip_mix_ref

    orig = ops.gossip_mix

    def run(blocks, weights, *, out=None):
        res = orig(blocks, weights, out=out)
        w = weights.to(device=blocks.device, dtype=torch.float32)
        same, diff = True, 0.0
        for c in range(0, blocks.shape[1], chunk):
            got, ref = res[c:c + chunk], gossip_mix_ref(blocks[:, c:c + chunk], w)
            same = same and bool(torch.equal(got, ref))  # -0 == +0; no NaN
            diff = max(diff, float((got - ref).abs().max()))
        record.append((same, diff))
        return res

    ops.gossip_mix = run
    try:
        yield record
    finally:
        ops.gossip_mix = orig


def moe_train_phase(torch, dev) -> dict:
    """DPASGD on qwen3-moe-30b-a3b at full width (depth cut) through
    ``train``: one K2 launch a round, losses that carry the router's aux
    loss, the round's profile, and one more round whose K2 mix equals its
    plain version on the same stack bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.fed import make_train_step
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.profile_round import profile_round, report
    from repro_torch.launch.train import batch_to_device, train
    from repro_torch.models import ParamLayout, model_specs
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import softmax_cross_entropy

    arch, layers, silos, steps = MOE_TRAIN
    cfg = get_config(arch, n_layers=layers)
    P = ParamLayout(model_specs(cfg)).size
    print(f"moe train: {arch} d_model {cfg.d_model} {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k} capacity factor {cfg.moe.capacity_factor} vocab {cfg.vocab_size} "
          f"layers {layers} (of {get_config(arch).n_layers}), P {P}; {silos} silos, ring, "
          f"pallas, s 2, 4 x 64 tokens a silo")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = train(cfg, silos=silos, topology="ring", gossip_impl="pallas", local_steps=2,
                batch_per_silo=4, seq_len=64, steps=steps, device=dev,
                log=lambda line: print(f"moe train: {line}", flush=True))
    launches = dict(LAUNCHES)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    for i, (loss, sec) in enumerate(zip(res.losses, res.step_seconds)):
        print(f"moe train: round {i} wall {sec:.4f} s loss {loss:.6f}")
    check(all(math.isfinite(x) for x in res.losses), f"non-finite loss {res.losses}")
    check(launches["gossip_mix"] == steps,
          f"moe train: gossip_mix launched {launches['gossip_mix']} times in {steps} rounds")
    check(res.state["params"].shape == (silos, P), f"state {tuple(res.state['params'].shape)}")
    # silo 0's loss on its next micro-batch: cross entropy plus the aux loss
    micro = {k: v[0, 0] for k, v in batch_to_device(res.batcher.batch(steps), dev).items()}
    tree = ParamLayout(model_specs(cfg)).views(res.state["params"][0])
    with torch.no_grad():
        logits, aux = T.forward(tree, cfg, micro["tokens"], return_aux=True)
        ce = softmax_cross_entropy(logits, micro["labels"])
        loss = T.loss_fn(tree, cfg, micro)
    del logits
    print(f"moe train: silo 0 loss {float(loss):.6f} = cross entropy {float(ce):.6f} + aux "
          f"{float(aux):.6f} (router_aux_weight {cfg.moe.router_aux_weight})")
    check(float(aux) > 0 and abs(float(loss) - float(ce) - float(aux)) <= 1e-5,
          f"moe train: loss {float(loss)} is not cross entropy {float(ce)} + aux {float(aux)}")
    prof = profile_round(res, steps)
    for line in report(prof, top=10):
        print(f"moe train profile: {line}", flush=True)

    # one more round: its mix through K2, then K2's plain version on the same stack
    batch = batch_to_device(res.batcher.batch(steps + 1), dev)
    step = make_train_step(res.cfg, res.fed, res.optimizer, res.plan)
    reset_launch_counts()
    with mix_against_plain(torch, []) as mixes:
        res.state, _ = step(res.state, batch)
    check(LAUNCHES["gossip_mix"] == 1 and len(mixes) == 1,
          f"moe train: the checked round launched gossip_mix {LAUNCHES['gossip_mix']} times")
    same, diff = mixes[0]
    print(f"moe train: one more round, its mix through gossip_mix vs the plain version on the "
          f"same [{len(res.plan.terms)}, {silos * P}] stack: bit-identical {same} (max abs diff "
          f"{diff:.3g}); peak device memory {peak / 2**30:.2f} GiB over the {steps} rounds; "
          f"gossip_mix launches {launches['gossip_mix']} in {steps} rounds")
    check(same, f"moe train: gossip_mix and its plain version differ by {diff}")
    out = {"launches": launches["gossip_mix"], "n_elems": silos * P, "P": P,
           "K": len(res.plan.terms), "peak_bytes": peak, "round_s": res.step_seconds,
           "losses": res.losses, "aux": float(aux), "idle_share": prof["idle_share"]}
    del res, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def flash_hybrid_vlm_phase(torch, dev) -> dict:
    """K3 at hymba-1.5b's prefill shape (G = 5, hd 64, window 1024) and at
    internvl2-76b's (G = 8, hd 128, prefix plus prompt, causal) against its
    plain version, then timed in turns with its plain version and
    ``scaled_dot_product_attention`` (causal GQA; for the window also with
    the window as a boolean mask, the same function), beside its bound."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_ref

    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(21)
    out = {}
    for name, (B, S, K, G, hd, window) in K3_HYBRID_VLM.items():
        q = torch.randn((B, S, K, G, hd), generator=gen, device=dev)
        k = torch.randn((B, S, K, hd), generator=gen, device=dev)
        v = torch.randn((B, S, K, hd), generator=gen, device=dev)
        ref = flash_attention_ref(q, k, v, causal=True, window=window)
        got = flash_attention(q, k, v, causal=True, window=window)
        err = float((got - ref).abs().max())
        check(torch.allclose(got, ref, atol=TOL["float32"], rtol=TOL["float32"]),
              f"flash_attention at the {name} prefill shape: max abs err {err}")
        # Yardsticks only, never called by the port: one GQA
        # scaled_dot_product_attention over [B, H, S, hd].
        qh = q.reshape(B, S, K * G, hd).transpose(1, 2)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
        pos = torch.arange(S, device=dev)

        def sdpa_causal():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=True)

        runs = {"kernel": (lambda: flash_attention(q, k, v, causal=True, window=window), 10),
                "plain": (lambda: flash_attention_ref(q, k, v, causal=True, window=window), 3),
                "sdpa_causal": (sdpa_causal, 5)}
        if window is not None:
            mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)

            def sdpa_window():
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, enable_gqa=True)

            same = sdpa_window().transpose(1, 2).reshape(q.shape)
            same_txt = (f"max abs diff of the masked one to plain "
                        f"{float((same - ref).abs().max()):.3g}")
            del same
            runs["sdpa_window"] = (sdpa_window, 3)
        else:
            same = sdpa_causal().transpose(1, 2).reshape(q.shape)
            same_txt = f"max abs diff to plain {float((same - ref).abs().max()):.3g}"
            del same
        del got, ref
        times = {n: [] for n in runs}
        for n in list(runs) + list(runs)[::-1]:
            fn, reps = runs[n]
            times[n].append(time_ms(torch, fn, reps=reps, warmup=1))
        mean = {n: sum(t) / len(t) for n, t in times.items()}
        bound, by = attn_bound_ms(B, S, S, K, G, hd, window, 4, passes=3, rate=TF32_FLOPS)
        bound_f32, _ = attn_bound_ms(B, S, S, K, G, hd, window, 4)
        pairs = attn_pairs(S, S, True, window) * B * K * G
        library = "sdpa_window" if window is not None else "sdpa_causal"
        print(f"kernel flash_attention B={B} S=T={S} K={K} G={G} hd={hd} window={window} f32 "
              f"({name} prefill), in turns: ms {fmt_times(times['kernel'])}  plain_ms "
              f"{fmt_times(times['plain'])}  scaled_dot_product_attention causal GQA "
              f"{fmt_times(times['sdpa_causal'])}" + (
                  f"  with the window as a boolean mask {fmt_times(times['sdpa_window'])}"
                  if window is not None else "") +
              f" ({same_txt})  bound_ms {bound:.4f} ({by}, 3xTF32 at "
              f"{TF32_FLOPS / 1e12:.0f} TFLOP/s; {pairs} visible pairs)  float32 CUDA-core bound "
              f"{bound_f32:.4f}  max_abs_err {err:.3g}  achieved "
              f"{4 * hd * pairs / (mean['kernel'] * 1e-3) / 1e12:.2f} TFLOP/s of fp32-accurate "
              f"products ({bound / mean['kernel']:.1%} of the bound)")
        out[name] = {"ms": mean["kernel"], "plain_ms": mean["plain"],
                     "library_ms": mean[library], "sdpa_causal_ms": mean["sdpa_causal"],
                     "bound_ms": bound, "bound_by": by, "max_abs_err": err}
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    return out


def flash_whisper_phase(torch, dev) -> dict:
    """K3 at whisper-large-v3's decoder prefill shape (B=4, S=T=384,
    K=20, G=1, hd=64, causal: a block's 128 query rows are 128 positions
    of one head) against its plain version (2e-5), then timed in turns
    with the CUDA-core kernel of the same source, its plain version and a
    causal ``scaled_dot_product_attention`` (the same function), beside its
    bound."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_ref

    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(22)
    B, S, K, G, hd = K3_WHISPER
    q = torch.randn((B, S, K, G, hd), generator=gen, device=dev)
    k = torch.randn((B, S, K, hd), generator=gen, device=dev)
    v = torch.randn((B, S, K, hd), generator=gen, device=dev)
    ref = flash_attention_ref(q, k, v, causal=True, window=None)
    got = flash_attention(q, k, v, causal=True, window=None)
    err = float((got - ref).abs().max())
    check(torch.allclose(got, ref, atol=TOL["float32"], rtol=TOL["float32"]),
          f"flash_attention at the whisper decoder shape: max abs err {err}")
    simt = flash_attention_cuda(q, k, v, causal=True, window=None, simt=True)
    simt_err = float((simt - ref).abs().max())
    check(torch.allclose(simt, ref, atol=TOL["float32"], rtol=TOL["float32"]),
          f"CUDA-core flash_attention at the whisper decoder shape: max abs err {simt_err}")
    # Yardstick only, never called by the port: one causal MHA
    # scaled_dot_product_attention over [B, H, S, hd].
    qh = q.reshape(B, S, K * G, hd).transpose(1, 2)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    sdpa_err = float((sdpa().transpose(1, 2).reshape(q.shape) - ref).abs().max())
    del got, simt, ref
    runs = {"kernel": (lambda: flash_attention(q, k, v, causal=True, window=None), 50),
            "simt": (lambda: flash_attention_cuda(q, k, v, causal=True, window=None,
                                                  simt=True), 50),
            "plain": (lambda: flash_attention_ref(q, k, v, causal=True, window=None), 10),
            "sdpa": (sdpa, 50)}
    times = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        fn, reps = runs[name]
        times[name].append(time_ms(torch, fn, reps=reps, warmup=2))
    mean = {name: sum(t) / len(t) for name, t in times.items()}
    bound, by = attn_bound_ms(B, S, S, K, G, hd, None, 4, passes=3, rate=TF32_FLOPS)
    bound_f32, _ = attn_bound_ms(B, S, S, K, G, hd, None, 4)
    pairs = attn_pairs(S, S, True, None) * B * K * G
    print(f"kernel flash_attention B={B} S=T={S} K={K} G={G} hd={hd} causal f32 (whisper "
          f"decoder prefill), in turns: ms {fmt_times(times['kernel'])}  cuda-core entry ms "
          f"{fmt_times(times['simt'])}  plain_ms {fmt_times(times['plain'])}  library_ms "
          f"scaled_dot_product_attention {fmt_times(times['sdpa'])} (max abs diff to plain "
          f"{sdpa_err:.3g})  bound_ms {bound:.6f} ({by}, 3xTF32 at {TF32_FLOPS / 1e12:.0f} "
          f"TFLOP/s; {pairs} visible pairs)  float32 CUDA-core bound {bound_f32:.6f}  "
          f"max_abs_err {err:.3g} (cuda-core {simt_err:.3g})  achieved "
          f"{4 * hd * pairs / (mean['kernel'] * 1e-3) / 1e12:.2f} TFLOP/s of fp32-accurate "
          f"products ({bound / mean['kernel']:.1%} of the bound)")
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    return {"ms": mean["kernel"], "simt_ms": mean["simt"], "plain_ms": mean["plain"],
            "library_ms": mean["sdpa"], "bound_ms": bound, "bound_by": by,
            "bound_f32_ms": bound_f32, "max_abs_err": err}


@contextlib.contextmanager
def event_timed(torch, module, name: str, spent: list):
    """Replace ``module.name`` by a wrapper that records a CUDA event
    before and after each call; ``spent`` gets the (start, end) pairs."""
    orig = getattr(module, name)

    def run(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = orig(*args, **kwargs)
        end.record()
        spent.append((start, end))
        return res

    setattr(module, name, run)
    try:
        yield spent
    finally:
        setattr(module, name, orig)


def hybrid_layers_gate(torch, cfg, attn_in, mamba_in, arch: str) -> tuple:
    """Each recorded attention input through K3 (``cfg``) against the
    plain path, and each recorded Mamba head input through the chunked
    scan against the per-token loop (output and final state), <= 2e-3;
    the largest differences.  A function of its own, so that no loop
    variable holds a view of the model's parameters after it returns."""
    from repro_torch.models import attention as A
    from repro_torch.models import hybrid as HY
    from repro_torch.models import ssm as SSM

    plain_cfg = dataclasses.replace(cfg, use_flash_kernel=False)
    attn_err = scan_err = 0.0
    with torch.no_grad():
        for p, x, positions, window in attn_in:
            got = A.attn_forward(p, cfg, x, positions, window=window)
            ref = A.attn_forward(p, plain_cfg, x, positions, window=window)
            err = float((got - ref).abs().max())
            check(torch.allclose(got, ref, atol=2e-3, rtol=2e-3),
                  f"{arch}: attention layer (window {window}) through K3 vs plain max abs "
                  f"diff {err}")
            attn_err = max(attn_err, err)
        di = HY.hymba_d_inner(cfg)
        for layer, (p, x) in enumerate(mamba_in):
            u, z, C, dA, dBu = SSM._mamba_scan_inputs(p, x, di, cfg.ssm.d_state)
            y, h = SSM.mamba_scan_chunked(dA, dBu, C)
            y_ref, h_ref = SSM.mamba_scan_loop(dA, dBu, C)
            del dA, dBu
            out = SSM._mamba_out(p, x.dtype, y, u, z)
            out_ref = SSM._mamba_out(p, x.dtype, y_ref, u, z)
            errs = [float((a - b).abs().max()) for a, b in ((y, y_ref), (h, h_ref),
                                                            (out, out_ref))]
            check(all(torch.allclose(a, b, atol=2e-3, rtol=2e-3)
                      for a, b in ((y, y_ref), (h, h_ref), (out, out_ref))),
                  f"{arch}: Mamba layer {layer} chunked scan vs loop max abs diff (y, h, out) "
                  f"{errs}")
            scan_err = max(scan_err, *errs)
    return attn_err, scan_err


def hybrid_vlm_serve_phase(torch, dev) -> dict:
    """hymba-1.5b (16 of 32 layers) and internvl2-76b (4 of 80 layers) served
    at full width through ``serve``, each run with the counts set to 0
    just before it and read just after; the whole-model checks, every
    attention layer through K3 against plain and every Mamba layer's
    chunked scan against its loop on the layer's recorded input; the
    scan's share of a warm prefill by CUDA events and a profile; then the
    reduced configs on the card against the CPU."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import serve
    from repro_torch.models import ParamLayout, init_params, model_specs
    from repro_torch.models import attention as A
    from repro_torch.models import hybrid as HY
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_map

    out = {}
    for arch, layers, batch, prompt_len, gen in HYBRID_VLM_SERVE:
        cfg = get_config(arch, n_layers=layers, use_flash_kernel=True)
        prefix = cfg.vision_prefix_len
        n_attn = sum(kind in ("attn", "attn_moe", "hymba") for kind in cfg.block_pattern)
        n_mamba = cfg.block_pattern.count("hymba")
        P = ParamLayout(model_specs(cfg)).size
        print(f"serve: {arch} d_model {cfg.d_model} heads {cfg.n_heads} kv_heads "
              f"{cfg.n_kv_heads} head_dim {cfg.head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size} "
              f"window {cfg.sliding_window} (global every {cfg.global_attn_every}) vision prefix "
              f"{prefix}; layers {layers} of {get_config(arch).n_layers} ({n_attn} through K3, "
              f"{n_mamba} Mamba heads of width {HY.hymba_d_inner(cfg) if n_mamba else 0}); P {P} "
              f"({P * 4 / 1e9:.2f} GB float32); batch {batch}, {prefix} patches + prompt "
              f"{prompt_len}, {gen} tokens, flash kernel")
        params = init_params(model_specs(cfg), seed=0, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        res = serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=0, device=dev,
                    params=params, log=lambda line: print(f"serve: {line}", flush=True))
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        fa = res.launches["prefill"]["flash_attention"]
        check(launches["flash_attention"] == fa == n_attn,
              f"{arch}: flash_attention launched {launches['flash_attention']} times, "
              f"expected {n_attn} (one per attention layer)")
        check(res.launches["decode"]["flash_attention"] == 0, f"{arch}: decode launched K3")
        check(bool(torch.isfinite(res.prefill_logits).all() and torch.isfinite(res.logits).all()),
              f"{arch}: non-finite logits")
        embeds = res.vision_embeds
        max_len = prefix + prompt_len + gen

        # the plain prefill, recording each attention layer's and Mamba head's input
        plain_cfg = dataclasses.replace(cfg, use_flash_kernel=False)
        attn_in, mamba_in = [], []
        orig_attn, orig_mamba = A.attn_forward, HY.mamba_forward

        def attn_rec(p, c, x, positions, **kw):
            attn_in.append((p, x, positions, kw.get("window")))
            return orig_attn(p, c, x, positions, **kw)

        def mamba_rec(p, c, x, di, **kw):
            mamba_in.append((p, x))
            return orig_mamba(p, c, x, di, **kw)

        # the dense blocks call A.attn_forward, the hybrid block its own import
        A.attn_forward = HY.attn_forward = attn_rec
        HY.mamba_forward = mamba_rec
        try:
            with torch.no_grad():
                plain, _ = T.prefill(params, plain_cfg, res.prompts, max_len,
                                     cache_dtype=torch.float32, vision_embeds=embeds)
        finally:
            A.attn_forward = HY.attn_forward = orig_attn
            HY.mamba_forward = orig_mamba
        d_prefill = float((res.prefill_logits - plain).abs().max())
        check(torch.allclose(res.prefill_logits, plain, atol=2e-3, rtol=2e-3),
              f"{arch}: kernel prefill vs plain prefill max abs diff {d_prefill}")
        del plain
        check(len(attn_in) == n_attn and len(mamba_in) == n_mamba,
              f"{arch}: recorded {len(attn_in)} attention and {len(mamba_in)} Mamba inputs")
        t0 = time.perf_counter()
        attn_err, scan_err = hybrid_layers_gate(torch, cfg, attn_in, mamba_in, arch)
        gate_s = time.perf_counter() - t0
        del attn_in, mamba_in
        seq = torch.cat([res.prompts, res.ids[:, :-1]], dim=1)
        with torch.no_grad():
            # the teacher-forced forward's last position: prefill of the
            # whole sequence on the plain path, which slices before the head
            forced, _ = T.prefill(params, plain_cfg, seq, prefix + seq.shape[1],
                                  cache_dtype=torch.float32, vision_embeds=embeds)
        d_decode = float((res.logits - forced).abs().max())
        check(torch.allclose(res.logits, forced, atol=5e-3, rtol=5e-3),
              f"{arch}: last decode step vs teacher-forced forward max abs diff {d_decode}")
        del forced, seq
        print(f"serve: {arch} checks: kernel vs plain prefill logits {d_prefill:.3g} (tol 2e-3), "
              f"each K3 attention layer vs plain on its input {attn_err:.3g} (tol 2e-3, {n_attn} "
              f"layers), each Mamba layer's chunked scan vs the per-token loop on its input "
              f"(y, final state, head output) {scan_err:.3g} (tol 2e-3, {n_mamba} layers; "
              f"the gate took {gate_s:.1f} s), last decode vs teacher-forced forward "
              f"{d_decode:.3g} (tol 5e-3)")

        # a warm prefill with the scan and the Mamba heads timed by CUDA events
        prof = {}
        if n_mamba:
            scans, heads = [], []
            with torch.no_grad(), event_timed(torch, SSM, "mamba_scan_chunked", scans), \
                    event_timed(torch, HY, "mamba_forward", heads):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                T.prefill(params, cfg, res.prompts, max_len, cache_dtype=torch.float32)
                torch.cuda.synchronize()
                warm = time.perf_counter() - t0
            scan_s = sum(a.elapsed_time(b) for a, b in scans) / 1e3
            head_s = sum(a.elapsed_time(b) for a, b in heads) / 1e3
            Di, N = HY.hymba_d_inner(cfg), cfg.ssm.d_state
            elems = batch * prompt_len * Di * N
            C = SSM.mamba_chunk_len(prompt_len)
            print(f"serve: {arch} Mamba scan (chunk {C}: {C} + {-(-prompt_len // C)} steps a "
                  f"layer) {scan_s:.4f} s over "
                  f"{len(scans)} layers ({scan_s / len(scans) * 1e3:.3f} ms a layer), the whole "
                  f"Mamba heads {head_s:.4f} s, of a warm {warm:.4f} s prefill: scan share "
                  f"{scan_s / warm:.3f}, head share {head_s / warm:.3f} (CUDA events around each "
                  f"call); dA and dBu {elems * 4 / 1e9:.3f} GB each a layer; peak of the warm "
                  f"prefill {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            prof.update(scan_s=scan_s, head_s=head_s, warm_prefill_s=warm,
                        scan_share=scan_s / warm, head_share=head_s / warm)
        prof.update(serve_profile(torch, params, cfg, res.prompts, max_len,
                                  res.decode_s / (gen - 1), vision_embeds=embeds))
        print(f"serve: {arch} prefill {res.prefill_s:.4f} s  decode {res.decode_tok_s:.2f} tok/s "
              f"({gen - 1} steps x batch {batch} in {res.decode_s:.4f} s)  peak device memory "
              f"{peak / 2**30:.2f} GiB  P {P}  flash_attention launches prefill {fa} decode "
              f"{res.launches['decode']['flash_attention']}")
        out[arch] = {"prefill_s": res.prefill_s, "decode_tok_s": res.decode_tok_s,
                     "peak_bytes": peak, "launches": fa, "P": P, "d_prefill": d_prefill,
                     "d_decode": d_decode, "attn_err": attn_err, "scan_err": scan_err, **prof}
        del res, params, embeds
        gc.collect()
        torch.cuda.empty_cache()

    # card (kernel) vs CPU (plain version) at the reduced size, same weights
    for arch, *_ in HYBRID_VLM_SERVE:
        cfg = dataclasses.replace(get_config(arch).reduced(), use_flash_kernel=True)
        prefix = cfg.vision_prefix_len
        params = init_params(model_specs(cfg), seed=0, device="cpu")
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size, (2, 128 - prefix))
        embeds = rng.standard_normal((2, prefix, 1024)).astype(np.float32) if prefix else None
        runs = [serve(cfg, batch=2, prompt_len=128 - prefix, gen=4, device=d, prompts=prompts,
                      vision_embeds=embeds, params=p, log=lambda line: None)
                for d, p in ((dev, tree_map(lambda t: t.to(dev), params)), ("cpu", params))]
        d_pre = float((runs[0].prefill_logits.cpu() - runs[1].prefill_logits).abs().max())
        d_last = float((runs[0].logits.cpu() - runs[1].logits).abs().max())
        same_ids = bool(torch.equal(runs[0].ids.cpu(), runs[1].ids))
        print(f"serve parity: reduced {arch} ({cfg.block_pattern}, d_model {cfg.d_model}) at "
              f"{prefix} patches + {128 - prefix} tokens, card vs CPU: prefill logits "
              f"{d_pre:.3g}, last decode logits {d_last:.3g} (tolerance 1e-4); ids equal "
              f"{same_ids}; K3 launches {runs[0].launches['prefill']['flash_attention']}")
        check(runs[0].launches["prefill"]["flash_attention"] == cfg.n_layers,
              f"reduced {arch} on the card launched K3 "
              f"{runs[0].launches['prefill']['flash_attention']} times")
        check(same_ids and d_pre <= 1e-4 and d_last <= 1e-4,
              f"reduced {arch}: card and CPU serving differ: prefill {d_pre}, last {d_last}")
    return out


def hymba_train_phase(torch, dev) -> dict:
    """DPASGD on hymba-1.5b (16 of 32 layers) through ``train``: one K2 launch a
    round, finite losses, the peak against the prediction, the round's
    profile, and one more round whose K2 mix equals its plain version on
    the same stack bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.fed import make_train_step
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.profile_round import profile_round, report
    from repro_torch.launch.train import batch_to_device, train
    from repro_torch.models import ParamLayout, model_specs

    arch, layers, silos, steps = HYMBA_TRAIN
    cfg = get_config(arch, n_layers=layers)
    P = ParamLayout(model_specs(cfg)).size
    print(f"hymba train: {arch} d_model {cfg.d_model} layers {layers} (of "
          f"{get_config(arch).n_layers}), P {P}; {silos} silos, ring, pallas, s 2, 4 x 64 tokens "
          f"a silo; (K + 2) n P 4 bytes = {4 * silos * P * 4 / 1e9:.2f} GB predicted at K = 2")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = train(cfg, silos=silos, topology="ring", gossip_impl="pallas", local_steps=2,
                batch_per_silo=4, seq_len=64, steps=steps, device=dev,
                log=lambda line: print(f"hymba train: {line}", flush=True))
    launches = dict(LAUNCHES)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    for i, (loss, sec) in enumerate(zip(res.losses, res.step_seconds)):
        print(f"hymba train: round {i} wall {sec:.4f} s loss {loss:.6f}")
    check(all(math.isfinite(x) for x in res.losses), f"non-finite loss {res.losses}")
    check(launches["gossip_mix"] == steps,
          f"hymba train: gossip_mix launched {launches['gossip_mix']} times in {steps} rounds")
    check(res.state["params"].shape == (silos, P), f"state {tuple(res.state['params'].shape)}")
    check(peak < 70 * 2**30, f"hymba train: peak {peak / 2**30:.2f} GiB")
    prof = profile_round(res, steps)
    for line in report(prof, top=10):
        print(f"hymba train profile: {line}", flush=True)

    # one more round: its mix through K2, then K2's plain version on the same stack
    batch = batch_to_device(res.batcher.batch(steps + 1), dev)
    step = make_train_step(res.cfg, res.fed, res.optimizer, res.plan)
    reset_launch_counts()
    with mix_against_plain(torch, []) as mixes:
        res.state, _ = step(res.state, batch)
    check(LAUNCHES["gossip_mix"] == 1 and len(mixes) == 1,
          f"hymba train: the checked round launched gossip_mix {LAUNCHES['gossip_mix']} times")
    same, diff = mixes[0]
    print(f"hymba train: one more round, its mix through gossip_mix vs the plain version on the "
          f"same [{len(res.plan.terms)}, {silos * P}] stack: bit-identical {same} (max abs diff "
          f"{diff:.3g}); peak device memory {peak / 2**30:.2f} GiB over the {steps} rounds; "
          f"gossip_mix launches {launches['gossip_mix']} in {steps} rounds")
    check(same, f"hymba train: gossip_mix and its plain version differ by {diff}")
    out = {"launches": launches["gossip_mix"], "n_elems": silos * P, "P": P,
           "K": len(res.plan.terms), "peak_bytes": peak, "round_s": res.step_seconds,
           "losses": res.losses, "idle_share": prof["idle_share"]}
    del res, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def whisper_serve_phase(torch, dev) -> dict:
    """whisper-large-v3 at full width and depth (32 decoder + 32 encoder
    layers) served through ``serve`` with ``use_flash_kernel``: 1500 seeded
    frames, batch 4, a 384-token prompt, 64 tokens, with the counts set to
    0 just before it and read just after: one K3 launch a decoder layer in
    prefill (the encoder and cross-attention are bidirectional and stay on
    the chunked path), none in decode and no other kernel; every decoder
    layer's self-attention through K3 against its plain path on the
    layer's recorded input (<= 2e-3), the prefill against the plain
    prefill (<= 2e-3) and the last decode step against a teacher-forced
    forward over the whole sequence (<= 5e-3); the encoder's, the
    cross-attention's and K3's shares of a warm prefill by CUDA events, a
    profile of prefill and decode; then the reduced whisper on the card
    against the CPU (<= 1e-4, ids equal)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, ops, reset_launch_counts
    from repro_torch.launch.serve import serve
    from repro_torch.models import ParamLayout, init_params, model_specs
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_map

    arch = "whisper-large-v3"
    batch, prompt_len, gen = WHISPER_SERVE
    cfg = get_config(arch, use_flash_kernel=True)
    frames_n = cfg.encoder.seq_len
    max_len = prompt_len + gen
    P = ParamLayout(model_specs(cfg)).size
    print(f"serve: {arch} d_model {cfg.d_model} heads {cfg.n_heads} kv_heads {cfg.n_kv_heads} "
          f"head_dim {cfg.head_dim} d_ff {cfg.d_ff} ({cfg.mlp_variant}) vocab {cfg.vocab_size}; "
          f"{cfg.n_layers} decoder + {cfg.encoder.n_layers} encoder layers (no cut); P {P} "
          f"({P * 4 / 1e9:.2f} GB float32); batch {batch}, {frames_n} frames, prompt "
          f"{prompt_len}, {gen} tokens (max_len {max_len}), flash kernel")
    params = init_params(model_specs(cfg), seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=0, device=dev,
                params=params, log=lambda line: print(f"serve: {line}", flush=True))
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    fa = res.launches["prefill"]["flash_attention"]
    check(launches["flash_attention"] == fa == cfg.n_layers,
          f"{arch}: flash_attention launched {launches['flash_attention']} times, expected "
          f"{cfg.n_layers} (one per decoder layer)")
    check(res.launches["decode"]["flash_attention"] == 0, f"{arch}: decode launched K3")
    others = {k: n for k, n in launches.items() if k != "flash_attention" and n}
    check(not others, f"{arch}: serving launched other kernels {others}")
    check(bool(torch.isfinite(res.prefill_logits).all() and torch.isfinite(res.logits).all()),
          f"{arch}: non-finite logits")
    check(tuple(res.enc_frames.shape) == (batch, frames_n, 128), f"{arch}: frames "
          f"{tuple(res.enc_frames.shape)}")
    frames = res.enc_frames

    # the plain prefill, recording each attention call's (params, input,
    # positions): the encoder's layers come first, then the decoder's
    plain_cfg = dataclasses.replace(cfg, use_flash_kernel=False)
    records = []
    with recording(A, "attn_forward", records, lambda args, out: (args[0], args[2], args[3])), \
            torch.no_grad():
        plain, _ = T.prefill(params, plain_cfg, res.prompts, max_len,
                             cache_dtype=torch.float32, enc_frames=frames)
    n_enc = cfg.encoder.n_layers
    check(len(records) == n_enc + cfg.n_layers,
          f"{arch}: recorded {len(records)} attention inputs, expected {n_enc + cfg.n_layers}")
    dec_in = records[n_enc:]
    del records
    d_prefill = float((res.prefill_logits - plain).abs().max())
    check(torch.allclose(res.prefill_logits, plain, atol=2e-3, rtol=2e-3),
          f"{arch}: kernel prefill vs plain prefill max abs diff {d_prefill}")
    del plain
    attn_err = attention_layers_gate(torch, dec_in, cfg, arch)
    del dec_in
    seq = torch.cat([res.prompts, res.ids[:, :-1]], dim=1)
    with torch.no_grad():  # the chunked path: 447 tokens are not a multiple of 128
        full = T.forward(params, dataclasses.replace(plain_cfg, remat=False), seq,
                         enc_frames=frames)[:, -1]
    d_decode = float((res.logits - full).abs().max())
    check(torch.allclose(res.logits, full, atol=5e-3, rtol=5e-3),
          f"{arch}: last decode step vs teacher-forced forward max abs diff {d_decode}")
    del full, seq
    print(f"serve: {arch} checks: kernel vs plain prefill logits {d_prefill:.3g} (tol 2e-3), "
          f"each decoder layer's self-attention through K3 vs plain on its input "
          f"{attn_err:.3g} (tol 2e-3, {cfg.n_layers} layers), last decode vs teacher-forced "
          f"forward over {prompt_len + gen - 1} tokens {d_decode:.3g} (tol 5e-3)")

    # a warm prefill, the encoder, the cross-attention and K3 timed by CUDA events
    enc_t, xattn_t, k3_t = [], [], []
    with torch.no_grad(), event_timed(torch, T, "encode", enc_t), \
            event_timed(torch, A, "cross_attn_forward", xattn_t), \
            event_timed(torch, ops, "flash_attention", k3_t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.prefill(params, cfg, res.prompts, max_len, cache_dtype=torch.float32,
                  enc_frames=frames)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
    shares = {name: sum(a.elapsed_time(b) for a, b in spent) / 1e3
              for name, spent in (("encoder", enc_t), ("cross_attention", xattn_t),
                                  ("k3", k3_t))}
    check(len(enc_t) == 1 and len(xattn_t) == len(k3_t) == cfg.n_layers,
          f"{arch}: timed {len(enc_t)} encodes, {len(xattn_t)} cross-attentions, "
          f"{len(k3_t)} K3 calls")
    print(f"serve: {arch} warm prefill {warm:.4f} s: " + ", ".join(
        f"{name.replace('_', '-').replace('k3', 'K3')} {t:.4f} s (share {t / warm:.3f})"
        for name, t in shares.items()) + " (CUDA events around each call)")
    prof = serve_profile(torch, params, cfg, res.prompts, max_len, res.decode_s / (gen - 1),
                         enc_frames=frames)
    print(f"serve: {arch} prefill {res.prefill_s:.4f} s  decode {res.decode_tok_s:.2f} tok/s "
          f"({gen - 1} steps x batch {batch} in {res.decode_s:.4f} s)  peak device memory "
          f"{peak / 2**30:.2f} GiB  P {P}  flash_attention launches prefill {fa} decode "
          f"{res.launches['decode']['flash_attention']}")
    out = {"prefill_s": res.prefill_s, "decode_tok_s": res.decode_tok_s, "peak_bytes": peak,
           "launches": fa, "P": P, "d_prefill": d_prefill, "d_decode": d_decode,
           "attn_err": attn_err, "warm_prefill_s": warm,
           **{f"{k}_s": v for k, v in shares.items()}, **prof}
    del res, params, frames
    gc.collect()
    torch.cuda.empty_cache()

    # card (kernel) vs CPU (plain version) at the reduced size, same weights
    cfg = dataclasses.replace(get_config(arch).reduced(), use_flash_kernel=True)
    params = init_params(model_specs(cfg), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 128))
    frames = rng.standard_normal((2, cfg.encoder.seq_len, 128)).astype(np.float32)
    runs = [serve(cfg, batch=2, prompt_len=128, gen=4, device=d, prompts=prompts,
                  enc_frames=frames, params=p, log=lambda line: None)
            for d, p in ((dev, tree_map(lambda t: t.to(dev), params)), ("cpu", params))]
    d_pre = float((runs[0].prefill_logits.cpu() - runs[1].prefill_logits).abs().max())
    d_last = float((runs[0].logits.cpu() - runs[1].logits).abs().max())
    same_ids = bool(torch.equal(runs[0].ids.cpu(), runs[1].ids))
    print(f"serve parity: reduced {arch} ({cfg.n_layers} + {cfg.encoder.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.encoder.seq_len} frames) at prompt 128, card vs CPU: "
          f"prefill logits {d_pre:.3g}, last decode logits {d_last:.3g} (tolerance 1e-4); ids "
          f"equal {same_ids}; K3 launches {runs[0].launches['prefill']['flash_attention']}")
    check(runs[0].launches["prefill"]["flash_attention"] == cfg.n_layers,
          f"reduced {arch} on the card launched K3 "
          f"{runs[0].launches['prefill']['flash_attention']} times")
    check(same_ids and d_pre <= 1e-4 and d_last <= 1e-4,
          f"reduced {arch}: card and CPU serving differ: prefill {d_pre}, last {d_last}")
    return out


def adamw_card_phase(torch, dev) -> dict:
    """One ``adamw`` update on a 2^26-element row on the card against the
    same update on the CPU from the same inputs (the difference in units of
    the ulp of each output's largest magnitude), then timed beside the
    bytes bound of its 7 float32 streams (read g, mu, nu, p; write mu, nu,
    p)."""
    from repro_torch.optim import adamw

    n, step = 1 << 26, 5
    gen = torch.Generator().manual_seed(28)
    p = torch.randn(n, generator=gen)
    g = torch.randn(n, generator=gen)
    mu = torch.randn(n, generator=gen) * 1e-2
    nu = (torch.randn(n, generator=gen) * 1e-2).square()
    opt = adamw(1e-4)
    host = {"mu": mu.clone(), "nu": nu.clone()}
    hp = p.clone()
    opt.update(g, host, hp, step)
    card = {"mu": mu.to(dev), "nu": nu.to(dev)}
    cp, cg = p.to(dev), g.to(dev)
    opt.update(cg, card, cp, step)
    ulps = {}
    for name, got, want in (("p", cp, hp), ("mu", card["mu"], host["mu"]),
                            ("nu", card["nu"], host["nu"])):
        top = float(want.abs().max())
        ulp = math.ldexp(1.0, math.frexp(top)[1] - 24)  # spacing of float32 at |top|
        ulps[name] = float((got.cpu() - want).abs().max()) / ulp
    ms = time_ms(torch, lambda: opt.update(cg, card, cp, step), reps=20, warmup=2)
    bound = 7 * n * 4 / HBM_BYTES_PER_S * 1e3
    print(f"zoo train: adamw update of a 2^26 row on the card vs the CPU from the same inputs: "
          f"max difference in ulps of each output's largest magnitude p {ulps['p']:.3g}, mu "
          f"{ulps['mu']:.3g}, nu {ulps['nu']:.3g} (limit 1); {ms:.4f} ms a call against the "
          f"bound {bound:.4f} ms (bytes: 7 float32 streams; {bound / ms:.1%})")
    check(max(ulps.values()) <= 1.0, f"adamw: card and CPU differ by {ulps} ulps")
    return {"ulps": ulps, "ms": ms, "bound_ms": bound}


def zoo_train_phase(torch, dev) -> dict:
    """The zoo's training side through ``build_train_step``: internlm2-1.8b
    at full width (depth cut), 4 silos on a ring, ``gossip_impl="pallas"``,
    AdamW at 1e-4, ``flash_vjp``, 1 x 4096 tokens a silo, 3 rounds (the
    reference's AdamW configuration, launch/perf_gossip.py, cut to one
    card): finite losses, one K2 launch a round and no K3 or K4 launch, the
    round's peak and profile, one more round whose K2 mix equals its plain
    version on the same stack bit for bit; ``flash_attention_vjp`` at the
    layer's shape against autograd through the chunked path; one silo's
    local step with ``flash_vjp`` on and off; the optimizer on the card."""
    from repro_torch.configs import get_config
    from repro_torch.data import FederatedBatcher, SyntheticLMStream
    from repro_torch.fed import init_state
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.profile_round import kernel_part
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import ParamLayout, model_specs
    from repro_torch.models.attention import chunked_attention, flash_attention_vjp
    from repro_torch.optim import adamw

    arch, layers, silos, seq, rounds = ZOO_TRAIN
    cfg = get_config(arch, n_layers=layers, n_silos=silos, flash_vjp=True)
    P = ParamLayout(model_specs(cfg)).size
    print(f"zoo train: {arch} d_model {cfg.d_model} GQA {cfg.n_heads}/{cfg.n_kv_heads} hd "
          f"{cfg.head_dim} vocab {cfg.vocab_size} layers {layers} (of "
          f"{get_config(arch).n_layers}), P {P}; {silos} silos, ring, pallas, s 1, adamw(1e-4), "
          f"flash_vjp, 1 x {seq} tokens a silo; (K + 3) n P 4 bytes = "
          f"{5 * silos * P * 4 / 1e9:.2f} GB at K = 2")
    opt = adamw(1e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg, opt, seed=0, device=dev)
    step = build_train_step(cfg, optimizer=opt, gossip_impl="pallas")
    batcher = FederatedBatcher(SyntheticLMStream(cfg.vocab_size, seq, n_silos=silos), 1, 1)
    losses, walls = [], []
    reset_launch_counts()
    for r in range(rounds):
        batch = batch_to_device(batcher.batch(r), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        print(f"zoo train: round {r} wall {walls[-1]:.4f} s loss {losses[-1]:.6f}", flush=True)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"zoo train: non-finite loss {losses}")
    check(launches["gossip_mix"] == rounds and launches["flash_attention"] == 0
          and launches["mlstm_scan"] == 0,
          f"zoo train: launches {launches} in {rounds} rounds")
    check(state["step"] == rounds and set(state["opt_state"]) == {"mu", "nu"},
          f"zoo train: step {state['step']}, slots {list(state['opt_state'])}")

    # the round's profile (one more round, traced)
    batch = batch_to_device(batcher.batch(rounds), dev)
    holder = {}
    wall, kernels = device_kernels(torch, lambda: holder.update(out=step(state, batch)),
                                   lead_in=True)
    state = holder.pop("out")[0]
    busy = sum(us for _, us in kernels.values()) / 1e6
    idle = 1.0 - busy / wall if kernels else None
    parts = {}
    for name, (_, us) in kernels.items():
        parts[kernel_part(name)] = parts.get(kernel_part(name), 0.0) + us / 1e6
    print(f"zoo train profile: round wall {wall:.4f} s (traced), device busy {busy:.4f} s over "
          f"{sum(c for c, _ in kernels.values())} kernels, idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'}; " + ", ".join(
              f"{k} {v:.4f} s" for k, v in sorted(parts.items(), key=lambda kv: -kv[1])))

    # one more round: its mix through K2, then K2's plain version on the same stack
    batch = batch_to_device(batcher.batch(rounds + 1), dev)
    reset_launch_counts()
    with mix_against_plain(torch, []) as mixes:
        state, _ = step(state, batch)
    check(LAUNCHES["gossip_mix"] == 1 and len(mixes) == 1,
          f"zoo train: the checked round launched gossip_mix {LAUNCHES['gossip_mix']} times")
    same, diff = mixes[0]
    print(f"zoo train: one more round, its mix through gossip_mix vs the plain version on the "
          f"same [2, {silos * P}] stack: bit-identical {same} (max abs diff {diff:.3g}); peak "
          f"device memory {peak / 2**30:.2f} GiB over the {rounds} rounds; gossip_mix launches "
          f"{launches['gossip_mix']}, flash_attention {launches['flash_attention']}, mlstm_scan "
          f"{launches['mlstm_scan']} in {rounds} rounds")
    check(same, f"zoo train: gossip_mix and its plain version differ by {diff}")
    row = {"params": state["params"][0].clone(),
           "opt_state": {k: v[0].clone() for k, v in state["opt_state"].items()},
           "step": state["step"]}
    del state, batch, holder
    gc.collect()
    torch.cuda.empty_cache()

    # flash_attention_vjp at the layer's shape against autograd through the chunked path
    B, S, K, G, hd = FLASH_VJP_SHAPE
    gen = torch.Generator(device=dev).manual_seed(28)
    q = torch.randn((B, S, K, G, hd), generator=gen, device=dev)
    k, v = (torch.randn((B, S, K, hd), generator=gen, device=dev) for _ in range(2))
    w = torch.randn((B, S, K, G, hd), generator=gen, device=dev)
    pos = torch.arange(S, device=dev)
    paths = {"flash_vjp": lambda q, k, v: flash_attention_vjp(q, k, v, pos, pos, True, None, 1024),
             "chunked": lambda q, k, v: chunked_attention(q, k, v, pos, pos, causal=True,
                                                          window=None, kv_block=1024)}

    def fwd_bwd(f):
        ts = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = f(*ts)
        (out * w).sum().backward()
        return out.detach(), [t.grad for t in ts]

    res, attn_ms, attn_peak = {}, {}, {}
    for name, f in paths.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res[name] = fwd_bwd(f)
        attn_peak[name] = torch.cuda.max_memory_allocated() - base
    for name in ("flash_vjp", "chunked", "chunked", "flash_vjp"):  # in turns
        attn_ms.setdefault(name, []).append(time_ms(torch, lambda: fwd_bwd(paths[name]), reps=3))
    out_err = float((res["flash_vjp"][0] - res["chunked"][0]).abs().max())
    grad_err = [float((a - b).abs().max()) for a, b in zip(res["flash_vjp"][1], res["chunked"][1])]
    ok = bool(torch.allclose(res["flash_vjp"][0], res["chunked"][0], atol=2e-5, rtol=2e-5)) and all(
        bool(torch.allclose(a, b, atol=2e-4, rtol=2e-4))
        for a, b in zip(res["flash_vjp"][1], res["chunked"][1]))
    print(f"zoo train: flash_attention_vjp at (B, S=T, K, G, hd) = {FLASH_VJP_SHAPE}, causal, "
          f"kv_block 1024, against autograd through the chunked path: output {out_err:.3g} "
          f"(tolerance 2e-5), dq/dk/dv {grad_err[0]:.3g} / {grad_err[1]:.3g} / {grad_err[2]:.3g} "
          f"(tolerance 2e-4); forward + backward ms flash_vjp {fmt_times(attn_ms['flash_vjp'])}, "
          f"chunked {fmt_times(attn_ms['chunked'])} (in turns); transient peak flash_vjp "
          f"{attn_peak['flash_vjp'] / 2**30:.3f} GiB, chunked {attn_peak['chunked'] / 2**30:.3f} GiB")
    check(ok, f"zoo train: flash_attention_vjp differs from chunked autograd: {out_err}, {grad_err}")
    del q, k, v, w, res

    # one silo's local step with flash_vjp on and off, in turns, from the same state
    cfg1 = dataclasses.replace(cfg, n_silos=1)
    batch1 = {key: val[0] for key, val in batch_to_device(batcher.batch(rounds + 2), dev).items()}
    steps1 = {on: build_train_step(dataclasses.replace(cfg1, flash_vjp=on), optimizer=opt)
              for on in (True, False)}
    one = {}
    for on in (False, True, True, False):
        work = {"params": row["params"].clone(),
                "opt_state": {k_: v_.clone() for k_, v_ in row["opt_state"].items()},
                "step": row["step"]}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, m1 = steps1[on](work, batch1)
        loss1 = float(m1["loss"])
        torch.cuda.synchronize()
        one.setdefault(on, []).append((time.perf_counter() - t0,
                                       torch.cuda.max_memory_allocated() - base, loss1))
        del work
    d_loss = abs(one[True][0][2] - one[False][0][2])
    print(f"zoo train: one silo's local step (1 x {seq} tokens, AdamW) flash_vjp on: wall "
          + " / ".join(f"{t:.4f}" for t, _, _ in one[True]) + " s, peak above the state "
          + " / ".join(f"{b / 2**30:.3f}" for _, b, _ in one[True]) + " GiB; off: wall "
          + " / ".join(f"{t:.4f}" for t, _, _ in one[False]) + " s, peak above the state "
          + " / ".join(f"{b / 2**30:.3f}" for _, b, _ in one[False])
          + f" GiB; difference off - on {(one[False][0][1] - one[True][0][1]) / 2**30:.3f} GiB; "
          f"loss on vs off {d_loss:.3g}")
    check(d_loss <= 1e-4, f"zoo train: the step's loss with flash_vjp on and off differs by {d_loss}")
    opt_card = adamw_card_phase(torch, dev)
    out = {"launches": launches["gossip_mix"], "n_elems": silos * P, "P": P, "peak_bytes": peak,
           "round_s": walls, "losses": losses, "idle_share": idle, "busy_s": busy,
           "parts_s": parts, "params0": row["params"], "attn_ms": attn_ms,
           "attn_peak": attn_peak, "attn_err": (out_err, grad_err), "one_silo": one,
           "adamw": opt_card}
    del row
    gc.collect()
    torch.cuda.empty_cache()
    return out


def steps_serve_phase(torch, dev, params0) -> dict:
    """The serving step functions on silo 0's trained parameters from the
    zoo training phase: ``build_prefill_step`` with ``use_flash_kernel``
    (one K3 launch a layer), 8 ``build_decode_step`` calls (none), and the
    first greedy token against ``serve``'s on the same parameters."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models import ParamLayout, model_specs

    arch, layers, _, _, _ = ZOO_TRAIN
    batch, prompt_len, gen = STEPS_SERVE
    cfg = get_config(arch, n_layers=layers, use_flash_kernel=True)
    params = ParamLayout(model_specs(cfg)).views(params0)
    prompts = np.random.default_rng(29).integers(0, cfg.vocab_size, (batch, prompt_len))
    tokens = torch.from_numpy(prompts).to(dev)
    prefill, decode = build_prefill_step(cfg, prompt_len + gen), build_decode_step(cfg)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens})
    first = logits.argmax(-1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    k3_prefill = LAUNCHES["flash_attention"]
    tok = first
    t0 = time.perf_counter()
    for i in range(gen):
        step_logits, cache = decode(params, {"token": tok, "cache": cache, "position": prompt_len + i})
        tok = step_logits.argmax(-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    res = serve(cfg, batch=batch, prompt_len=prompt_len, gen=2, device=dev, params=params,
                prompts=prompts, log=lambda line: None)
    same = bool(torch.equal(res.ids[:, 0], first))
    d_pre = float((res.prefill_logits - logits).abs().max())
    print(f"steps serve: {arch} ({layers} layers, silo 0 of the zoo training) build_prefill_step "
          f"[{batch}x{prompt_len}] {prefill_s:.4f} s, {gen} build_decode_step calls {decode_s:.4f} "
          f"s (bfloat16 caches); flash_attention launches prefill {k3_prefill} decode "
          f"{launches['flash_attention'] - k3_prefill}; first greedy token {first.tolist()} == "
          f"serve's {res.ids[:, 0].tolist()}: {same} (prefill logits differ by {d_pre:.3g})")
    check(k3_prefill == layers and launches["flash_attention"] == layers,
          f"steps serve: flash_attention launches {launches}")
    check(launches["gossip_mix"] == launches["mlstm_scan"] == 0, f"steps serve: {launches}")
    check(bool(torch.isfinite(step_logits).all()), "steps serve: non-finite decode logits")
    check(same, "steps serve: the first greedy token differs from serve's")
    return {"launches": k3_prefill, "prefill_s": prefill_s, "decode_s": decode_s}


def dist_config(kind: str):
    """The configuration of a distributed phase: ``static`` is the train
    phase's (internlm2-1.8b, 4 of 24 layers, 4 silos on a ring, s = 2, 4 x 64
    tokens a silo, pallas, 3 rounds) and ``dynamic`` the dynamic phase's
    (h2o-danube-1.8b, 1 of 24 layers, Gaia's 11 silos under churn, 25
    rounds), as ``(cfg, train keyword arguments, ranks)``."""
    from repro_torch.configs import get_config

    if kind == "static":
        arch, layers, ranks, rounds = DIST_TRAIN
        return get_config(arch, n_layers=layers), dict(
            silos=ranks, topology="ring", gossip_impl="pallas", local_steps=2,
            batch_per_silo=4, seq_len=64, steps=rounds), ranks
    arch, layers, rounds = DIST_DYNAMIC
    return get_config(arch, n_layers=layers), dict(
        dynamic=True, underlay="gaia", scenario="churn", gossip_impl="pallas", designer="auto",
        local_steps=2, batch_per_silo=4, seq_len=64, steps=rounds), 11


def dist_rank(rank: int, world: int, init: str, kind: str, ref_path: str) -> dict:
    """One rank of a distributed phase, on ``cuda:0`` over ``gloo`` staged
    through pinned host memory: it trains its silo through ``train``, with
    the launch counts set to 0 just before and read just after, and holds
    its final row to that row of the same configuration's single-process
    run, saved raw at ``ref_path`` (1e-5).  One more round follows, whose
    K2 call is held to K2's plain version on the rank's stack, and whose
    mixed row is held bit for bit to row r of the stacked ``gossip_fused``
    of the pre-mix rows (its sources' received once more)."""
    import numpy as np
    import torch

    from repro_torch.fed import gossip as gossip_mod
    from repro_torch.fed import make_train_step
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.mesh import init_silo_mesh
    from repro_torch.launch.train import batch_to_device, train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    def say(line: str) -> None:  # one write a line: the ranks share stdout
        sys.stdout.write(line + "\n")
        sys.stdout.flush()

    cfg, kw, _ = dist_config(kind)
    rec = {"rank": rank}
    mesh = init_silo_mesh(rank, world, init, backend="gloo", device=dev, log=say)
    migrations = []
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = train(cfg, device=dev, mesh=mesh, log=say, on_migration=migrations.append, **kw)
    torch.cuda.synchronize(dev)
    rec.update(launches=dict(LAUNCHES), wall_s=time.perf_counter() - t0, rounds=res.rounds,
               losses=res.losses, round_s=res.step_seconds, active=res.active,
               peak_bytes=torch.cuda.max_memory_allocated(dev), staged_bytes=mesh.staged_bytes,
               staging_s=mesh.staging_s, recv_bytes=mesh.recv_bytes,
               migrations=[(m["left"], m["joined"], m["wall_s"]) for m in migrations])
    P = res.state["params"].numel()
    ref = np.fromfile(ref_path, dtype=np.float32, count=P, offset=rank * P * 4)
    rec["final_err"] = max(float((res.state["params"][lo:lo + DIST_CHUNK].cpu()
                                  - torch.from_numpy(ref[lo:lo + DIST_CHUNK])).abs().max())
                           for lo in range(0, P, DIST_CHUNK))
    del ref
    # one more round: K2's call held to its plain version, the pre-mix row kept
    premix, record = {}, []
    fused = gossip_mod.gossip_fused_rank

    def keep(row, plan, mesh_, *, out=None):
        premix.update(row=row.clone(), plan=plan)
        return fused(row, plan, mesh_, out=out)

    gossip_mod.gossip_fused_rank = keep
    try:
        with mix_against_plain(torch, record, chunk=1 << 24):
            step = make_train_step(res.cfg, res.fed, res.optimizer, res.plan, mesh=mesh)
            raw = res.batcher.batch(kw["steps"], silos=(rank,))
            state, _ = step(res.state, batch_to_device({k: v[0] for k, v in raw.items()}, dev))
    finally:
        gossip_mod.gossip_fused_rank = fused
    rec["k2_vs_plain"] = record
    del res
    # the mixed row against row r of the stacked gossip_fused of the pre-mix
    # rows, a chunk of columns at a time: the sources' pre-mix rows received
    # once more, this rank's own, every other row NaN (row r reads none)
    plan, pos, n = premix["plan"], mesh.position, len(mesh.active)
    same = True
    for lo in range(0, P, DIST_CHUNK):
        hi = min(lo + DIST_CHUNK, P)
        w = torch.full((n, hi - lo), float("nan"), device=dev)
        w[pos] = premix["row"][lo:hi]
        mesh.exchange([(mesh.active[d], premix["row"][lo:hi])
                       for d in gossip_mod.out_neighbours(plan, pos)],
                      [(mesh.active[s], w[s]) for s in gossip_mod.in_neighbours(plan, pos)])
        stacked = gossip_mod.gossip_fused(w, plan)
        same = same and bool(torch.equal(stacked[pos], state["params"][lo:hi]))
    rec["stacked_equal"] = same
    return rec


def dist_phase(torch, kind: str, ref_path: str, ref_round_s) -> dict:
    """A distributed phase: the ranks of ``kind``'s configuration spawned on
    ``cuda:0`` (:func:`dist_rank`), each rank's round walls, peak, staged
    bytes and the staging's share of its rounds printed, and the checks:
    one K2 launch per active rank a round, K2 bit-identical to plain on a
    rank's stack, the mixed rows bit-identical to the stacked
    ``gossip_fused``, the final rows within 1e-5 of one process's, finite
    losses equal on every rank, each round's received bytes equal to the
    plan's distinct in-neighbours times P * 4, and K1 on rank 0 only."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import ParamLayout, model_specs

    name = f"dist {kind} train"
    cfg, kw, world = dist_config(kind)
    P = ParamLayout(model_specs(cfg)).size
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{name}: {cfg.arch_id} d_model {cfg.d_model} vocab {cfg.vocab_size} layers "
          f"{cfg.n_layers}, P {P}; {world} ranks on cuda:0 over gloo, staged through pinned "
          f"host memory, pallas, {kw['steps']} rounds"
          + (", Gaia churn" if kw.get("dynamic") else ", ring")
          + f"; (K + 3) P 4 bytes a rank = {5 * P * 4 / 1e9:.2f} GB at K = 2; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated by this process")
    t0 = time.perf_counter()
    ranks = spawn(dist_rank, world, kind, ref_path)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        act = [rec for rec in r["rounds"] if rec["active"]]
        walls = [rec["wall_s"] for rec in act]
        share = sum(rec["staging_s"] for rec in act) / max(sum(walls), 1e-9)
        print(f"{name}: rank {r['rank']} round walls {[round(x, 4) for x in r['round_s']]} s "
              f"(active {len(act)} of {len(r['rounds'])}); peak {r['peak_bytes'] / 2**30:.2f} "
              f"GiB; staged {r['staged_bytes'] / 1e9:.3f} GB in {r['staging_s']:.3f} s, "
              f"{share:.3f} of its active round walls; received "
              f"{[rec['recv_bytes'] for rec in act][:3]} bytes a round; launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }")
        check(all(math.isfinite(x) for x in r["losses"]), f"rank {r['rank']} losses {r['losses']}")
        check(r["losses"] == r0["losses"], f"rank {r['rank']}'s losses differ from rank 0's")
        check(r["launches"]["gossip_mix"] == len(act),
              f"rank {r['rank']}: gossip_mix launched {r['launches']['gossip_mix']} times in "
              f"{len(act)} active rounds")
        for i, rec in enumerate(r["rounds"]):
            check(rec["recv_bytes"] == rec["rows_in"] * P * 4 and (rec["rows_in"] > 0) ==
                  rec["active"], f"rank {r['rank']} round {i}: received {rec['recv_bytes']} "
                                 f"bytes, its plan sends {rec['rows_in']} rows of {P * 4}")
        check(len(r["k2_vs_plain"]) == 1 and r["k2_vs_plain"][0][0],
              f"rank {r['rank']}: K2 vs plain on its stack {r['k2_vs_plain']}")
        if r["rank"]:
            k1 = {k: r["launches"][k] for k in ("segment_max", "karp", "reach", "timing")}
            check(not any(k1.values()), f"rank {r['rank']} launched K1 {k1}")
    n_rounds = [rec["n"] for rec in r0["rounds"]]
    k2 = sum(r["launches"]["gossip_mix"] for r in ranks)
    check(k2 == sum(n_rounds), f"gossip_mix launched {k2} times over the ranks, the rounds "
                               f"had {sum(n_rounds)} active silos")
    final_err = max(r["final_err"] for r in ranks)
    check(final_err <= 1e-5, f"final rows {final_err} from the single-process run")
    check(all(r["stacked_equal"] for r in ranks),
          "a rank's mixed row differs from its row of the stacked gossip_fused")
    print(f"{name}: K2 bit-identical to its plain version on every rank's stack; every mixed "
          f"row == row r of the stacked gossip_fused of the pre-mix rows; final rows "
          f"within {final_err:.3g} of the single-process run (limit 1e-05; its round walls "
          f"{[round(x, 4) for x in ref_round_s]} s); gossip_mix launches {k2} over {len(n_rounds)} "
          f"rounds of {n_rounds[0]}..{min(n_rounds)} silos; rank 0 K1 launches "
          f"{ {k: r0['launches'][k] for k in ('karp', 'reach', 'timing')} }; spawn and run "
          f"{wall:.1f} s")
    if kw.get("dynamic"):
        moves = [(len(left), len(joined)) for left, joined, _ in r0["migrations"]]
        check([m[:2] for m in r0["migrations"]] == [((5,), ()), ((), (5,))],
              f"migrations {r0['migrations']}")
        print(f"{name}: migrations {[(m[0], m[1], round(m[2], 4)) for m in r0['migrations']]} "
              f"(left, joined, wall s on rank 0) {moves}")
    return {"launches": k2, "karp": r0["launches"]["karp"], "timing": r0["launches"]["timing"],
            "P": P, "round_s": {r["rank"]: r["round_s"] for r in ranks},
            "peak_bytes": max(r["peak_bytes"] for r in ranks), "wall_s": wall}


def k3_32k_phase(torch, dev, q, k, v, window: int) -> dict:
    """K3 on the first attention layer's q, k, v of the 32k prefill,
    against its plain version (the K3 phases' tolerance), then timed in
    turns with its plain version and a windowed GQA
    ``scaled_dot_product_attention`` with a boolean mask, one call a query
    chunk of ``SDPA_CHUNK`` against the keys its window reaches (the whole
    32k mask does not fit the math path's scores), beside its bound."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_ref

    F = torch.nn.functional
    B, S, K, G, hd = q.shape
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    got = flash_attention(q, k, v, causal=True, window=window)
    err = float((got - ref).abs().max())
    check(torch.allclose(got, ref, atol=TOL["float32"], rtol=TOL["float32"]),
          f"flash_attention at the 32k prefill shape: max abs err {err}")
    # Yardstick only, never called by the port.
    qh = q.reshape(B, S, K * G, hd).transpose(1, 2)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    pos = torch.arange(S, device=dev)
    chunks = []
    for q0 in range(0, S, SDPA_CHUNK):
        k0 = max(0, q0 - window + 1)
        qp, kp = pos[q0:q0 + SDPA_CHUNK], pos[k0:q0 + SDPA_CHUNK]
        chunks.append((q0, k0, (kp[None, :] <= qp[:, None]) & (qp[:, None] - kp[None, :] < window)))

    def sdpa_window():
        return torch.cat([F.scaled_dot_product_attention(
            qh[:, :, q0:q0 + SDPA_CHUNK], kh[:, :, k0:q0 + SDPA_CHUNK],
            vh[:, :, k0:q0 + SDPA_CHUNK], attn_mask=mask, enable_gqa=True)
            for q0, k0, mask in chunks], dim=2)

    same = float((sdpa_window().transpose(1, 2).reshape(q.shape) - ref).abs().max())
    del got, ref
    runs = {"kernel": (lambda: flash_attention(q, k, v, causal=True, window=window), 5),
            "plain": (lambda: flash_attention_ref(q, k, v, causal=True, window=window), 1),
            "sdpa": (sdpa_window, 2)}
    times = {n: [] for n in runs}
    for n in list(runs) + list(runs)[::-1]:
        fn, reps = runs[n]
        times[n].append(time_ms(torch, fn, reps=reps, warmup=1))
    mean = {n: sum(t) / len(t) for n, t in times.items()}
    bound, by = attn_bound_ms(B, S, S, K, G, hd, window, 4, passes=3, rate=TF32_FLOPS)
    bound_f32, _ = attn_bound_ms(B, S, S, K, G, hd, window, 4)
    pairs = attn_pairs(S, S, True, window) * B * K * G
    print(f"kernel flash_attention B={B} S=T={S} K={K} G={G} hd={hd} window={window} f32 "
          f"(h2o-danube-1.8b prefill_32k, layer 0's q, k, v), in turns: ms "
          f"{fmt_times(times['kernel'])}  plain_ms {fmt_times(times['plain'])}  library_ms "
          f"windowed scaled_dot_product_attention, {len(chunks)} query chunks "
          f"{fmt_times(times['sdpa'])} (max abs diff to plain {same:.3g})  bound_ms "
          f"{bound:.4f} ({by}, 3xTF32 at {TF32_FLOPS / 1e12:.0f} TFLOP/s; {pairs} visible "
          f"pairs)  float32 CUDA-core bound {bound_f32:.4f}  max_abs_err {err:.3g}  achieved "
          f"{4 * hd * pairs / (mean['kernel'] * 1e-3) / 1e12:.2f} TFLOP/s of fp32-accurate "
          f"products ({bound / mean['kernel']:.1%} of the bound)")
    return {"ms": mean["kernel"], "plain_ms": mean["plain"], "library_ms": mean["sdpa"],
            "bound_ms": bound, "bound_by": by, "max_abs_err": err}


def dryrun_phase(torch, dev) -> dict:
    """The dry run of ``DRYRUN_PAIRS`` through ``dryrun_one`` on the card
    (the launch counts set to 0 just before each pair and read just
    after), the checks of each record, and K3 at the 32k shape on the
    first layer's q, k, v of the danube prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.dryrun import dryrun_one

    out = {"records": {}, "k3_launches": 0}
    first = []

    def keep(args, res):
        if not first:
            first.extend(a.detach().clone() for a in args[:3])

    for arch, shape, batch, flash in DRYRUN_PAIRS:
        gc.collect()
        torch.cuda.empty_cache()
        with recording(kops, "flash_attention", [], keep):
            reset_launch_counts()
            r = dryrun_one(arch, shape, device=dev, batch=batch, flash_kernel=flash,
                           reps=DRYRUN_REPS, profile=False)
            launches = dict(LAUNCHES)
        what = f"dry run {arch} {shape}"
        check(r["status"] == "ok", f"{what}: {r['status']} {r.get('error', r.get('reason'))}")
        check(r["finite"], f"{what}: the step's output is not finite")
        start, failed = r["start_batch"], r["failed_batches"]
        check(failed == [start >> i for i in range(len(failed))] and
              r["batch"] == start >> len(failed),
              f"{what}: batches failed {failed}, ran {r['batch']}, from {start}")
        roof = r["roofline"]
        check(0 < roof["share"] <= 1.0, f"{what}: step {r['step_s']} s against a bound of "
                                         f"{roof['bound_ms']} ms")
        k3 = launches["flash_attention"]
        want = get_config(arch).n_layers * r["steps_run"] if flash else 0
        check(k3 == want, f"{what}: flash_attention launched {k3} times, expected {want}")
        others = {k: v for k, v in launches.items() if v and k != "flash_attention"}
        check(not others, f"{what}: launched {others}")
        out["k3_launches"] += k3
        out["records"][(arch, shape)] = r
        print(f"{what}: batch {r['batch']} (failed {failed}, start {start}), peak "
              f"{r['peak_gib']:.2f} GiB, step {r['step_s']:.4f} s (warm-up {r['warm_up_s']:.4f}), "
              f"bound {roof['bound_ms']:.3f} ms ({roof['bottleneck']}: compute "
              f"{roof['compute_ms']:.3f} at float32, {roof['compute_tf32_ms']:.3f} at TF32, "
              f"bytes {roof['memory_ms']:.3f}), share {roof['share']:.4f}; flash_attention "
              f"launches {k3} in {r['steps_run']} steps; {r['seconds']} s")
        if flash:
            check(len(first) == 3, f"{what}: no flash_attention call recorded")
            gc.collect()
            torch.cuda.empty_cache()
            out["k3"] = k3_32k_phase(torch, dev, *first,
                                     window=get_config(arch).sliding_window)
            first.clear()
    return out


def perf_gossip_rank(rank: int, world: int, init: str, opts) -> dict:
    """One rank of the ``perf_gossip`` phase: ``perf_gossip``'s own rank,
    with each K2 call held to K2's plain version on the rank's stack as
    the call made it (``mix_against_plain``)."""
    import torch

    from repro_torch.launch import perf_gossip as PG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = []
    with mix_against_plain(torch, record, chunk=1 << 24):
        out = PG.run_rank(rank, world, init, opts)
    out["k2_vs_plain"] = record
    return out


def perf_gossip_phase(torch, dev) -> dict:
    """``perf_gossip`` on the one card (``PERF_GOSSIP``), its checks, and
    K2 timed at the star's per-rank shape."""
    from repro_torch.launch import perf_gossip as PG
    from repro_torch.launch.mesh import spawn

    n, layers, tokens, rounds = PERF_GOSSIP
    opts = PG.Options(device="cuda:0", backend="gloo", layers=layers, seq_len=tokens, batch=1,
                      rounds=rounds)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"perf_gossip: {n} ranks on cuda:0 over gloo, staged through pinned host memory; "
          f"{PG.ARCH} full width, {layers} layer(s), 1 x {tokens} tokens a silo, adamw(1e-4), "
          f"flash_vjp, {rounds} rounds an entry; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated by this process")
    t0 = time.perf_counter()
    ranks = spawn(perf_gossip_rank, n, opts)
    summary = PG.summarise(ranks, opts)
    wall = time.perf_counter() - t0
    for line in PG.table(summary):
        print(f"perf_gossip: {line}")
    rows = {(e["kind"], e["impl"]): e for e in summary["entries"]}
    for (kind, impl), e in rows.items():
        what = f"perf_gossip {kind}/{impl}"
        check(e["recv_ok"], f"{what}: received {e['recv_bytes']}, the plan sends other bytes")
        want = [rounds if impl == "pallas" else 0] * n
        check(e["launches"] == want, f"{what}: gossip_mix launches {e['launches']}, want {want}")
        check(math.isfinite(e["losses"]), f"{what}: loss {e['losses']}")
        print(f"perf_gossip: {what} round walls by rank "
              f"{[[round(x, 4) for x in w] for w in e['round_s']]} s; staged "
              f"{[round(b / 1e9, 3) for b in e['staged_bytes']]} GB in "
              f"{[round(x, 3) for x in e['staging_s']]} s; peak "
              f"{e['peak_bytes'] / 2**30:.2f} GiB; collective term "
              f"{e['roofline']['collective_ms']:.3f} ms at NVLink's rate; loss {e['losses']:.6f}")
    pallas = sum(impl == "pallas" for _, impl in PG.ENTRIES) * rounds
    for r in ranks:
        k2 = r["k2_vs_plain"]
        check(len(k2) == pallas and all(same for same, _ in k2),
              f"perf_gossip rank {r['rank']}: K2 vs plain on its stacks {k2} (want {pallas} "
              f"bit-identical calls)")
    for key in (("ring", "einsum"), ("ring", "pallas"), ("star", "pallas")):
        check(rows[key]["same_bits_as_first"],
              f"perf_gossip {key}: rows differ from {rows[key]['first_of_plan']}'s "
              f"(max abs params diff {rows[key]['max_abs_diff_params']})")
    chain = rows["chain", "pallas"]["max_abs_diff_params"]
    check(chain <= 2 * 1e-4 * rounds,
          f"perf_gossip chain/pallas: params {chain} from chain/ppermute's (AdamW's bound "
          f"2 lr rounds = {2 * 1e-4 * rounds})")
    check(summary["star_ring_traffic_ratio"] == n - 1,
          f"star/ring traffic {summary['star_ring_traffic_ratio']}")
    P = summary["P"]
    launches = sum(sum(e["launches"]) for e in summary["entries"])
    print(f"perf_gossip: every rank's bytes == recv_bytes_per_round; gossip_mix launches "
          f"{launches} ({rounds} a rank under pallas), each bit-identical to K2's plain version "
          f"on the rank's stack (ring, chain with weights of 1/3, star); ring einsum, ring "
          f"pallas and star pallas "
          f"bit-identical to ppermute, chain pallas within {chain:.3g} (limit "
          f"{2 * 1e-4 * rounds:g}); spawn and run {wall:.1f} s")
    star = star_shape_phase(torch, dev, 4, P)
    return {"launches": launches, "P": P, "star_k2": star, "summary": summary, "wall_s": wall}


def star_shape_phase(torch, dev, K: int, N: int) -> dict:
    """K2 at a star rank's shape (its ``[K, P]`` stack: its own row and
    its K - 1 in-neighbours'), with random weights that sum to 1 (not
    powers of two, so each product rounds): bit-identical to its plain
    version and to the grid-stride kernel, then timed in turns with them
    and ``torch.matmul`` of the weights and the stack (the same function),
    beside its bytes bound."""
    from repro_torch.kernels import gossip_mix
    from repro_torch.kernels.gossip_mix import gossip_mix_cuda, gossip_mix_ref

    gen = torch.Generator(device=dev).manual_seed(4)
    blocks = torch.randn((K, N), generator=gen, device=dev)
    w = torch.rand((K,), generator=gen, device=dev) + 0.5
    w /= w.sum()
    got = gossip_mix(blocks, w)
    check(torch.equal(got, gossip_mix_ref(blocks, w)),
          f"gossip_mix at K={K} N={N}: kernel and plain version differ")
    check(torch.equal(got, gossip_mix_cuda(blocks, w, grid_stride=True)),
          f"gossip_mix at K={K} N={N}: streaming and grid-stride kernels differ")
    err = float((torch.matmul(w, blocks) - got).abs().max())
    del got
    runs = {"kernel": (lambda: gossip_mix(blocks, w), 5),
            "grid_stride": (lambda: gossip_mix_cuda(blocks, w, grid_stride=True), 5),
            "matmul": (lambda: torch.matmul(w, blocks), 3),
            "plain": (lambda: gossip_mix_ref(blocks, w), 2)}
    times = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        fn, n = runs[name]
        times[name].append(time_ms(torch, fn, reps=n, warmup=1))
    mean = {name: sum(t) / len(t) for name, t in times.items()}
    bound, by = bound_ms(K, N, 4)
    print(f"kernel gossip_mix K={K} N={N} f32 (a star rank's stack), in turns: ms "
          f"{fmt_times(times['kernel'])}  grid-stride entry ms {fmt_times(times['grid_stride'])}  "
          f"plain_ms {fmt_times(times['plain'])}  library_ms torch.matmul "
          f"{fmt_times(times['matmul'])} (max abs diff {err:.3g})  bound_ms {bound:.4f} ({by})  "
          f"bit-identical to plain  achieved {gb_per_s(K, N, 4, mean['kernel']):.1f} GB/s "
          f"({bound / mean['kernel']:.1%} of the bound)")
    del blocks
    return {"ms": mean["kernel"], "grid_stride_ms": mean["grid_stride"],
            "plain_ms": mean["plain"], "library_ms": mean["matmul"], "bound_ms": bound,
            "bound_by": by, "max_abs_err": 0.0}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels._build import build_all, kernel_sources

    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = build_all()
    print(f"kernel build: {len(logs)} of {len(kernel_sources())} sources compiled "
          f"in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            if "Function properties for" in line:
                # the mangled kernel name and template arguments, e.g.
                # flash_attention_kernel<fLi80> for <float, 80>
                m = re.search(r"([a-z_]+_kernel)I(.+?)EE", line)
                entry = f"{m.group(1)}<{m.group(2)}>" if m else ""
            elif "registers" in line or "spill" in line:
                print(f"  {name} {entry}: {line.strip()}")

    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_rows_")
    ref_static, ref_dynamic = (os.path.join(ref_dir, f"{k}.f32") for k in ("static", "dynamic"))
    try:
        return run_phases(torch, dev, ref_static, ref_dynamic)
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)


def run_phases(torch, dev, ref_static: str, ref_dynamic: str) -> int:
    """Every phase after the build and the nvidia-smi line, in order; the
    two distributed phases hold their ranks to the rows that phases 3 and
    18 saved at ``ref_static`` and ``ref_dynamic``."""
    kern = kernel_phase(torch, dev)
    seg = segmax_kernel_phase(torch, dev)
    karp = karp_kernel_phase(torch, dev)
    parity_phase(torch, dev)
    tr = train_phase(torch, dev, ref_static)
    torch.cuda.empty_cache()
    main_shape = slice_shape_phase(torch, dev, tr["K"], tr["n_elems"])
    t0 = time.perf_counter()
    design = design_phase(torch, dev)
    climb_parity_phase(torch, dev)
    design_slice_phase(torch, dev, design["overlays"]["gaia"])
    design_s = time.perf_counter() - t0
    k2_plans_phase(torch, dev, design["overlays"])
    t0 = time.perf_counter()
    timing = timing_kernel_phase(torch, dev)
    matcha = matcha_design_phase(torch, dev)
    torch.cuda.empty_cache()
    mtrain = matcha_train_phase(torch, dev)
    torch.cuda.empty_cache()
    matcha_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    attn = flash_kernel_phase(torch, dev)
    served = serve_phase(torch, dev)
    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scan = mlstm_kernel_phase(torch, dev)
    xfwd = xlstm_forward_phase(torch, dev)
    xserve = xlstm_serve_phase(torch, dev)
    xlstm_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"dynamic phases: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated "
          "from the earlier phases")
    t0 = time.perf_counter()
    dyn = dynamic_train_phase(torch, dev, ref_dynamic)
    torch.cuda.empty_cache()
    dyn_shape = slice_shape_phase(torch, dev, dyn["K"], dyn["n_elems"])
    torch.cuda.empty_cache()
    ctl = controller_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    tdyn = traced_dynamic_phase(torch, dev)
    traced_s = time.perf_counter() - t1
    dynamic_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"zoo phases: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated "
          "from the earlier phases")
    t0 = time.perf_counter()
    attn_zoo = flash_zoo_phase(torch, dev)
    zoo = zoo_serve_phase(torch, dev)
    mtr = moe_train_phase(torch, dev)
    zoo_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"hybrid and vlm phases: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
          "allocated from the earlier phases")
    t0 = time.perf_counter()
    attn_hv = flash_hybrid_vlm_phase(torch, dev)
    hv = hybrid_vlm_serve_phase(torch, dev)
    htr = hymba_train_phase(torch, dev)
    hymba_shape = slice_shape_phase(torch, dev, htr["K"], htr["n_elems"])
    torch.cuda.empty_cache()
    hv_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"whisper phases: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated "
          "from the earlier phases")
    t0 = time.perf_counter()
    attn_wh = flash_whisper_phase(torch, dev)
    wh = whisper_serve_phase(torch, dev)
    wh_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"zoo training phases: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated "
          "from the earlier phases")
    t0 = time.perf_counter()
    ztr = zoo_train_phase(torch, dev)
    sserve = steps_serve_phase(torch, dev, ztr.pop("params0"))
    gc.collect()
    torch.cuda.empty_cache()
    ztr_s = time.perf_counter() - t0
    print(f"distributed phases: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated "
          "from the earlier phases")
    t0 = time.perf_counter()
    dtr = dist_phase(torch, "static", ref_static, tr["round_s"])
    rank_shape = slice_shape_phase(torch, dev, 2, dtr["P"])
    ddyn = dist_phase(torch, "dynamic", ref_dynamic, dyn["round_s"])
    dist_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"launch tooling phases: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
          "allocated from the earlier phases")
    t0 = time.perf_counter()
    dry = dryrun_phase(torch, dev)
    pg = perf_gossip_phase(torch, dev)
    tooling_s = time.perf_counter() - t0
    print(f"summary: gossip_mix 2^28 ms {kern['ms_2p28']:.4f} (grid-stride entry "
          f"{kern['grid_stride_ms_2p28']:.4f}, torch.lerp {kern['lerp_ms_2p28']:.4f}); main-path "
          f"shape ms {main_shape['ms']:.4f} (grid-stride entry {main_shape['grid_stride_ms']:.4f}, "
          f"torch.lerp {main_shape['library_ms']:.4f}); round wall s {[round(s, 4) for s in tr['round_s']]}; "
          f"peak GiB {tr['peak_bytes'] / 2**30:.2f}")
    print(f"summary: standalone segment_max ebone-climb shape ms {seg['ebone_climb']['ms']:.4f} "
          f"(scatter_reduce_ {seg['ebone_climb']['library_ms']:.4f}), scoring shape ms "
          f"{seg['scoring']['ms']:.4f} (scatter_reduce_ {seg['scoring']['library_ms']:.4f}); "
          f"karp score ms ebone-climb {karp['ebone_climb']['ms']:.4f} (per-level "
          f"{karp['ebone_climb']['per_level_ms']:.4f}), scoring {karp['scoring']['ms']:.4f} "
          f"(per-level {karp['scoring']['per_level_ms']:.4f}); design wall s "
          f"{[(r['net'], round(r['wall_s'], 4)) for r in design['rows']]}; karp launches "
          f"{design['launches']} over the design phase; design phases took {design_s:.1f} s")
    print(f"summary: timing_recursion ebone design shape ms {timing['ebone_design']['ms']:.4f} "
          f"(plain {timing['ebone_design']['plain_ms']:.4f}), engine shape ms "
          f"{timing['engine']['ms']:.4f} (plain {timing['engine']['plain_ms']:.4f}); matcha design "
          f"wall s {[(r['net'], round(r['wall_s'], 4)) for r in matcha['rows']]}; matcha round "
          f"wall s {[round(x, 4) for x in mtrain['round_s']]}, peak GiB "
          f"{mtrain['peak_bytes'] / 2**30:.2f}; matcha phases took {matcha_s:.1f} s")
    danube = served["h2o-danube-1.8b"]
    print(f"summary: flash_attention danube prefill shape ms {attn['ms']:.4f} (CUDA-core entry "
          f"{attn['simt_ms']:.4f}; bound {attn['bound_ms']:.4f} at 3xTF32, "
          f"{attn['bound_f32_ms']:.4f} at the float32 rate); serve prefill s / decode tok/s / peak GiB: " + "; ".join(
              f"{a} {r['prefill_s']:.4f} / {r['decode_tok_s']:.2f} / "
              f"{r['peak_bytes'] / 2**30:.2f}" for a, r in served.items())
          + f"; serving phases took {serve_s:.1f} s")
    print(f"summary: mlstm_scan xlstm-350m forward shape ms {scan['ms']:.4f} (CUDA-core entry "
          f"{scan['simt_ms']:.4f}; bound {scan['bound_ms']:.4f} at 3xTF32, "
          f"{scan['bound_f32_ms']:.4f} at the float32 rate; plain {scan['plain_ms']:.4f}); "
          f"K4 device time in a forward {xfwd['k4_device_s']:.4f} s; xlstm-350m forward s "
          f"{xfwd['kernel_s']:.4f} (plain {xfwd['plain_s']:.4f}); serve prefill s / decode "
          f"tok/s / peak GiB {xserve['prefill_s']:.4f} / {xserve['decode_tok_s']:.2f} / "
          f"{xserve['peak_bytes'] / 2**30:.2f}; xlstm phases took {xlstm_s:.1f} s")
    print(f"summary: dynamic churn round wall s {[round(x, 4) for x in dyn['round_s']]}; "
          f"migration wall s {[round(x, 4) for x in dyn['migration_s']]}; re-design wall s "
          f"{[round(x, 4) for x in dyn['redesign_s']]}; peak GiB {dyn['peak_bytes'] / 2**30:.2f}; "
          f"gossip_mix at the dynamic shape (K={dyn['K']}, N={dyn['n_elems']}) ms "
          f"{dyn_shape['ms']:.4f} (torch.lerp {dyn_shape['library_ms']:.4f}, bound "
          f"{dyn_shape['bound_ms']:.4f}); controller phase {ctl['wall_s']:.1f} s; traced "
          f"linkfail median round wall s {tdyn['traced_median_s']:.4f} (untraced "
          f"{tdyn['plain_median_s']:.4f}), trace {tdyn['trace_bytes']} bytes in "
          f"{tdyn['records']} records, train.step spans s "
          f"{[round(x, 4) for x in tdyn['step_span_s']]} of round walls "
          f"{[round(x, 4) for x in tdyn['round_sum_s']]}; traced phase took {traced_s:.1f} s; "
          f"dynamic phases took {dynamic_s:.1f} s")
    print(f"summary: flash_attention qwen3-moe prefill shape ms {attn_zoo['ms']:.4f} (plain "
          f"{attn_zoo['plain_ms']:.4f}, scaled_dot_product_attention {attn_zoo['library_ms']:.4f}, "
          f"bound {attn_zoo['bound_ms']:.4f} at 3xTF32); zoo serve prefill s / decode tok/s / "
          f"peak GiB: " + "; ".join(
              f"{a} {r['prefill_s']:.4f} / {r['decode_tok_s']:.2f} / "
              f"{r['peak_bytes'] / 2**30:.2f}" for a, r in zoo.items())
          + f"; moe train round wall s {[round(x, 4) for x in mtr['round_s']]}, peak GiB "
          f"{mtr['peak_bytes'] / 2**30:.2f}, idle share {mtr['idle_share']}; zoo phases took "
          f"{zoo_s:.1f} s")
    print("summary: flash_attention " + "; ".join(
        f"{a} prefill shape ms {r['ms']:.4f} (plain {r['plain_ms']:.4f}, causal GQA "
        f"scaled_dot_product_attention {r['sdpa_causal_ms']:.4f}, the same function "
        f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} at 3xTF32)"
        for a, r in attn_hv.items()) + "; serve prefill s / decode tok/s / peak GiB: " + "; ".join(
        f"{a} {r['prefill_s']:.4f} / {r['decode_tok_s']:.2f} / {r['peak_bytes'] / 2**30:.2f}"
        for a, r in hv.items()) + f"; hymba Mamba scan share of a warm prefill "
        f"{hv['hymba-1.5b']['scan_share']:.3f}; hymba train round wall s "
        f"{[round(x, 4) for x in htr['round_s']]}, peak GiB {htr['peak_bytes'] / 2**30:.2f}, "
        f"idle share {htr['idle_share']}; gossip_mix at the hymba shape (K={htr['K']}, "
        f"N={htr['n_elems']}) ms {hymba_shape['ms']:.4f} (torch.lerp "
        f"{hymba_shape['library_ms']:.4f}, bound {hymba_shape['bound_ms']:.4f}); hybrid and vlm "
        f"phases took {hv_s:.1f} s")
    print(f"summary: flash_attention whisper decoder prefill shape ms {attn_wh['ms']:.4f} "
          f"(CUDA-core entry {attn_wh['simt_ms']:.4f}, plain {attn_wh['plain_ms']:.4f}, causal "
          f"scaled_dot_product_attention {attn_wh['library_ms']:.4f}, bound "
          f"{attn_wh['bound_ms']:.6f} at 3xTF32); whisper-large-v3 serve prefill s / decode "
          f"tok/s / peak GiB {wh['prefill_s']:.4f} / {wh['decode_tok_s']:.2f} / "
          f"{wh['peak_bytes'] / 2**30:.2f}, warm prefill {wh['warm_prefill_s']:.4f} s (encoder "
          f"{wh['encoder_s']:.4f}, cross-attention {wh['cross_attention_s']:.4f}, K3 "
          f"{wh['k3_s']:.4f}); whisper phases took {wh_s:.1f} s")
    one = ztr["one_silo"]
    print(f"summary: zoo train (internlm2-1.8b, 4 layers, 4 silos, adamw, flash_vjp, 4096 tokens) "
          f"round wall s {[round(x, 4) for x in ztr['round_s']]}, losses "
          f"{[round(x, 4) for x in ztr['losses']]}, peak GiB {ztr['peak_bytes'] / 2**30:.2f}, idle "
          f"share {ztr['idle_share']}; flash_attention_vjp fwd+bwd ms "
          f"{fmt_times(ztr['attn_ms']['flash_vjp'])} (chunked autograd "
          f"{fmt_times(ztr['attn_ms']['chunked'])}); one-silo step s on "
          f"{[round(t, 4) for t, _, _ in one[True]]} off {[round(t, 4) for t, _, _ in one[False]]}, "
          f"peak above the state GiB on {one[True][0][1] / 2**30:.3f} off "
          f"{one[False][0][1] / 2**30:.3f}; adamw 2^26 ms {ztr['adamw']['ms']:.4f} (bound "
          f"{ztr['adamw']['bound_ms']:.4f}); steps serve prefill s {sserve['prefill_s']:.4f}, "
          f"K3 launches {sserve['launches']}; zoo training phases took {ztr_s:.1f} s")
    print(f"summary: one silo per process over staged gloo on one card: static round walls s "
          f"{ {r: [round(x, 4) for x in v] for r, v in dtr['round_s'].items()} }, peak GiB "
          f"{dtr['peak_bytes'] / 2**30:.2f}; gossip_mix at the per-rank shape (K=2, "
          f"N={dtr['P']}) ms {rank_shape['ms']:.4f} (torch.lerp {rank_shape['library_ms']:.4f}, "
          f"bound {rank_shape['bound_ms']:.4f}); dynamic peak GiB "
          f"{ddyn['peak_bytes'] / 2**30:.2f}; distributed phases took {dist_s:.1f} s")
    k3_32k, star = dry["k3"], pg["star_k2"]
    print("summary: dry run " + "; ".join(
        f"{a} {s_} batch {r['batch']} step {r['step_s']:.4f} s share "
        f"{r['roofline']['share']:.4f}" for (a, s_), r in dry["records"].items())
        + f"; flash_attention 32k prefill shape ms {k3_32k['ms']:.4f} (plain "
        f"{k3_32k['plain_ms']:.4f}, windowed scaled_dot_product_attention "
        f"{k3_32k['library_ms']:.4f}, bound {k3_32k['bound_ms']:.4f} at 3xTF32); perf_gossip "
        f"round s (one an entry; the first entry's is cold) " + ", ".join(
            f"{e['kind']}/{e['impl']} {e['last_round_s']:.4f}" for e in pg["summary"]["entries"])
        + f"; gossip_mix at the star shape (K=4, N={pg['P']}) ms {star['ms']:.4f} (torch.matmul "
        f"{star['library_ms']:.4f}, bound {star['bound_ms']:.4f}); launch tooling phases took "
        f"{tooling_s:.1f} s")
    climb = karp["ebone_climb"]
    dl = dyn["launches"]
    tl = tdyn["launches"]
    zoo_k3 = sum(r["launches"] for r in zoo.values())
    hv_k3 = sum(r["launches"] for r in hv.values())
    record = {"kernels": [{
        "name": "gossip_mix",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gossip_mix.cu",
        "replaces": "src/repro/kernels/gossip_mix.py:41",
        "launches": (tr["launches"] + dl["gossip_mix"] + tl["gossip_mix"] + mtr["launches"]
                     + htr["launches"] + ztr["launches"] + dtr["launches"] + ddyn["launches"]
                     + pg["launches"]),
        "launches_by_path": {"static_train": tr["launches"], "dynamic_train": dl["gossip_mix"],
                             "traced_dynamic_train": tl["gossip_mix"],
                             "moe_train": mtr["launches"], "hymba_train": htr["launches"],
                             "zoo_train": ztr["launches"], "distributed_train": dtr["launches"],
                             "distributed_dynamic_train": ddyn["launches"],
                             "perf_gossip": pg["launches"]},
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
    }, {
        "name": "segment_max",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_max.cu",
        "replaces": "src/repro/kernels/segment_max.py:82",
        "launches": design["launches"] + dl["karp"] + tl["karp"] + ddyn["karp"],
        "launches_by_path": {"design": design["launches"], "dynamic_train": dl["karp"],
                             "traced_dynamic_train": tl["karp"],
                             "distributed_dynamic_train": ddyn["karp"]},
        "max_abs_err": climb["max_abs_err"],
        "ms": climb["ms"],
        "plain_ms": climb["plain_ms"],
        "bound_ms": climb["bound_ms"],
        "bound_by": climb["bound_by"],
        "library_ms": climb["library_ms"],
    }, {
        "name": "timing_recursion",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_max.cu",
        "replaces": "src/repro/kernels/segment_max.py:82",
        "launches": matcha["launches"] + dl["timing"] + tl["timing"] + ddyn["timing"],
        "launches_by_path": {"matcha_design": matcha["launches"], "dynamic_train": dl["timing"],
                             "traced_dynamic_train": tl["timing"],
                             "distributed_dynamic_train": ddyn["timing"]},
        "max_abs_err": timing["ebone_design"]["max_abs_err"],
        "ms": timing["ebone_design"]["ms"],
        "plain_ms": timing["ebone_design"]["plain_ms"],
        "bound_ms": timing["ebone_design"]["bound_ms"],
        "bound_by": timing["ebone_design"]["bound_by"],
        "library_ms": timing["ebone_design"]["library_ms"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:81",
        "launches": (danube["launches"] + zoo_k3 + hv_k3 + wh["launches"] + sserve["launches"]
                     + dry["k3_launches"]),
        "launches_by_path": {"dense_serve": danube["launches"], "moe_and_large_dense_serve": zoo_k3,
                             "hybrid_and_vlm_serve": hv_k3, "encdec_serve": wh["launches"],
                             "steps_serve": sserve["launches"],
                             "dryrun_prefill_32k": dry["k3_launches"]},
        "max_abs_err": attn["max_abs_err"],
        "ms": attn["ms"],
        "plain_ms": attn["plain_ms"],
        "bound_ms": attn["bound_ms"],
        "bound_by": attn["bound_by"],
        "library_ms": attn["library_ms"],
    }, {
        "name": "mlstm_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_scan.cu",
        "replaces": "src/repro/kernels/mlstm_scan.py:62",
        "launches": xfwd["launches"],
        "max_abs_err": scan["max_abs_err"],
        "ms": scan["ms"],
        "plain_ms": scan["plain_ms"],
        "bound_ms": scan["bound_ms"],
        "bound_by": scan["bound_by"],
        "library_ms": scan["library_ms"],
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
