#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tpucenterface_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one card

Phases, in order; any failure raises and the script exits non-zero:
1. device: require CUDA; print the card's name and power limit (nvidia-smi);
2. build: compile the CUDA sources of the paths (`csrc/decode.cu`,
   `csrc/mbconv.cu`, `csrc/nms.cu`, `csrc/planar_chain.cu` (the planar
   chain and the one-block planar kernel), `csrc/int8_conv.cu`,
   `csrc/int8_block.cu`, `csrc/int8_block_s1.cu`) with
   nvcc into build/kernels/, one nvcc per source, and the host kernels
   (`native/stage_ext.cpp`, `native/nms_ext.cpp`) with g++ into
   build/native/, all started together;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the shapes the main paths give it, on ragged shapes and on
   tie-heavy inputs (the decode at the buckets' maps, batch 1, K = 1 and
   K = H*W, on constant, underflowing and one-band maps:
   DECODE_KERNEL_CASES, which include the eval path's flip batches of 32 and
   128 images at every bucket's map, the flagship's heads of a bs64 @ 640
   flip batch, and K = 100 at the serving rungs of 128, 32 and 8 images;
   the fused MBConv block under the planner's plan and under another plan
   at each main-path shape, each plan logged, and under the planner's plan
   at the eval path's flip batches of 128 images at 640, 416 and 512, at
   the serving rungs of 8 and 2 images @ 640 and at the `large` preset's
   blocks; the sigmoid + pseudo-NMS on plateaus across its tile seams and
   at the serving rungs (8 and 2, 160, 160)); the one-block planar kernel
   (on the planner's plan, each plan logged), the int8 1x1 conv and the
   stride-2 int8 block, which no engine calls,
   are held to their plain versions here and timed in phase 5, and are on
   no path. The int8 kernels are integer-exact up to float32 epilogues that
   round as their plain versions do, so they are held to them bit for bit,
   at the flagship's quantized weights and calibrated scales;
4. main paths, each with every launch counter set to 0 just before and read
   just after:
   a. `Detector.detect_batch` / `detect` on the flagship weights
      (artifacts/flagship.safetensors) with the fused decode kernel, at batch
      32 and 640x640, on odd image sizes, and at the flagship's own 320
      against the port's CPU run;
   b. the same weights with `inference_engine="fast"` (FastEngine and the
      fused MBConv kernel) at batch 32 and 640x640 against the module
      forward on the same card, and at 320;
   c. a landmark model (random weights from a seed) at batch 4 and 320x320,
      whose decode runs the fused sigmoid + pseudo-NMS kernel, bit-equal to
      the reference decode;
   d. the flagship weights with `inference_engine="planar"` (PlanarEngine and
      the planar chain kernel: three launches a forward at 640, four at 320)
      at batch 32 and 640x640 against the module forward on the same card,
      and at 320 against the port's CPU run;
   e. the flagship weights quantized (`Detector.quantize(int8_dw=True)`,
      calibrated on eight painted 640 frames) on two routes: the library
      route (`fused_blocks=False`: torch._int_mm and int32 depthwise sums)
      and the B7 route (`fused_blocks=True`: ten launches of the stride-1
      int8 block kernel a forward), each at batch 32 and 128 and 640x640
      against the bf16 module forward on the same card (the float32 forward
      as arbiter), and at 320 against the port's CPU run under the same
      scales; the B7 route against the library route as well;
   f. the eval entry point: the flip program (`Detector._batch_flip_fn`,
      one forward of the batch and its mirror) on the flagship weights at
      bs64 @ 640, module forward and fast engine, against the batch program
      on the batch and on its host-made mirror; flip + multi-scale TTA
      (`eval.batch_runner.batched_detect_tta`, scales 0.7 and 1.0) on
      EVAL_TTA_IMAGES painted scenes of mixed sizes against the port's CPU
      run of the same set (the same launch plan, the detections matched one
      by one, the AP of the WIDER protocol, `eval.synth_eval.
      score_detections`, within 0.005); the landmark model's flip program
      at bs4 @ 320 (the fused sigmoid + pseudo-NMS kernel, points
      un-mirrored and pair-swapped); then, outside the count, the TTA's
      images/s over EVAL_RATE_IMAGES scenes of sides 256-1024, several runs;
   g. the `large` preset (width 1.4, random weights from a seed) on the fast
      engine at bs32 @ 640: ten launches of the fused MBConv kernel, its
      heat map against the module forward's with the float32 forward as
      arbiter;
   h. the serving runtime (`[serving]`, `runtime/serving.py` and
      `runtime/video.py`): ServingEngine at 128 images a launch, K = 100,
      pinned staging, 512 pre-sized 640 frames from 4 threads in requests of
      1-16, on the module forward (B2 once a launch) and the fast engine (B3
      ten times), each request against a direct detect_batch; a landmark
      model's engine at rungs 8 and 2 (B1); the int8-input engine on the
      quantized B7 route against the uint8 engine, bit-identical (B7 ten
      launches a launch); ServingRouter on sides 256-1024 around a hot
      `reload_weights` from another thread; MultiStreamPipeline of 8 720p
      streams on the fast engine (B3 at batch 8 and 2). Then a formatted
      launch under torch.cuda.set_sync_debug_mode("error") (no host sync;
      a plain one syncs), and readings: images/s and p50/p99 of formatted
      against plain staging and of the int8-input against the uint8 engine,
      in alternating turns, and each staging mode's device idle share;
   i. training (`[train]`, `train/step.py`, `train/loop.py`; the card has
      no cv2, so the batches are numpy-painted scenes with
      `data.targets.make_targets`): (1) one float32 step at bs4 @ 320 from
      the flagship weights, card against the port's CPU run (loss,
      gradients, params, EMA, batch_stats), with a float64 run of its
      gradients on the card as the measure of float32 rounding; (2) the
      flagship recipe (`cli/train_flagship.py`'s defaults) at bs32 @ 320
      for 80 steps from `init_model` through the loop's `run_steps` and
      `prefetch_to_device`, FrozenBN from step 40, a checkpoint at 60: the
      loss finite and falling, the running statistics bit-equal after the
      boundary, the EMA apart from the live weights; (3) the checkpoint
      restored into a fresh state steps as the uninterrupted run did; (4)
      `model.safetensors` and `model_ema.safetensors` exported and detected
      with `Detector.from_safetensors` on the fast engine (B3) and the
      module forward with the fused decode (B2), counted; (5) readings:
      training images/s at bs32 @ 320 and @ 640 with float32 and bfloat16
      BatchNorm, peak memory with remat off and on, the device idle share
      of five steps; (6) the steps between two log boundaries of (2) ran
      under torch.cuda.set_sync_debug_mode("error"), the batch copies
      included;
   j. int8 fine-tuning (`[quant_ft]`, `quant/qat.py`, `quant/adaround.py`,
      `weights/io.py`'s packed artifact) on the flagship weights with
      int8_dw, calibrated on 16 painted 320 frames: (a) one STE step at bs4
      @ 320, card against the port's CPU run under one scales dict, a
      float64 run on the card beside them, and the bias-correction means;
      (b) `quantize(qat_steps=60)`: loss_last <= loss_bc <= loss_first;
      (c) `quantize(weight_bits=4, adaround_steps=40)`: every layer's ratio
      <= 1; (d) both tuned detectors at bs32 @ 640 on the library route and
      on the B7 route (the persisted pair installed with fused_blocks=True):
      B7 ten launches a forward, B2 one a call, the painted faces found, the
      routes matched; (e) `quant_variables` and the packed W4 artifact
      reloaded bit-equal, the artifact under half the float32 bytes; then
      readings: seconds of calibration, QAT and AdaRound, and the B7 route's
      images/s of the tuned detectors beside the PTQ detector's;
   k. the entry points users start the system with (`[entry]`,
      `weights/port.py`, `cli/`): (a) the flagship written as twin-layout
      `.pth` files (bare, wrapped in {"state_dict": ...}, `module.`-prefixed,
      and foreign-renamed, the last through `load_torch_pth(auto_map=True,
      allow_ambiguous=True)`) and loaded with `Detector.from_torch_pth` on
      the fast engine with the fused decode: at bs32 @ 640 on painted frames
      each is bit-equal to `from_safetensors` (B3 ten launches a forward, B2
      one a call), as is `reload_weights(torch_pth_path=)` on a live
      detector; (b) a random landmark twin saved as `.pth` and loaded with
      `use_pallas=True`: B1 once, bit-equal to the variables route; (c) the
      CLIs in this process (the card has no cv2): `port_weights` (equal to
      the flagship's safetensors), `serve --source synthetic` on 256 frames
      at 128 a launch (each line equal to a direct `detect_batch`, rounded
      as the CLI writes), `serve --int8 --int8-dw --save-packed` then
      `--packed` (equal lines), `demo --max-frames 32`, and the parity
      report's layer and boxes stages at float32 on numpy-painted scenes
      (passing, and failing with one corrupted tensor); (d) the C++
      `bbox_overlaps` and `nms` against the numpy loops; readings: the
      seconds of `load_torch_pth` and the serve summary (images/s, p50/p99);
   l. the alternates that are off by default (`[alternates]`): an s2d
      Detector (the stem remapped after the bake, a space-to-depth and a
      2x2 stem) with the fused decode against the 3x3 stem's detections at
      bs32 @ 640; the scale_and_translate letterbox (cubic) on the card
      against the port's CPU run on letterboxed 640 inputs, and a bilinear
      scale_translate Detector against the matmul letterbox's detections; a float32 planar Detector
      (the engine with no chain) against the float32 module forward; one
      `ConvBN(as_matmul=True)` forward against the conv on block 1's expand;
      readings: the s2d and 3x3 stems' ms, alone and in the forward, and
      the matmul 1x1 against the conv;
   m. data parallelism (`[dp]`, `runtime/sharding.py`) on a one-rank NCCL
      process group: `ServingEngine(mesh=data_mesh())` bit-equal to a direct
      `detect_batch` on the module forward (B2) and on the fast engine (B2,
      B3); three `shard_train_step` steps at bs32 @ 320 from the flagship
      weights (the BatchNorm moments, the loss normalizers, the gradients
      and metrics all-reduced) each against `make_train_step` from the same
      state under `[train]`'s check 1 bounds; `prefetch_to_device(sharding=)`
      order and device; the group destroyed before the last lines;
   n. the measurement tools (`[bench]`, `bench/`, `cli/bench_suite.py`),
      their iteration counts cut as BENCH_* says: `bench_suite` configs 1-4
      on the fast engine and config 5 (bs256 over `data_mesh()`, its int8
      variant on the library route) on the module forward over a one-rank
      NCCL group, with the flagship weights and the fused decode (B2 and
      B3 launched, no other kernel); `profile_detect_program` at bs128 @
      640, K = 100 (roofline, sections, the top ten ops and the calls that
      launched them; `mfu` and `hbm_frac` in [0, 1]; the total within
      BENCH_TOTAL_RTOL of a CUDA-event time of the same program), and the
      eval path's flip program at bs64 @ 640 (its top three ops and their
      launching calls);
      `roofline_of_fn` of the module forward and of the fast engine at bs32
      @ 640, their GFLOP within BENCH_GFLOP_RTOL; `profile_forward` at bs32
      @ 640 (the blocks within BENCH_BLOCKS_RATIO of the whole forward);
      `sweep_preset` on small, default and large; `slo_sweep` on the module
      forward (128 a launch, requests of 32, loads 0.5 and 0.95); the
      phase's seconds;
   o. the headline (`[headline]`, `cli/bench.py`, the counterpart of the
      root `bench.py`): `measure` on a default Detector (random weights, the
      defaults: module forward, reference decode, the library int8 route)
      at 32 images @ 640, bs128 serving, K = 100, its launches a pass cut as
      HEADLINE_* says; its JSON line printed, with every key of bench.py's
      line, the two `*vs_baseline` null, four rates inside their spreads,
      the roofline shares in [0, 1]; the C++ table staging (`apply_stem_lut`)
      against the numpy loop on the 128 frames, both timed; the int8-input
      program against the quantized uint8 program, bit for bit; no kernel
      launched;
5. times with CUDA events (median after warm-up; the decode at bs32 and
   bs1 @ 640 and at DECODE_TIMED_SHAPES; the fused MBConv block one call on
   packed weights, one call on the six weights and back to back; the
   sigmoid + pseudo-NMS one call and in a CUDA graph), and torch.profiler
   summaries of one bs32@640 batch of the module forward, of the fast engine,
   of the planar engine and of both quantized routes (device busy share, top
   device ops).

The images are procedural faces painted with numpy from a seed; the run
checks that the detector finds them. The last two lines are the
`{"kernels": [...]}` record and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "artifacts", "flagship.safetensors")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor FLOP/s
# and dense bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12

# The kernel's contract (tests/test_pallas_decode.py): indices equal.
SCORE_ATOL = 1e-6
BOX_ATOL = 1e-4
# Card against the port's CPU run at 320, both bfloat16: the bound the CPU
# tests state for port-against-JAX bfloat16 (tests/test_torch_detector.py).
BF16_BOX_ATOL, BF16_SCORE_ATOL, BF16_FIRM = 2.0, 0.03, 0.1
# The fast engine against the module forward at bs32@640, both bfloat16 on the
# card. Each is its own rounding of the float32 network, and a weak or nearly
# tied peak moves by a cell (4 px) or along a ridge under either rounding: the
# module forward itself loses 3 of 145 detections >= 0.1 against the float32
# forward under the bounds above. So the two bfloat16 forwards must match on
# at least this share of their detections >= BF16_FIRM (each way), and the
# float32 forward on the same card is the arbiter: the fast engine may not
# miss it on more detections than the module forward does plus
# FAST_F32_SLACK, and its heat map may not lie further from the float32 one
# than the module forward's does, times FAST_F32_HM_RATIO.
FAST_MATCH_SHARE, FAST_F32_SLACK, FAST_F32_HM_RATIO = 0.97, 2, 1.25
# The MBConv kernel against its plain version: both round to bfloat16 at the
# same points, but the tensor cores sum the products in another order than a
# float32 matrix product, so a value next to a bfloat16 rounding boundary can
# land one step away, at an intermediate or at the output. One bfloat16 step
# is at most 2^-7 of the value; the absolute term covers a flipped
# intermediate carried into a small output. At most 1% of the values may differ.
MBCONV_ATOL, MBCONV_RTOL, MBCONV_MAX_DIFFERING = 0.04, 2.0 ** -6, 0.01
# The planar kernels against their plain versions: the same cast points, the
# depthwise in the same order with the same roundings, so, as for the MBConv
# kernel, only the tensor cores' sum order differs: one bfloat16 step on at
# most 1% of the values, for one block (B4a is summed and written in float32,
# where the step is that of an intermediate carried to the output). A chain is
# held to that bound block by block: the kernel's chain of k blocks against the
# plain block applied to the kernel's own chain of k-1. End to end a flipped
# value is carried on and amplified by the following blocks (a six-block chain
# on random weights differs on 45% of its values by up to three steps while
# every single block is within one), so the whole chain against the whole
# plain chain is held to one step per block, atol and rtol times the chain's
# length, on at most PLANAR_CHAIN_MAX_DIFFERING of the values (seen: 0.45 on
# random weights, 0.11 on the flagship's). The block-by-block comparison is
# the one that tells a wrong kernel; the end-to-end one bounds what is carried.
PLANAR_ATOL, PLANAR_RTOL, PLANAR_MAX_DIFFERING = MBCONV_ATOL, MBCONV_RTOL, MBCONV_MAX_DIFFERING
PLANAR_CHAIN_MAX_DIFFERING = 0.5
# The blocks of a 640 input at whose shapes the one-block kernel (B4a) is held
# to its plain version and timed besides each chain's first block: the two
# stride-1 blocks that no chain takes.
PLANAR_SINGLE_BLOCKS = [(0, 1), (2, 1)]
# B4a's random cases besides the flagship's blocks (name, B, H, W, Cin,
# [(Ce, Cout)], the block with b1 = +3, ReLU6): no expand (streamed plans:
# the input's channels by ldmatrix) on ragged maps; Cin 16 and 12 (a K
# padding that the kernel zeroes); Cout 320 without a skip and Cout 160 with
# one (more than 96 output channels in one pass) on ragged maps; a 1x1 map;
# Ce 144 on a ragged 161-wide map (every chunk resident).
# tests/test_torch_planar_one.py plans every one of them on the CPU.
PLANAR_BLOCK_SHAPES = (
    ("no expand 2x23x37", 2, 23, 37, 32, [(32, 16)], None, True),
    ("no expand, ragged 2x50x70", 2, 50, 70, 32, [(32, 16)], None, True),
    ("b1=+3, 2x8x16", 2, 8, 16, 16, [(96, 24)], 0, True),
    ("odd widths, ReLU, batch 1, 19x33", 1, 19, 33, 12, [(40, 12)], None, False),
    ("160->960->320, 2x20x20", 2, 20, 20, 160, [(960, 320)], None, True),
    ("160->960->160 with a skip, ragged 2x21x23", 2, 21, 23, 160, [(960, 160)], None, True),
    ("1x1 map 32->192->32", 2, 1, 1, 32, [(192, 32)], None, True),
    ("24->144->24, ragged 2x37x161", 2, 37, 161, 24, [(144, 24)], None, True),
)
# The chains the planar engine runs at the Detector's PLANAR_CHAIN_RES, as
# (first block, number of blocks): three at a 640 input, four at 320.
PLANAR_CHAINS = {640: [(4, 2), (7, 6), (14, 3)], 320: [(2, 1), (4, 2), (7, 6), (14, 3)]}
# B4b's kernel phase beyond the flagship's chains, each held to the plain chain
# block by block and end to end (name, B, H, W, C0, [(Ce, Cout) a block], the
# block with b1 = +3, ReLU6, the scale of w2 times Ce^-0.5): no expand, odd
# widths, a chain of one, batch 1; Cout 320 (40 N tiles in one pass) at
# 10x10 and 20x20 at bs1 and bs32; Cout and Ce off the multiples of 8 and of
# the chunk; W one past a tile side; maps smaller than any tile; a 16-block
# chain (the scratch buffers in turns eight times; w2 small beside the skip, so
# that a flipped value is not amplified sixteen times over); a chain whose
# widest block is not its first. tests/test_torch_planar_chain.py plans every
# one of them on the CPU.
B4B_KERNEL_SHAPES = (
    ("no expand first, b1=+3, 2x23x37", 2, 23, 37, 32, [(32, 16), (96, 24), (144, 24), (144, 40)], 1, True, 2.0),
    ("no expand with skip, 1x5x7", 1, 5, 7, 8, [(8, 8), (48, 8)], None, True, 2.0),
    ("chain of one, batch 1, 10x10", 1, 10, 10, 160, [(960, 160)], None, True, 2.0),
    ("odd widths, ReLU, 3x19x33", 3, 19, 33, 12, [(40, 12), (40, 20), (20, 20)], 0, False, 2.0),
    ("six blocks, batch 1, 40x24", 1, 40, 24, 64, [(384, 64)] * 3 + [(384, 96), (576, 96), (576, 96)], 2, True, 2.0),
    *((f"160->960->320, {b}x{hw}x{hw}", b, hw, hw, 160, [(960, 320)], None, True, 2.0) for b in (1, 32) for hw in (10, 20)),
    ("Cout 37 and 13, 2x17x29", 2, 17, 29, 24, [(144, 37), (100, 13)], None, True, 2.0),
    ("Ce 136 and 200, 2x20x20", 2, 20, 20, 32, [(136, 32), (200, 32)], 0, True, 2.0),
    ("W one past 16, 2x33x17 32->192->32", 2, 33, 17, 32, [(192, 32)], None, True, 2.0),
    ("W one past 20, 2x40x41 96->576->96", 2, 40, 41, 96, [(576, 96)], None, True, 2.0),
    ("W one past 10, 2x20x21 160->960->160", 2, 20, 21, 160, [(960, 160)], None, True, 2.0),
    ("1x1 map 32->192->32", 2, 1, 1, 32, [(192, 32), (192, 32)], None, True, 2.0),
    ("2x3 map 64->384->96", 3, 2, 3, 64, [(384, 64), (384, 96)], None, True, 2.0),
    ("sixteen blocks, 2x12x12", 2, 12, 12, 32, [(96, 32)] * 16, None, True, 0.5),
    ("widest not first, 2x16x16", 2, 16, 16, 24, [(96, 16), (96, 64), (384, 32), (192, 32)], None, True, 2.0),
)
# B2's kernel phase beyond the main path's heads, each held to the plain
# version with indices equal (name, heads, (B, H, W), max_dets, wh_log): heads
# "random" (3 randn logits), "sparse" (a flat -8 map with a few peaks and a
# tied plateau), "separate" (random, wh and off as their own tensors),
# "constant" (every cell ties and is a peak), "underflow" (logits -120: every
# sigmoid is 0, so the K slots are the lowest-index zeros), "band" (one band
# of random logits among underflowing rows: the other bands keep only zeros);
# the buckets' maps at 416, 640, 800 and 1024, batch 1, K = 1 and K = H*W;
# then the eval path's shapes: the flip program decodes 2B images, B = 16 or
# 64 (the {B/4, B} ladder of a TTA batch of 64), so batch 32 and 128 at the
# map of every bucket (320 to 1024: maps 80 to 256), and the sparse heads at
# the flip batch of bs64 @ 640; then the serving path's: K = 100 (the serving
# `max_dets`) at the rungs 128, 32 and 8 of the `[serving]` engines. The first
# six are the parent's cases, on the same inputs.
# tests/test_torch_decode_select.py plans every one of them on the CPU.
DECODE_KERNEL_CASES = (
    ("random 3*randn (32,160,160)", "random", (32, 160, 160), 200, False),
    ("sparse+plateaus (8,160,160)", "sparse", (8, 160, 160), 200, False),
    ("wh_log (32,160,160)", "random", (32, 160, 160), 200, True),
    ("1024 bucket (2,256,256)", "random", (2, 256, 256), 200, False),
    ("K > H*W (3,7,9)", "random", (3, 7, 9), 200, False),
    ("separate heads (4,40,40)", "separate", (4, 40, 40), 100, False),
    ("batch 1 (1,160,160)", "random", (1, 160, 160), 200, False),
    ("416 bucket (4,104,104)", "random", (4, 104, 104), 200, False),
    ("800 bucket (4,200,200)", "random", (4, 200, 200), 200, False),
    ("K=1 (8,160,160)", "random", (8, 160, 160), 1, False),
    ("K=H*W (2,12,20)", "random", (2, 12, 20), 240, False),
    ("constant map (4,40,40)", "constant", (4, 40, 40), 200, False),
    ("all-underflow map (4,160,160)", "underflow", (4, 160, 160), 200, False),
    ("one rich band beside empty ones (4,160,160)", "band", (4, 160, 160), 200, False),
    *((f"eval flip batch ({b},{s // 4},{s // 4}), {s} bucket", "random", (b, s // 4, s // 4), 200, False)
      for b in (32, 128) for s in (320, 416, 512, 640, 800, 1024)),
    ("eval flip batch sparse+plateaus (128,160,160)", "sparse", (128, 160, 160), 200, False),
    *((f"serving K=100 ({b},160,160)", "random", (b, 160, 160), 100, False) for b in (128, 32, 8)),
)
# B2's timed shapes beyond the main path's heads (bs32 @ 640, K = 200): one
# 640 image (the flagship's heads of the first image), the 320 bucket at bs32
# and the 1024 bucket at batch 2 (random heads).
DECODE_TIMED_SHAPES = ((32, 80, 80), (2, 256, 256))
# The blocks of the default model with distinct kernel shapes at 640, and how
# many blocks of a forward share each shape (FastEngine.kernel_blocks(640)).
MBCONV_BLOCKS_640 = {0: 1, 2: 1, 4: 2, 7: 3, 10: 1, 11: 2}
# The fast engine's kernel shapes at a 320 input (blocks 0, 2, 4-5), held to
# the plain version at batch 32 on random inputs: (map, Cin, Ce, Cout, expand,
# skip).
MBCONV_SHAPES_320 = ((160, 32, 32, 16, False, False), (80, 24, 144, 24, True, True), (40, 32, 192, 32, True, True))
# dense int8 tensor-core operations a second (H100 SXM data sheet)
INT8_TC_OPS_PER_S = 1979e12
# The quantized path: the stride-2 blocks (B6 is held and timed at each; on no
# path) and the stride-1 residual blocks (B7, ten launches a forward) of the
# default model, and the eight painted 640 frames it is calibrated on
# (bench.py:125 of the JAX package calibrates on eight frames).
QUANT_S2_BLOCKS = [1, 3, 6, 13]
QUANT_S1_BLOCKS = [2, 4, 5, 7, 8, 9, 11, 12, 14, 15]
# B7's kernel phase beyond the flagship's blocks, each held bit-equal to the
# plain version (name, (B, H, W, Cin, Cmid, Cout), tie-heavy, residual): maps
# smaller than any tile, the 20x20 and 40x40 maps at bs1 and bs32 at both
# wide shapes, Cmid off the chunk width, W one past a tile side, no
# residual, ties at the fitted tiles. tests/test_torch_int8_kernels.py plans
# every one of them on the CPU.
B7_KERNEL_SHAPES = (
    ("ragged 2x37x53 24->144->24", (2, 37, 53, 24, 144, 24), False, True),
    ("160->960->160 2x13x7", (2, 13, 7, 160, 960, 160), False, True),
    ("no residual 1x9x30 32->192->64", (1, 9, 30, 32, 192, 64), False, False),
    ("ties 2x40x40 24->144->32", (2, 40, 40, 24, 144, 32), True, True),
    ("1x1 map 24->144->24", (2, 1, 1, 24, 144, 24), False, True),
    ("2x3 map 32->192->32", (3, 2, 3, 32, 192, 32), False, True),
    *((f"{b}x{hw}x{hw} {c}->{6 * c}->{c}", (b, hw, hw, c, 6 * c, c), False, True)
      for b in (1, 32) for hw in (20, 40) for c in (160, 96)),
    ("Cmid 136, 2x20x20 32->136->32", (2, 20, 20, 32, 136, 32), False, True),
    ("Cmid 200, 2x40x40 64->200->64", (2, 40, 40, 64, 200, 64), False, True),
    ("W one past 16, 2x33x161 24->144->24", (2, 33, 161, 24, 144, 24), False, True),
    ("W one past 20, 2x40x41 96->576->96", (2, 40, 41, 96, 576, 96), False, True),
    ("W one past 10, 2x20x21 160->960->160", (2, 20, 21, 160, 960, 160), False, True),
    ("no residual 2x20x20 160->960->160", (2, 20, 20, 160, 960, 160), False, False),
    ("ties 2x40x40 96->576->96", (2, 40, 40, 96, 576, 96), True, True),
    ("ties 2x20x20 160->960->160", (2, 20, 20, 160, 960, 160), True, True),
)
# B5's kernel phase beyond block 0's project, each held bit-equal to the plain
# version on the planner's plan (name, (B, Cin, P, Cout), operands: random,
# ties (small integers, scale and bias 0.5) or extreme (all +-127)): ragged
# and odd P (byte loads), Cin 960 at Cout 160, ties, Cin 16, 48 and 64, the
# largest Cin of the conversion-free epilogue and one past it at all +-127,
# Cout 8, P = 8 and 4 mod 16 (8- and 4-byte loads), bs1, P under one warp
# step, and a Cin whose weights do not fit in shared memory.
# tests/test_torch_int8_conv.py plans every one of them on the CPU.
B5_KERNEL_SHAPES = (
    ("ragged 3x24x1001 -> 40", (3, 24, 1001, 40), "random"),
    ("960 -> 160, P 77", (2, 960, 77, 160), "random"),
    ("ties 2x32x4099 -> 16", (2, 32, 4099, 16), "ties"),
    ("Cin 16, 2x16x6400 -> 24", (2, 16, 6400, 24), "random"),
    ("Cin 48, 2x48x1600 -> 32", (2, 48, 1600, 32), "random"),
    ("Cin 64, 2x64x25600 -> 16", (2, 64, 25600, 16), "random"),
    ("the magic epilogue's largest Cin, 2x255x1024 -> 16, all +-127", (2, 255, 1024, 16), "extreme"),
    ("one past the magic epilogue, 2x256x1024 -> 16, all +-127", (2, 256, 1024, 16), "extreme"),
    ("Cout 8, 2x32x4096 -> 8", (2, 32, 4096, 8), "random"),
    ("P = 8 mod 16, 2x32x40008 -> 16", (2, 32, 40008, 16), "random"),
    ("P = 4 mod 16, 2x32x40004 -> 16", (2, 32, 40004, 16), "random"),
    ("bs1 1x32x102400 -> 16", (1, 32, 102400, 16), "random"),
    ("P under one step, 2x32x24 -> 16", (2, 32, 24, 16), "random"),
    ("Cin past shared memory, 1x15000x64 -> 24", (1, 15000, 64, 24), "random"),
)
# B6's kernel phase beyond the flagship's blocks, each held bit-equal to the
# plain version on the planner's plan (name, (B, H, W, Cin, Cmid, Cout),
# tie-heavy): ragged and odd maps, a 1x1 map, ties, Cmid off the chunk width,
# Cin 16 on an odd map (the expand's K-16 step), the output W one past the
# planner's tile side, Cout 160 at bs1 on a 20x20 output, and Cin 48 and 136
# (the large preset's blocks 6 and 13: K-32 steps, then one of K 16).
# tests/test_torch_int8_block_s2.py plans every one of them on the CPU.
B6_KERNEL_SHAPES = (
    ("ragged 2x50x74 16->96->24", (2, 50, 74, 16, 96, 24), False),
    ("odd 3x33x19 96->576->160", (3, 33, 19, 96, 576, 160), False),
    ("1x1 map 8->40->8", (2, 1, 1, 8, 40, 8), False),
    ("ties 2x64x64 24->144->32", (2, 64, 64, 24, 144, 32), True),
    ("Cmid 200, 2x40x40 64->200->64", (2, 40, 40, 64, 200, 64), False),
    ("Cin 16 on an odd map, 2x37x21 16->96->24", (2, 37, 21, 16, 96, 24), False),
    ("W one past 16, 32x64x66 16->96->24", (32, 64, 66, 16, 96, 24), False),
    ("bs1 20x20 output 96->576->160", (1, 40, 40, 96, 576, 160), False),
    ("K 32 then K 16, Cin 48, 2x80x80 48->288->88", (2, 80, 80, 48, 288, 88), False),
    ("K 32 then K 16, Cin 136, 2x40x40 136->816->224", (2, 40, 40, 136, 816, 224), False),
)
QUANT_CALIB_SEED, QUANT_CALIB_FRAMES = 21, 8
# The quantized forward against the bf16 module forward on the same card, at
# bs32 and bs128 @ 640: int8 activations move a weak peak or a score by more
# than a bf16 rounding does (seen: 6-10% of the detections >= 0.1 without a
# partner within 2 px and 0.03, against 0.3-1.7% for the bf16 module forward
# against float32), so each route must match the module forward and the
# float32 forward on QUANT_MATCH_SHARE of their detections, and its heat map
# may lie at most QUANT_F32_HM_RATIO times as far from the float32 one as the
# module forward's (seen: 5.0 times).
QUANT_MATCH_SHARE, QUANT_F32_HM_RATIO = 0.85, 8.0
# The B7 route against the library route under the same scales: the kernel
# adds the residual in float32 before one bf16 rounding (the library route
# rounds the project output first) and multiplies by reciprocal scales where
# the library route divides. A bf16 step moves the next block's int8 input,
# and the flips are carried on as quantization noise of the same order as the
# library route's own (seen at bs32: 19 of 296 detections unmatched between
# the routes; each route misses 19 of the float32 forward's). So the routes
# must match on B7_MATCH_SHARE of their detections, and the float32 forward
# arbitrates: the B7 route may miss it on at most B7_F32_SLACK times as many
# detections as the library route (plus FAST_F32_SLACK), and its heat map may
# lie at most B7_F32_HM_RATIO times as far from the float32 one.
B7_MATCH_SHARE, B7_F32_SLACK, B7_F32_HM_RATIO = 0.9, 1.25, 1.1
# images of the eval phase's TTA set (card against the port's CPU run)
EVAL_TTA_IMAGES = 32
# The eval phase's throughput set: painted scenes with each side drawn from
# 256-1024 (so every bucket and many padded shapes, as in WIDER's mixed
# sizes), timed over EVAL_RATE_RUNS runs after a warm-up run.
EVAL_RATE_IMAGES, EVAL_RATE_SIDES, EVAL_RATE_RUNS = 256, (256, 1024), 5
# The input sizes of the eval path's B3 checks beside 640 (the TTA buckets the
# flagship's 384-512 scenes take at scales 0.7 and 1.0), each at batch 128.
EVAL_MBCONV_SIZES = (416, 512)
# The serving phase (`[serving]`): engines of SERVING_BATCH images a launch
# (the {B/4, B} ladder) at the serving decode profile (K = SERVING_MAX_DETS),
# fed SERVING_IMAGES pre-sized frames from SERVING_THREADS threads in requests
# of 1 to SERVING_MAX_REQUEST images, cut from SERVING_POOL painted frames;
# the int8-input engine against the uint8 one on SERVING_INT8_IMAGES frames
# (two full launches and a ragged tail on the small rung); readings in
# SERVING_TURNS turns of each mode, in alternation.
SERVING_BATCH, SERVING_MAX_DETS, SERVING_THREADS, SERVING_MAX_REQUEST = 128, 100, 4, 16
SERVING_IMAGES, SERVING_POOL, SERVING_INT8_IMAGES, SERVING_TURNS = 512, 64, 276, 3
# The router: ROUTER_IMAGES painted images with each side drawn from
# ROUTER_SIDES, ROUTER_BATCH images a launch; the hot reload swaps in the
# flagship's weights with every kernel scaled by 1 + RELOAD_NOISE * N(0, 1).
ROUTER_IMAGES, ROUTER_SIDES, ROUTER_BATCH, RELOAD_NOISE = 24, (256, 1024), 16, 0.03
# The multi-stream pipeline: STREAMS camera streams of STREAM_FRAMES frames
# of STREAM_HW (720p: one (768, 1280) bucket), on the fast engine.
STREAMS, STREAM_FRAMES, STREAM_HW = 8, 8, (720, 1280)
# every result() and join() of the serving phase waits at most this long, so a
# deadlock fails the run instead of hanging it
SERVING_TIMEOUT_S = 120

# The training phase (`[train]`). Card against the port's CPU run: one float32
# step (TF32 off) at TRAIN_CMP_BATCH @ TRAIN_SIZE from the flagship weights,
# held to the bounds tests/test_torch_train.py holds the port to JAX with,
# but for the gradients: the loss and its terms rtol 1e-5; each gradient
# tensor within TRAIN_GRAD_GMAX of the largest gradient element plus 1e-3 of
# its own largest. The trained BatchNorm layers of the flagship leave the
# first layers' batch statistics ill-conditioned in float32 (a gradient sums
# 10^5 terms that cancel): check 1 also runs the step's gradients in float64
# on the card and logs how far each float32 side lies from them (seen on an
# H100: up to 8.2e-4 of the largest gradient on the card, 9.0e-4 on the CPU,
# so the two may part by their sum). The new params within 1e-3 * lr + 1e-7
# where the gradient is above TRAIN_GRAD_GMAX of the largest
# (elsewhere Adam's first step is +-lr by the sign of rounding noise: within
# 2 * lr); the new running mean within 1e-5 * sqrt(var), the variance rtol
# 1e-5. The flagship recipe (`cli/train_flagship.py`'s defaults: default
# width, bf16 convolutions, lr 2e-3, EMA 0.999, clip 5.0, max_objs 32) at
# TRAIN_BATCH @ TRAIN_SIZE for TRAIN_STEPS steps from `init_model` on
# TRAIN_SCENES painted scenes (8 steps an epoch: LR drops at steps 48 and
# 64), FrozenBN from TRAIN_FREEZE, a checkpoint at TRAIN_CKPT; the mean loss
# of the last ten steps below TRAIN_LOSS_RATIO of the first ten's. The step
# after the checkpoint, from the restored state against the uninterrupted
# run's (cuDNN's default algorithms; the nearest-upsample and gather
# backwards add with atomics, so the gradients may differ in the last bits):
# the loss rtol 1e-5, the params within TRAIN_RESUME_LR_FRAC * lr.
# Readings: TRAIN_READ_STEPS timed steps a configuration.
TRAIN_CMP_BATCH, TRAIN_SIZE, TRAIN_BATCH, TRAIN_SIZE_BIG = 4, 320, 32, 640
TRAIN_STEPS, TRAIN_SCENES, TRAIN_FREEZE, TRAIN_CKPT = 80, 256, 40, 60
TRAIN_LOSS_RATIO, TRAIN_RESUME_LR_FRAC, TRAIN_READ_STEPS = 0.7, 1e-2, 10
TRAIN_GRAD_GMAX = 2e-3

# The fine-tuning phase (`[quant_ft]`): the flagship at default width with
# int8_dw, calibrated on QFT_CALIB_FRAMES painted QFT_SIZE frames, then QAT
# for QFT_QAT_STEPS steps and W4 AdaRound for QFT_ADA_STEPS steps
# (`cli/flagship_pins.py:37-40` of the JAX package). Check (a), one STE step
# at QFT_CMP_BATCH @ QFT_SIZE, card against the port's CPU run from one
# scales dict and one target (TF32 off): the fakequant loss rtol
# QFT_LOSS_RTOL, the gradients within QFT_GRAD_MAX of the largest element and
# QFT_GRAD_NORM of the norm, the bias-correction means within QFT_MEAN_ATOL
# of the largest mean. The bounds are three to five times the card's
# readings (NVIDIA H100 80GB HBM3, 700 W: loss 2.2e-5, gradients 0.34% and
# 0.35%, means 2.2e-7 in both modes, alike in four calls), and a control shows
# they bite: the card's step with TF32 on must break at least one (it read
# 0.0092 in loss, 35% in the gradients). A float64 run is no judge: float32
# rounding moves activations across grid points of the piecewise-constant
# loss, so float64 lies 91% of the largest gradient from both float32 runs.
QFT_CALIB_FRAMES, QFT_SIZE, QFT_QAT_STEPS, QFT_ADA_STEPS, QFT_CMP_BATCH = 16, 320, 60, 40, 4
QFT_LOSS_RTOL, QFT_GRAD_MAX, QFT_GRAD_NORM = 1e-4, 0.01, 0.01
QFT_MEAN_ATOL = {"quant": 1e-6, "float": 1e-6}

# The entry-point phase (`[entry]`): the `.pth` routes at ENTRY_BATCH @
# ENTRY_SIZE on painted frames; `cli.serve --source synthetic` on
# ENTRY_SERVE_IMAGES frames of ENTRY_SIZE at ENTRY_SERVE_BATCH a launch, every
# launch on that one rung (`--ladder`), so that a direct `detect_batch` in
# batches of ENTRY_SERVE_BATCH runs the same program on each image; `cli.demo`
# for ENTRY_DEMO_FRAMES frames; the parity report's stages at
# ENTRY_PARITY_SIZE on four painted 360x480 scenes.
ENTRY_SIZE, ENTRY_BATCH, ENTRY_SERVE_IMAGES, ENTRY_SERVE_BATCH = 640, 32, 256, 128
ENTRY_DEMO_FRAMES, ENTRY_PARITY_SIZE = 32, 320

# The measurement tools' phase (`[bench]`). Cut from the tools' defaults, to
# fit the run's time (iteration counts only; each cut is printed):
# `bench_suite` configs 2 and 5 time BENCH_ITERS launches a rate (100);
# `sweep_preset` BENCH_PRESET_ITERS launches a pass, BENCH_PRESET_PASSES
# passes (100, 3); `slo_sweep` BENCH_SLO_SECONDS a load point (8). Checks:
# `profile_detect_program`'s total device ms within BENCH_TOTAL_RTOL of a
# CUDA-event time of the same program; the module forward's and the fast
# engine's GFLOP (`roofline_of_fn`) within BENCH_GFLOP_RTOL of each other
# (each op counted by what it computes: they run the same arithmetic); the
# blocks of `profile_forward` summed within BENCH_BLOCKS_RATIO times the
# whole forward either way.
BENCH_ITERS, BENCH_PRESET_ITERS, BENCH_PRESET_PASSES, BENCH_SLO_SECONDS = 10, 5, 2, 2.0
BENCH_TOTAL_RTOL, BENCH_GFLOP_RTOL, BENCH_BLOCKS_RATIO = 0.25, 0.01, 2.0
# `[headline]` (`cli/bench.py`) at bench.py's sizes (32 images @ 640, bs128
# serving, K = 100) with its counts cut: launches of the bs32 program a pass
# (bench.py's 100), launches of each bs128 serving program a pass (200; the
# int8 programs take ~0.46 s a launch), passes (5).
HEADLINE_ITERS, HEADLINE_SERVE_ITERS, HEADLINE_PASSES = 20, 8, 2
# the keys of bench.py's JSON line (tests/test_torch_headline.py holds
# cli/bench.py's to them)
HEADLINE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "value_spread", "serving_coalesced_img_s",
    "serving_coalesced_spread", "serving_int8_img_s", "serving_int8_spread", "serving_int8_vs_baseline",
    "serving_int8in_img_s", "serving_int8in_spread", "serving_mfu", "serving_hbm_frac", "serving_roofline",
    "serving_sections", "serving_int8_sections", "serving_int8_mfu", "serving_int8_hbm_frac",
    "serving_int8_roofline", "serving_note",
)


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
# images: procedural faces, numpy only
# --------------------------------------------------------------------------- #

_SKIN_BGR = np.array(
    [(140, 170, 220), (120, 160, 210), (100, 140, 190), (80, 115, 165), (60, 90, 135), (45, 70, 105)],
    np.float32,
)


def _ellipse(img, cx, cy, ax, ay, color):
    h, w = img.shape[:2]
    y0, y1 = max(0, int(cy - ay) - 1), min(h, int(cy + ay) + 2)
    x0, x1 = max(0, int(cx - ax) - 1), min(w, int(cx + ax) + 2)
    if y1 <= y0 or x1 <= x0:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    inside = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0
    img[y0:y1, x0:x1][inside] = color


def paint_scene(rng, hw, n_faces):
    """(uint8 BGR image, (N, 4) xyxy face boxes): a noisy gradient with
    non-overlapping cartoon faces (head, eyes, brows, nose, mouth)."""
    h, w = hw
    g0, g1 = rng.uniform(20, 160, 3), rng.uniform(20, 160, 3)
    ramp = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    img = np.broadcast_to(g0 * (1 - ramp) + g1 * ramp, (h, w, 3)).astype(np.float32)
    img = img + rng.normal(0, 6, (h, w, 3)).astype(np.float32)
    boxes = []
    for _ in range(50 * n_faces):
        if len(boxes) == n_faces:
            break
        size = float(np.exp(rng.uniform(np.log(24), np.log(0.4 * min(h, w)))))
        h2 = size / 2
        w2 = h2 * rng.uniform(0.68, 0.82)
        cx = rng.uniform(w2 + 2, w - w2 - 2)
        cy = rng.uniform(h2 + 2, h - h2 - 2)
        box = (cx - w2, cy - h2, cx + w2, cy + h2)
        if any(box[0] < b[2] + 4 and b[0] < box[2] + 4 and box[1] < b[3] + 4 and b[1] < box[3] + 4 for b in boxes):
            continue
        tone = np.clip(_SKIN_BGR[rng.randint(len(_SKIN_BGR))] * rng.uniform(0.85, 1.15, 3), 0, 255)
        _ellipse(img, cx, cy, w2, h2, tone)
        dark = rng.uniform(10, 60, 3)
        for sx in (-0.38, 0.38):
            ex, ey, er = cx + sx * w2, cy - 0.18 * h2, max(1.0, 0.11 * h2)
            _ellipse(img, ex, ey, er, er * 0.62, np.clip(tone * 1.35 + 40, 0, 255))
            _ellipse(img, ex, ey, er * 0.5, er * 0.5, dark)
            _ellipse(img, ex, cy - 0.38 * h2, er, max(1.0, er * 0.3), dark * 0.8)
        _ellipse(img, cx, cy + 0.04 * h2, max(1.0, 0.05 * h2), 0.09 * h2, tone * 0.75)
        mouth = (rng.uniform(30, 70), rng.uniform(20, 60), rng.uniform(90, 180))
        _ellipse(img, cx, cy + 0.48 * h2, 0.26 * h2, max(1.0, 0.07 * h2), mouth)
        boxes.append(box)
    return np.clip(img, 0, 255).astype(np.uint8), np.array(boxes, np.float32).reshape(-1, 4)


def paint_batch(seed, n, hw, faces=4):
    rng = np.random.RandomState(seed)
    scenes = [paint_scene(rng, hw, faces) for _ in range(n)]
    return np.stack([s[0] for s in scenes]), [s[1] for s in scenes]


def iou(a, b):
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter)


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #


def cuda_times(fn, iters, warmup=3):
    """Milliseconds of each of `iters` calls of `fn()`, each between two
    CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, iters, warmup=3):
    """Median milliseconds of `fn()` (see `cuda_times`)."""
    return float(np.median(cuda_times(fn, iters, warmup)))


def back_to_back_ms(fn, launches=20, runs=5):
    """Device milliseconds a call: the median over `runs` of CUDA events
    around `launches` calls back to back, after warm-up (the host's time
    between calls is hidden where a call's device time is longer)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def graph_ms(fn, calls=20, runs=5):
    """Device milliseconds a call: the median over `runs` of CUDA events
    around one replay of a CUDA graph of `calls` calls, after warm-up (for
    calls whose host time is longer than their device time)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def device_profile(fn, iters=5):
    """torch.profiler over `iters` calls of `fn()`: the device's busy share
    of the wall time (the median call's, each call ending in a synchronize)
    and the device time of the top operators."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))
    # the events that ran on the device (kernels, copies, memsets): their
    # self times sum to the busy time, as kernels of one stream do not overlap
    busy_us, top = 0.0, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("Activity Buffer"):
            continue
        dev_us = ev.self_device_time_total
        top[ev.key[:80]] = dev_us / iters / 1e3
        busy_us += dev_us
    busy_ms = busy_us / iters / 1e3
    top = dict(sorted(top.items(), key=lambda kv: -kv[1])[:12])
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms > 0 else None,
        "top_device_ms": top,
    }


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    # float32 references run in full float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(smi)
    return smi


def phase_build():
    """One nvcc per source, all started together (nvcc runs in a subprocess,
    so threads are enough)."""
    from concurrent.futures import ThreadPoolExecutor

    from tpucenterface_torch import native
    from tpucenterface_torch.kernels import build

    def timed(name):
        t0 = time.perf_counter()
        build.load(name)
        return time.perf_counter() - t0

    def timed_host(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    names = ("decode", "mbconv", "nms", "planar_chain", "int8_conv", "int8_block", "int8_block_s1")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 2) as pool:
        stage = pool.submit(timed_host, native.load)
        nms_ext = pool.submit(timed_host, native.load_nms)
        secs = list(pool.map(timed, names))
    each = ", ".join(f"csrc/{n}.cu {t:.1f} s" for n, t in zip(names, secs))
    log(f"[build] {each}; native/stage_ext.cpp (g++) {stage.result():.1f} s, native/nms_ext.cpp (g++) "
        f"{nms_ext.result():.1f} s; all built and loaded in {time.perf_counter() - t0:.1f} s")


def _fused_feats(hm, wh, off):
    """hm/wh/off as the port's fused heads give them: strided views of one
    (B, H, W, 5) float32 map, plus the contiguous wh+off view."""
    y = torch.cat([hm, wh, off], dim=-1).contiguous()
    return {"hm": y[..., 0:1], "wh": y[..., 1:3], "off": y[..., 3:5], "whoff": y[..., 1:5]}


def _random_feats(gen, b, h, w, dev):
    hm = 3.0 * torch.randn(b, h, w, 1, generator=gen)
    wh = 6.0 * torch.rand(b, h, w, 2, generator=gen)
    off = torch.rand(b, h, w, 2, generator=gen) - 0.5
    return _fused_feats(hm.to(dev), wh.to(dev), off.to(dev))


def _sparse_feats(gen, b, h, w, dev):
    """A flat -8 plateau with a few real peaks and plateaus of equal logits:
    every K slot after the peaks is decided by the lowest-index tie rule."""
    hm = torch.full((b, h, w, 1), -8.0)
    for i in range(b):
        ys = torch.randint(0, h, (6,), generator=gen)
        xs = torch.randint(0, w, (6,), generator=gen)
        for j, (y, x) in enumerate(zip(ys.tolist(), xs.tolist())):
            hm[i, y, x, 0] = 4.0 - 0.5 * j
        y0, x0 = (h // 3 + i) % (h - 3), (w // 2 + 2 * i) % (w - 4)
        hm[i, y0 : y0 + 3, x0 : x0 + 4, 0] = 1.5  # a tied plateau
    wh = 4.0 * torch.rand(b, h, w, 2, generator=gen) - 0.5  # some negative sizes
    off = torch.rand(b, h, w, 2, generator=gen) - 0.5
    return _fused_feats(hm.to(dev), wh.to(dev), off.to(dev))


def _filled_feats(gen, b, h, w, dev, logit, rich_rows=None):
    """Every logit `logit` (a constant map: every cell ties and is a peak; at
    -120 every sigmoid underflows to 0), but 3 randn logits on `rich_rows`."""
    hm = torch.full((b, h, w, 1), logit)
    if rich_rows is not None:
        hm[:, rich_rows] = 3.0 * torch.randn(b, rich_rows.stop - rich_rows.start, w, 1, generator=gen)
    wh = 4.0 * torch.rand(b, h, w, 2, generator=gen) - 0.5
    off = torch.rand(b, h, w, 2, generator=gen) - 0.5
    return _fused_feats(hm.to(dev), wh.to(dev), off.to(dev))


def decode_case_feats(gen, heads, shape, dev):
    """The heads of one case of DECODE_KERNEL_CASES."""
    b, h, w = shape
    if heads == "random":
        return _random_feats(gen, b, h, w, dev)
    if heads == "sparse":
        return _sparse_feats(gen, b, h, w, dev)
    if heads == "separate":
        return {k: v.contiguous() for k, v in _random_feats(gen, b, h, w, dev).items() if k != "whoff"}
    if heads == "constant":
        return _filled_feats(gen, b, h, w, dev, 0.7)
    if heads == "underflow":
        return _filled_feats(gen, b, h, w, dev, -120.0)
    if heads == "band":
        return _filled_feats(gen, b, h, w, dev, -120.0, rich_rows=slice(h // 2, h // 2 + 12))
    raise ValueError(heads)


def phase_kernels_decode(det_feats, flip_feats):
    """decode_feats_fused (CUDA) against decode_feats_fused_plain on the card,
    at the main path's heads, at the flagship's heads of the eval path's flip
    batch (bs64 @ 640 and its mirror) and at DECODE_KERNEL_CASES. Returns the
    largest error seen."""
    from tpucenterface_torch.config import DecodeConfig
    from tpucenterface_torch.decode.fused_decode import decode_feats_fused, decode_feats_fused_plain, plan_decode

    dev = det_feats["hm"].device
    gen = torch.Generator().manual_seed(1234)
    cases = [("main-path heads bs32@640", det_feats, DecodeConfig(max_dets=200)),
             ("eval flip-batch heads bs128@640", flip_feats, DecodeConfig(max_dets=200))]
    cases += [(name, decode_case_feats(gen, heads, shape, dev), DecodeConfig(max_dets=k, wh_log=wh_log))
              for name, heads, shape, k, wh_log in DECODE_KERNEL_CASES]
    worst = 0.0
    for name, feats, cfg in cases:
        kb, ks, ki = decode_feats_fused(feats, cfg)
        pb, ps, pi = decode_feats_fused_plain(feats, cfg)
        torch.cuda.synchronize()
        if not torch.equal(ki, pi):
            bad = (ki != pi).nonzero()[:5].tolist()
            raise AssertionError(f"[kernels] {name}: indices differ at {bad}")
        es = (ks - ps).abs().max().item()
        eb = (kb - pb).abs().max().item()
        b, h, w, _ = feats["hm"].shape
        plan = plan_decode(b, h, w, ks.shape[1])
        log(f"[kernels] decode {name}: K={ks.shape[1]} (bands of {plan.rows} rows, {plan.candidates} candidates) "
            f"indices equal, max |score err| {es:.3g} (atol {SCORE_ATOL}), max |box err| {eb:.3g} (atol {BOX_ATOL})")
        if not (es <= SCORE_ATOL and eb <= BOX_ATOL):
            raise AssertionError(f"[kernels] {name}: errors {es}, {eb} over the limits")
        worst = max(worst, es, eb)
    return worst


def mbconv_block_inputs(det, x):
    """{block: (NHWC bf16 input, (w1, b1, wd, bd, w2, b2), skip)} for the
    blocks of MBCONV_BLOCKS_640: the activations the network of `det` (the
    flagship's, or the `large` preset's) gives each block on the batch `x`,
    and the block's own weights."""
    from tpucenterface_torch.weights.convert import mbconv_args_from_block

    bb = det.model.backbone
    blocks = det.variables["params"]["backbone"]
    out = {}
    with torch.inference_mode():
        y = bb.stem(x.permute(0, 3, 1, 2).to(bb.dtype))
        for i in range(max(MBCONV_BLOCKS_640) + 1):
            mod = getattr(bb, f"block_{i}")
            if i in MBCONV_BLOCKS_640:
                args = tuple(
                    None if a is None else torch.from_numpy(a).to(x.device, torch.bfloat16)
                    for a in mbconv_args_from_block(blocks[f"block_{i}"])
                )
                out[i] = (y.permute(0, 2, 3, 1).contiguous(), args, mod.use_skip)
            y = mod(y)
    return out


def _random_mbconv(gen, b, h, w, cin, ce, cout, expand, dev):
    def rnd(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, torch.bfloat16)

    x = rnd(b, h, w, cin, scale=0.5)
    w1, b1 = (rnd(cin, ce, scale=0.3), rnd(ce, scale=0.1)) if expand else (None, None)
    return x, (w1, b1, rnd(3, 3, ce, scale=0.3), rnd(ce, scale=0.1), rnd(ce, cout, scale=2 * ce ** -0.5),
               rnd(cout, scale=0.1))


def mbconv_plan_desc(plan):
    """A B3 launch plan as logged: tile, warps, project rectangle, output
    channels a block, chunk width."""
    return (f"{plan.tile_h}x{plan.tile_w} tile, {plan.warps} warps, {plan.pm}x{plan.pn} rectangles, "
            f"{plan.cout_group} outputs a block, CK {plan.ck}")


def _mbconv_check(name, x, args, skip, got, want, plan):
    """Log and check one B3 output against the plain version; returns max |err|."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"[kernels] mbconv {name}: non-finite output")
    diff = (got - want).abs()
    err, differing = diff.max().item(), (diff > 0).float().mean().item()
    over = (diff > MBCONV_ATOL + MBCONV_RTOL * want.abs()).sum().item()
    cin, ce, cout = x.shape[-1], args[2].shape[-1], args[4].shape[-1]
    log(f"[kernels] mbconv {name}: x {tuple(x.shape)} {cin}->{ce}->{cout} skip={skip}, {mbconv_plan_desc(plan)}: "
        f"max |err| {err:.3g} (max |out| {want.abs().max().item():.3g}), differing {differing:.2e} of values, "
        f"{over} over atol {MBCONV_ATOL} + rtol {MBCONV_RTOL:.4f}")
    if over or differing > MBCONV_MAX_DIFFERING:
        raise AssertionError(f"[kernels] mbconv {name}: {over} values over the tolerance, {differing} differing")
    return err


def phase_kernels_mbconv(block_inputs, more_inputs):
    """fused_mbconv (CUDA) against fused_mbconv_plain on the card: the six
    main-path shapes at batch 32 on the flagship's own activations and
    weights, the three shapes of a 320 input and ragged shapes on random
    ones, then `more_inputs` ({label: what `mbconv_block_inputs` gives}: the
    eval path's flip batches at batch 128, the `large` preset's blocks).
    Main-path shapes run on packed weights under the planner's plan, and
    once more under another plan of `fused_mbconv_plans` (the first of
    another tile or warp count); ragged ones on the six weights; those of
    `more_inputs` on packed weights under the planner's plan, as their paths
    run them. Returns {case: max |err|}."""
    from tpucenterface_torch.ops import fused_mbconv as fm

    dev = next(iter(block_inputs.values()))[0].device
    gen = torch.Generator().manual_seed(4321)
    cases = [(f"block {i} bs32@640", x, args, skip, "main") for i, (x, args, skip) in block_inputs.items()]
    for hw, cin, ce, cout, expand, skip in MBCONV_SHAPES_320:
        x, args = _random_mbconv(gen, 32, hw, hw, cin, ce, cout, expand, dev)
        cases.append((f"bs32 {hw}x{hw} of a 320 input, random", x, args, skip, "main"))
    for name, cin, ce, cout, expand, skip in (
        ("ragged expand+skip 2x26x38", 24, 144, 24, True, True),
        ("ragged expand 2x26x38", 16, 96, 24, True, False),
        ("ragged no expand 2x26x38", 32, 32, 16, False, False),
        ("ragged 160->960->320 2x19x33", 160, 960, 320, True, False),
    ):
        h, w = (19, 33) if cin == 160 else (26, 38)
        x, args = _random_mbconv(gen, 2, h, w, cin, ce, cout, expand, dev)
        cases.append((name, x, args, skip, "six"))
    for label, inputs in more_inputs.items():
        cases += [(f"block {i} {label}", x, args, skip, "packed") for i, (x, args, skip) in inputs.items()]
    errs = {}
    for name, x, args, skip, mode in cases:
        b, h, w, cin = x.shape
        ce, cout, expand = args[2].shape[-1], args[4].shape[-1], args[0] is not None
        plan = fm.plan_fused_mbconv(b, h, w, cin, ce, cout, expand)
        want = fm.fused_mbconv_plain(x, *args, skip=skip).float()
        if mode == "six":
            got = fm.fused_mbconv(x, *args, skip=skip).float()
            torch.cuda.synchronize()
            errs[name] = _mbconv_check(name, x, args, skip, got, want, plan)
            continue
        packed = fm.pack_fused_mbconv(*args)
        got = fm.fused_mbconv(x, packed, skip=skip).float()
        torch.cuda.synchronize()
        errs[name] = _mbconv_check(name, x, args, skip, got, want, plan)
        if mode == "packed":
            del got, want
            continue
        # another plan: the first candidate whose tile or warps differ from the planner's
        other = next(q for q in fm.fused_mbconv_plans(b, h, w, cin, ce, cout, expand)
                     if (q.tile_h, q.tile_w, q.warps) != (plan.tile_h, plan.tile_w, plan.warps))
        out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device=dev)
        fm.launch_fused_mbconv(x, packed, other, out, skip, True)
        torch.cuda.synchronize()
        errs[name + ", another plan"] = _mbconv_check(name + ", another plan", x, args, skip, out.float(), want, other)
        del got, want, out
    return errs


def phase_kernels_nms():
    """sigmoid_pseudo_nms_fused (CUDA) against its plain version on the card,
    bit for bit. Returns the largest error seen (0 or the run fails)."""
    from tpucenterface_torch.decode.fused_nms import NMS_TILE, sigmoid_pseudo_nms_fused, sigmoid_pseudo_nms_plain

    gen = torch.Generator().manual_seed(99)
    # the serving phase's landmark engine launches rungs of 8 and 2 at 640
    cases = [(f"3*randn {shape}", 3.0 * torch.randn(*shape, generator=gen))
             for shape in ((32, 160, 160), (1, 256, 256), (3, 33, 65), (8, 160, 160), (2, 160, 160))]
    cases.append(("constant map (2, 40, 40)", torch.full((2, 40, 40), 0.25)))
    cases = [(name, hm.cuda()) for name, hm in cases]
    # the head's own layout: channel 0 of a (B, H, W, 5) map, read through strides
    cases.append(("strided slice (4, 80, 80)", (3.0 * torch.randn(4, 80, 80, 5, generator=gen)).cuda()[..., 0]))
    # plateaus across the kernel's tile seams (NMS_TILE): an equal block over a
    # row seam and a column seam, another on a corner of four tiles, and a peak
    # on such a corner (tests/test_torch_nms.py holds the tiling to the plain
    # version on the same map)
    th, tw = NMS_TILE
    seams = torch.full((2, 3 * th, 3 * tw), -1.0)
    seams[0, th - 2 : th + 3, tw - 2 : tw + 3] = 2.0
    seams[1, th - 1 : th + 1, tw - 1 : tw + 1] = 2.0
    seams[1, 2 * th, 2 * tw] = 3.0
    cases.append((f"plateaus across tile seams {tuple(seams.shape)}", seams.cuda()))
    worst = 0.0
    for name, hm in cases:
        got, want = sigmoid_pseudo_nms_fused(hm), sigmoid_pseudo_nms_plain(hm)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        log(f"[kernels] nms {name}: bit-equal {torch.equal(got, want)}, {(got > 0).sum().item()} peaks")
        if not torch.equal(got, want):
            raise AssertionError(f"[kernels] nms {name}: differs from the plain version, max |err| {err}")
        if "constant" in name and not (got == torch.sigmoid(hm)).all():
            raise AssertionError("[kernels] nms: a plateau lost cells")
        if "seams" in name and not ((got[0, th - 2 : th + 3, tw - 2 : tw + 3] > 0).all()
                                    and (got[1, th - 1 : th + 1, tw - 1 : tw + 1] > 0).all() and got[1, 2 * th, 2 * tw] > 0):
            raise AssertionError("[kernels] nms: a plateau across a tile seam lost cells")
        worst = max(worst, err)
    return worst


def planar_chain_inputs(det, x, size, runs):
    """[{first, count, x (planar bf16, garbage in the pad columns), H, W,
    blocks, modules, size}] for `runs` [(first block, number of blocks)]: the
    activations the flagship network gives each run on the normalized batch
    `x` (a `size` input), the run's own weights as a chain's block list, and
    the port's modules of the same blocks."""
    from tpucenterface_torch.ops.planar_mbconv import padded_width, planar_from_nhwc
    from tpucenterface_torch.weights.convert import chain_blocks_from_run

    bb = det.model.backbone
    params = det.variables["params"]["backbone"]
    starts = dict(runs)
    gen = torch.Generator().manual_seed(size)
    out = []
    with torch.inference_mode():
        y = bb.stem(x.permute(0, 3, 1, 2).to(bb.dtype))
        for i in range(len(bb.plan)):
            if i in starts:
                b, c, h, w = y.shape
                wp = padded_width(h, w)
                yp = planar_from_nhwc(y.permute(0, 2, 3, 1)).reshape(b, c, h, wp).clone()
                # finite garbage where the contract allows anything finite
                yp[..., w:] = (40.0 * torch.randn(b, c, h, wp - w, generator=gen)).to(y.device, y.dtype)
                blocks = chain_blocks_from_run([params[f"block_{j}"] for j in range(i, i + starts[i])], c)
                blocks = [{k: torch.from_numpy(v).to(y.device) if isinstance(v, np.ndarray) else v
                           for k, v in blk.items()} for blk in blocks]
                out.append({"first": i, "count": starts[i], "x": yp.reshape(b, c, h * wp).contiguous(), "H": h, "W": w,
                            "blocks": blocks, "modules": [getattr(bb, f"block_{j}") for j in range(i, i + starts[i])],
                            "size": size})
            y = getattr(bb, f"block_{i}")(y)
    if len(out) != len(starts):
        raise AssertionError(f"[kernels] planar: {len(out)} chains found at {size}, wanted {len(starts)}")
    return out


def _random_planar_chain(gen, b, h, w, c0, spec, dev, b1_shift_at=None, w2_scale=2.0):
    """(planar bf16 input with garbage pad columns, blocks) on random weights;
    `spec` lists (Ce, Cout) per block: no expand where Ce equals the block's
    input width, a skip where Cout does; w2 is `w2_scale` * Ce^-0.5 * randn."""
    from tpucenterface_torch.ops.planar_mbconv import padded_width

    def rnd(*shape, scale, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    wp = padded_width(h, w)
    x = rnd(b, c0, h, wp, scale=0.5)
    x[..., w:] *= 80.0
    blocks, c = [], c0
    for i, (ce, cout) in enumerate(spec):
        expand = ce != c
        blocks.append({
            "w1": rnd(c, ce, scale=0.3) if expand else None,
            "b1": rnd(ce, scale=0.1, shift=3.0 if i == b1_shift_at else 0.0) if expand else None,
            "wd": rnd(3, 3, ce, scale=0.3), "bd": rnd(ce, scale=0.1),
            "w2": rnd(ce, cout, scale=w2_scale * ce ** -0.5), "b2": rnd(cout, scale=0.1), "skip": c == cout,
        })
        c = cout
    return x.reshape(b, c0, h * wp).to(torch.bfloat16).contiguous(), blocks


_BLOCK_KEYS = ("w1", "b1", "wd", "bd", "w2", "b2")


def _planar_compare(what, got, want, h, w, steps=1, max_differing=PLANAR_MAX_DIFFERING):
    """Real columns of two planar tensors within `steps` bfloat16 steps
    (PLANAR_ATOL, PLANAR_RTOL times `steps`), pad columns of `got` zero.
    Returns (max |err|, share of values differing)."""
    from tpucenterface_torch.ops.planar_mbconv import nhwc_from_planar, padded_width

    g, r = nhwc_from_planar(got, h, w).float(), nhwc_from_planar(want, h, w).float()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"[kernels] {what}: non-finite output")
    if (got.reshape(got.shape[0], got.shape[1], h, padded_width(h, w))[..., w:] != 0).any():
        raise AssertionError(f"[kernels] {what}: pad columns of the output are not zero")
    diff = (g - r).abs()
    err, differing = diff.max().item(), (diff > 0).float().mean().item()
    over = (diff > steps * (PLANAR_ATOL + PLANAR_RTOL * r.abs())).sum().item()
    if over or differing > max_differing:
        raise AssertionError(f"[kernels] {what}: {over} values over {steps} x (atol {PLANAR_ATOL} + rtol "
                             f"{PLANAR_RTOL:.4f}), {differing:.3g} of the values differing")
    return err, differing


def _check_planar_chain(what, x, blocks, h, w, relu6=True):
    """planar_mbconv_chain against its plain version: block by block (the
    kernel's chain of k blocks against the plain block on the kernel's chain
    of k-1) and end to end; one launch a call. Returns the end-to-end error."""
    from tpucenterface_torch.ops.planar_mbconv import planar_mbconv_chain, planar_mbconv_chain_plain

    n = len(blocks)
    before = planar_mbconv_chain.launches
    got = planar_mbconv_chain(x, blocks, H=h, W=w, relu6=relu6)
    torch.cuda.synchronize()
    if planar_mbconv_chain.launches != before + 1:
        raise AssertionError(f"[kernels] {what}: {planar_mbconv_chain.launches - before} launches for one call")
    want = planar_mbconv_chain_plain(x, blocks, H=h, W=w, relu6=relu6)
    err, differing = _planar_compare(f"planar chain {what}", got, want, h, w, steps=n,
                                     max_differing=PLANAR_MAX_DIFFERING if n == 1 else PLANAR_CHAIN_MAX_DIFFERING)
    worst_step, prev = (0.0, 0.0), x
    for k in range(1, n + 1):
        cur = got if k == n else planar_mbconv_chain(x, blocks[:k], H=h, W=w, relu6=relu6)
        ref = planar_mbconv_chain_plain(prev, blocks[k - 1:k], H=h, W=w, relu6=relu6)
        worst_step = max(worst_step, _planar_compare(f"planar chain {what}, block {k} of {n}", cur, ref, h, w))
        prev = cur
    widths = "->".join([str(x.shape[1])] + [str(blk["w2"].shape[-1]) for blk in blocks])
    log(f"[kernels] planar chain {what}: x {tuple(x.shape)} {h}x{w}, {n} blocks {widths}: block by block max |err| "
        f"{worst_step[0]:.3g}, differing {worst_step[1]:.2e} of values; end to end max |err| {err:.3g} "
        f"(max |out| {want.float().abs().max().item():.3g}), differing {differing:.2e}")
    return err


def _planar_block_plan(x, packed, h, w):
    """The plan planar_mbconv launches for `x` and one packed block."""
    from tpucenterface_torch.ops.planar_mbconv import plan_planar_mbconv

    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return plan_planar_mbconv(packed.shapes[0], x.shape[0], h, w, sms, skip=packed.skips[0])


def _check_planar_block(what, x, blk, h, w, relu6=True):
    """planar_mbconv against its plain version, on the planner's plan (the
    packed block and the six weights both, equal). Returns the error."""
    from tpucenterface_torch.ops.planar_mbconv import pack_planar_chain, planar_mbconv, planar_mbconv_plain

    args = [blk[k] for k in _BLOCK_KEYS]
    got = planar_mbconv(x, *args, H=h, W=w, skip=blk["skip"], relu6=relu6)
    torch.cuda.synchronize()
    want = planar_mbconv_plain(x, *args, H=h, W=w, skip=blk["skip"], relu6=relu6)
    err, differing = _planar_compare(f"planar block {what}", got, want, h, w)
    packed = pack_planar_chain([blk], x.shape[1], x.device)
    if not torch.equal(planar_mbconv(x, packed, H=h, W=w, relu6=relu6), got):
        raise AssertionError(f"[kernels] planar block {what}: packed and unpacked weights give different results")
    log(f"[kernels] planar block {what}: x {tuple(x.shape)} {h}x{w} {x.shape[1]}->{blk['wd'].shape[-1]}->"
        f"{blk['w2'].shape[-1]} skip={blk['skip']}, plan {_planar_block_plan(x, packed, h, w).describe()}: max |err| "
        f"{err:.3g} (max |out| {want.float().abs().max().item():.3g}), differing {differing:.2e} of values")
    return err


def phase_kernels_planar(chains, singles):
    """planar_mbconv (B4a) and planar_mbconv_chain (B4b) against their plain
    versions on the card, at batch 32 on the flagship's own activations and
    weights (garbage in the pad columns): B4b on every chain of the planar
    engine at 640 and 320 (`chains`), B4a, which is on no path, on blocks 0
    and 2 of a 640 input (`singles`) and on each chain's first block; and random cases: no expand,
    b1 = +3, H != W, odd channel counts, a chain of one, batch 1, ReLU, and
    B4b at every shape of B4B_KERNEL_SHAPES. Returns ({case: max |err|} of
    B4a, of B4b)."""
    dev = chains[0]["x"].device
    one, many = {}, {}
    for ch in chains:
        what = f"blocks {ch['first']}-{ch['first'] + ch['count'] - 1} bs32@{ch['size']}"
        many[what] = _check_planar_chain(what, ch["x"], ch["blocks"], ch["H"], ch["W"])
    for ch in singles + chains:
        what = f"block {ch['first']} bs32@{ch['size']}"
        one[what] = _check_planar_block(what, ch["x"], ch["blocks"][0], ch["H"], ch["W"])
    gen = torch.Generator().manual_seed(2468)
    for what, b, h, w, c0, spec, shift, relu6, w2_scale in B4B_KERNEL_SHAPES:
        x, blocks = _random_planar_chain(gen, b, h, w, c0, spec, dev, b1_shift_at=shift, w2_scale=w2_scale)
        many[what] = _check_planar_chain(what, x, blocks, h, w, relu6=relu6)
    for what, b, h, w, c0, spec, shift, relu6 in PLANAR_BLOCK_SHAPES:
        x, blocks = _random_planar_chain(gen, b, h, w, c0, spec, dev, b1_shift_at=shift)
        one[what] = _check_planar_block(what, x, blocks[0], h, w, relu6=relu6)
    return one, many


# --------------------------------------------------------------------------- #
# the quantized path: detectors, the int8 kernels' inputs, their checks
# --------------------------------------------------------------------------- #


def quant_detectors(cfg):
    """The flagship quantized at int8_dw, calibrated on eight painted 640
    frames (library route), and the same scales installed on the B7 route and
    at 320 on the card and on the CPU. Returns ({route[+320[cpu]]: Detector},
    scales)."""
    from tpucenterface_torch import Detector, DetectorConfig

    calib, _ = paint_batch(QUANT_CALIB_SEED, QUANT_CALIB_FRAMES, (640, 640))
    at320 = DetectorConfig(decode=cfg.decode, default_size=320)
    dets = {"library": Detector.from_safetensors(FLAGSHIP, cfg)}
    t0 = time.perf_counter()
    scales = dets["library"].quantize(calib_images=calib, int8_dw=True)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    for route, fused in (("library", False), ("b7", True)):
        if route not in dets:
            dets[route] = Detector.from_safetensors(FLAGSHIP, cfg)
            dets[route].quantize(scales=scales, fused_blocks=fused)
        for suffix, dev in (("320", None), ("320cpu", "cpu")):
            dets[route + suffix] = Detector.from_safetensors(FLAGSHIP, at320, device=dev)
            dets[route + suffix].quantize(scales=scales, fused_blocks=fused)
    per_channel = sum(isinstance(v, np.ndarray) for v in scales.values())
    log(f"[quant] int8_dw calibrated on {QUANT_CALIB_FRAMES} painted 640 frames in {calib_s:.2f} s: "
        f"{len(scales)} entries, {per_channel} per-channel; B7 route blocks {dets['b7']._quant.fused_block_indices()}")
    if dets["b7"]._quant.fused_block_indices() != QUANT_S1_BLOCKS:
        raise AssertionError("[quant] the B7 route does not take the ten stride-1 residual blocks")
    return dets, scales


def quant_kernel_inputs(eng, x):
    """The int8 kernels' inputs and operands at the flagship's quantized
    weights and calibrated scales, on the activations the library route gives
    the normalized batch `x`: B5 at block 0's project (its int8 depthwise
    output, planar) requantized to block 1's expand scale; B6 at each
    stride-2 block (its bf16 input quantized at its expand scale, NHWC); B7
    at each stride-1 residual block (its bf16 input); B6's and B7's operands
    also packed. Also the NHWC inputs the library route times take."""
    from tpucenterface_torch.ops.int8_block import nhwc_to_planar, pack_int8_block_s1
    from tpucenterface_torch.weights.convert import int8_block_args, int8_conv_args

    dev = x.device

    def on(args):
        return {k: float(v) if k == "inv_se" else torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in args.items()}

    ys = {}
    with torch.inference_mode():
        y = eng._conv("stem", "quant", x, "relu6")
        for i in range(max(QUANT_S1_BLOCKS + QUANT_S2_BLOCKS) + 1):
            ys[i] = y
            y = eng.run_block(i, y)
        b0_dw = eng._conv("b0.dw", "quant", ys[0], "relu6", out_int8_tag="b0.project")
        b6 = {}
        for i in QUANT_S2_BLOCKS:
            sx = torch.tensor(eng.input_scale(f"b{i}.expand"), device=dev)
            xq = torch.round(ys[i].float() / sx).clamp_(-127, 127).to(torch.int8)
            a = on(int8_block_args(eng, i))
            b6[i] = (xq, a, pack_int8_block_s1(**a))
    return {
        "b5": (nhwc_to_planar(b0_dw), on(int8_conv_args(eng, 0, "b1.expand"))),
        "b5_nhwc": b0_dw,
        "b6": b6,
        "b7": {i: (ys[i], a, pack_int8_block_s1(**{k: v for k, v in a.items() if k != "inv_se"}))
               for i, a in ((i, on(int8_block_args(eng, i))) for i in QUANT_S1_BLOCKS)},
        "ys": ys,
    }


def _int8_block_ops(gen, cin, cmid, cout, dev, tie):
    """Random block operands, or tie-heavy ones: small integer weights,
    power-of-two scales and zero biases, so the scaled values land on .5."""
    def ints(*shape, lo=-127, hi=128):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int8).to(dev)

    def rand(n, a, b=0.0):
        return (torch.rand(n, generator=gen) * a + b).to(dev)

    def full(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    if tie:
        return {"we": ints(cmid, cin, lo=-3, hi=4), "e_scale": full(cmid, 2.0 ** -6), "e_bias": full(cmid, 0.0),
                "e_inv_sdw": full(cmid, 32.0), "wd": ints(9, cmid, lo=-3, hi=4).float(),
                "d_scale": full(cmid, 2.0 ** -8), "d_bias": full(cmid, 0.0), "d_inv_sproj": full(cmid, 128.0),
                "wp": ints(cout, cmid, lo=-3, hi=4), "p_scale": full(cout, 0.5), "p_bias": full(cout, 0.0)}
    return {"we": ints(cmid, cin), "e_scale": rand(cmid, 2e-4, 1e-4), "e_bias": rand(cmid, 0.5),
            "e_inv_sdw": rand(cmid, 40, 20), "wd": ints(9, cmid).float(), "d_scale": rand(cmid, 2e-4, 1e-4),
            "d_bias": rand(cmid, 0.5), "d_inv_sproj": rand(cmid, 40, 20), "wp": ints(cout, cmid),
            "p_scale": rand(cout, 2e-4, 1e-4), "p_bias": rand(cout, 0.5)}


def _int8_conv_operands(gen, b, cin, p, cout, kind, dev):
    """x, w, scale and bias of B5 on `dev`: random, tie-heavy (small
    integers, scale and bias 0.5, so half the values land on .5) or extreme
    (all +-127, the largest sums at two pixels, scales that keep them off
    the clip)."""
    if kind == "ties":
        x = torch.randint(-3, 4, (b, cin, p), generator=gen, dtype=torch.int8)
        w = torch.randint(-3, 4, (cout, cin), generator=gen, dtype=torch.int8)
        sc = bi = torch.full((cout,), 0.5)
    elif kind == "extreme":   # pixels 0 and 1 at the largest sums, +-127^2 Cin, of channel 0
        x = (torch.randint(0, 2, (b, cin, p), generator=gen) * 254 - 127).to(torch.int8)
        w = (torch.randint(0, 2, (cout, cin), generator=gen) * 254 - 127).to(torch.int8)
        x[:, :, 0], x[:, :, 1] = w[0], -w[0]
        sc = (0.5 + 0.5 * torch.rand(cout, generator=gen)) / (127 * cin)
        bi = torch.rand(cout, generator=gen) - 0.5
    else:
        x = torch.randint(-127, 128, (b, cin, p), generator=gen, dtype=torch.int8)
        w = torch.randint(-127, 128, (cout, cin), generator=gen, dtype=torch.int8)
        sc = torch.rand(cout, generator=gen) * 1e-3 * min(1.0, (32 / cin) ** 0.5)   # most sums off the clip
        bi = torch.rand(cout, generator=gen) * 4 - 2
    return x.to(dev), w.to(dev), sc.to(dev), bi.to(dev)


def _check_bit_equal(what, got, want):
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        n = (got != want).sum().item() if got.shape == want.shape else f"shape {tuple(got.shape)}"
        raise AssertionError(f"[kernels] {what}: differs from the plain version ({n})")
    log(f"[kernels] {what}: bit-equal to the plain version, out {tuple(got.shape)} {got.dtype}")


def phase_kernels_int8(inputs):
    """B5 (int8_conv1x1), B6 (int8_block_s2) and B7 (int8_block_s1) against
    their plain versions on the card, bit for bit: at the flagship's quantized
    weights and calibrated scales at bs32@640 (`quant_kernel_inputs`), on
    ragged maps with random operands, and on tie-heavy operands. Returns
    {kernel: max |err|} (0 or the run fails)."""
    from tpucenterface_torch.ops.int8_block import (
        fused_block_int8_plain, fused_block_s1_plain, int8_block_s1, int8_block_s2, pack_int8_block_s1,
        plan_int8_block_s1, plan_int8_block_s2,
    )
    from tpucenterface_torch.ops.int8_conv import (
        VARIANT_REGS, conv1x1_int8_plain, int8_conv1x1, plan_int8_conv1x1, variant_attributes,
    )

    # B5's planner sizes its persistent grid by the registers of each compiled
    # variant: the card's kernels must hold no more than its table says, and spill nothing
    for variant, regs in VARIANT_REGS.items():
        for magic, want in zip((True, False), regs):
            got, local = variant_attributes(variant, magic)
            if got > want or local:
                raise AssertionError(f"[kernels] B5 variant {variant} ({'magic' if magic else 'cvt'}) holds {got} "
                                     f"registers and {local} B of local memory a thread; the planner counts {want}")
    x, a = inputs["b5"]
    dev = x.device
    _check_bit_equal(f"int8_conv1x1 block 0 project, requantized to b1.expand, bs32@640 "
                     f"({plan_int8_conv1x1(*x.shape, a['w'].shape[0]).describe()})",
                     int8_conv1x1(x, **a), conv1x1_int8_plain(x, **a))
    for i, (x, a, packed) in inputs["b6"].items():
        plan = plan_int8_block_s2(*x.shape, packed.cmid, packed.cout)
        _check_bit_equal(f"int8_block_s2 block {i} bs32@640 ({plan.describe()})", int8_block_s2(x, packed),
                         fused_block_int8_plain(x, **a))
    for i, (x, a, packed) in inputs["b7"].items():
        _check_bit_equal(f"int8_block_s1 block {i} bs32@640", int8_block_s1(x, a["inv_se"], packed),
                         fused_block_s1_plain(x, **a))
    gen = torch.Generator().manual_seed(8642)
    # the first three shapes draw from the generator that B6's and B7's shapes
    # go on from, as they did before the list grew; the others from their own
    more = torch.Generator().manual_seed(8643)
    for i, (what, (b, cin, p, cout), kind) in enumerate(B5_KERNEL_SHAPES):
        x, w, sc, bi = _int8_conv_operands(gen if i < 3 else more, b, cin, p, cout, kind, dev)
        plan = plan_int8_conv1x1(b, cin, p, cout)
        _check_bit_equal(f"int8_conv1x1 {what} ({plan.describe()})", int8_conv1x1(x, w, sc, bi),
                         conv1x1_int8_plain(x, w, sc, bi))
    for what, (b, h, w, cin, cmid, cout), tie in B6_KERNEL_SHAPES:
        ops = _int8_block_ops(gen, cin, cmid, cout, dev, tie)
        lo, hi = (-3, 4) if tie else (-127, 128)
        x = torch.randint(lo, hi, (b, h, w, cin), generator=gen, dtype=torch.int8).to(dev)
        plan = plan_int8_block_s2(b, h, w, cin, cmid, cout)
        _check_bit_equal(f"int8_block_s2 {what} ({plan.describe()})", int8_block_s2(x, pack_int8_block_s1(**ops)),
                         fused_block_int8_plain(x, **ops))
    for what, (b, h, w, cin, cmid, cout), tie, residual in B7_KERNEL_SHAPES:
        ops = _int8_block_ops(gen, cin, cmid, cout, dev, tie)
        if tie:  # odd integers times 0.5
            x = torch.randint(-7, 8, (b, h, w, cin), generator=gen).float().to(dev, torch.bfloat16)
            inv_se = 0.5
        else:
            x = (2.0 * torch.randn(b, h, w, cin, generator=gen)).to(dev, torch.bfloat16)
            inv_se = 37.5
        plan = plan_int8_block_s1(b, h, w, cin, cmid, cout)
        _check_bit_equal(f"int8_block_s1 {what} (tile {plan.tile_h}x{plan.tile_w}, CK {plan.ck}, {plan.warps} warps)",
                         int8_block_s1(x, inv_se, pack_int8_block_s1(**ops), residual=residual),
                         fused_block_s1_plain(x, inv_se, **ops, residual=residual))
    return {"int8_conv1x1": 0.0, "int8_block_s2": 0.0, "int8_block_s1": 0.0}


def count_unmatched(a_dets, b_dets, firm=BF16_FIRM):
    """(detections of either side scoring >= `firm`, those of them with no
    partner on the other side within BF16_BOX_ATOL px, box corners and
    landmark points where both sides have them, and BF16_SCORE_ATOL)."""
    n = bad = 0
    for x, y in zip(a_dets, b_dets):
        for a, b in ((x, y), (y, x)):
            sel = a.scores >= firm
            n += int(sel.sum())
            if not sel.any():
                continue
            if not len(b.scores):
                bad += int(sel.sum())
                continue
            dist = np.abs(a.boxes[sel][:, None, :] - b.boxes[None, :, :]).max(axis=-1)
            if a.landmarks is not None and b.landmarks is not None:
                dist = np.maximum(dist, np.abs(a.landmarks[sel][:, None] - b.landmarks[None]).max(axis=(-2, -1)))
            close = np.abs(a.scores[sel][:, None] - b.scores[None, :]) <= BF16_SCORE_ATOL
            bad += int((~((dist <= BF16_BOX_ATOL) & close).any(axis=1)).sum())
    return n, bad


def check_result(dets, gts, hws, what):
    """Finite, in bounds, and the painted faces found (IoU >= 0.5, score
    >= 0.3) for at least 90% of them."""
    found = total = 0
    for d, g, (h, w) in zip(dets, gts, hws):
        if not (np.isfinite(d.boxes).all() and np.isfinite(d.scores).all()):
            raise AssertionError(f"[main] {what}: non-finite output")
        if d.boxes.shape != (len(d.scores), 4) or (np.diff(d.scores) > 0).any():
            raise AssertionError(f"[main] {what}: bad shapes or unsorted scores")
        if (d.boxes < 0).any() or (d.boxes[:, 0::2] > w).any() or (d.boxes[:, 1::2] > h).any():
            raise AssertionError(f"[main] {what}: boxes outside the {h}x{w} image")
        strong = d.boxes[d.scores >= 0.3]
        total += len(g)
        if len(g) and len(strong):
            found += int((iou(g, strong).max(axis=1) >= 0.5).sum())
    log(f"[main] {what}: {found}/{total} painted faces found (IoU>=0.5, score>=0.3)")
    if found < 0.9 * total:
        raise AssertionError(f"[main] {what}: only {found} of {total} faces found")


def kernel_wrappers():
    from tpucenterface_torch.decode.fused_decode import decode_feats_fused
    from tpucenterface_torch.decode.fused_nms import sigmoid_pseudo_nms_fused
    from tpucenterface_torch.ops.fused_mbconv import fused_mbconv
    from tpucenterface_torch.ops.int8_block import int8_block_s1, int8_block_s2
    from tpucenterface_torch.ops.int8_conv import int8_conv1x1
    from tpucenterface_torch.ops.planar_mbconv import planar_mbconv, planar_mbconv_chain

    return {"decode_feats_fused": decode_feats_fused, "fused_mbconv": fused_mbconv,
            "sigmoid_pseudo_nms_fused": sigmoid_pseudo_nms_fused,
            "planar_mbconv": planar_mbconv, "planar_mbconv_chain": planar_mbconv_chain,
            "int8_conv1x1": int8_conv1x1, "int8_block_s2": int8_block_s2, "int8_block_s1": int8_block_s1}


def zero_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches():
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def launch_counts(**launched):
    """The counts of every wrapper: those named, 0 for the others."""
    return {name: launched.get(name, 0) for name in kernel_wrappers()}


def phase_main(det, det320, det_cpu):
    """The detect path with the module forward and the fused decode, with
    every launch counter set to 0 just before and read just after. Returns
    the launch counts and the bs32@640 detections."""
    b640, g640 = paint_batch(1, 32, (640, 640))
    lb_imgs, lb_gts, lb_hws = letterboxed_batch(2)
    odd = [paint_scene(np.random.RandomState(3), (480, 720), 3), paint_scene(np.random.RandomState(4), (123, 457), 1)]
    s320, g320 = paint_batch(5, 4, (384, 512))

    zero_launches()
    calls = 0
    d640 = det.detect_batch(b640, score_thresh=0.05)
    calls += 1
    dlb = det.detect_batch(lb_imgs, hws=lb_hws, score_thresh=0.05)
    calls += 1
    dodd = [det.detect(img, score_thresh=0.05) for img, _ in odd]
    calls += len(odd)
    d320 = det320.detect_batch(s320, score_thresh=0.05)
    calls += 1
    launches = read_launches()
    log(f"[main] module forward: decode calls {calls}, kernel launches {launches}")
    if launches != launch_counts(decode_feats_fused=calls):
        raise AssertionError(f"[main] module forward: launches {launches} for {calls} decode calls")

    check_result(d640, g640, [(640, 640)] * 32, "detect_batch bs32 640x640")
    check_result(dlb, lb_gts, lb_hws, "detect_batch bs32 letterboxed to 640")
    check_result(dodd, [g for _, g in odd], [img.shape[:2] for img, _ in odd], "detect 480x720 and 123x457")
    check_result(d320, g320, [(384, 512)] * 4, "detect_batch bs4 at 320")
    ref = det_cpu.detect_batch(s320, score_thresh=0.05)
    n, bad = count_unmatched(d320, ref)
    log(f"[main] 320: card and CPU, detections >= {BF16_FIRM} of either without a partner within "
        f"{BF16_BOX_ATOL} px and {BF16_SCORE_ATOL} on the other: {bad} of {n}")
    if bad or not n:
        raise AssertionError(f"[main] 320: card and CPU differ on {bad} of {n} detections")
    return launches, d640


def phase_main_fast(det_fast, det_fast320, det_f32, d640_module, x, module_feats):
    """The detect path through FastEngine and the fused MBConv kernel: bs32 @
    640 on the batch of `phase_main`, whose module-forward detections
    `d640_module` it must agree with (see FAST_MATCH_SHARE), and bs4 at 320.
    `x` is a normalized bs32@640 batch and `module_feats` the module
    forward's head maps of it. Returns the launch counts."""
    b640, g640 = paint_batch(1, 32, (640, 640))
    s320, g320 = paint_batch(5, 4, (384, 512))
    at640 = len(det_fast._engine.kernel_blocks(640))
    at320 = len(det_fast320._engine.kernel_blocks(320))
    if (at640, at320) != (sum(MBCONV_BLOCKS_640.values()), 4):
        raise AssertionError(f"[main] fast engine: {at640} kernel blocks at 640 and {at320} at 320")

    zero_launches()
    d640 = det_fast.detect_batch(b640, score_thresh=0.05)
    after640 = read_launches()
    d320 = det_fast320.detect_batch(s320, score_thresh=0.05)
    launches = read_launches()
    log(f"[main] fast engine: one forward at 640 {after640}, then one at 320 {launches}")
    want = launch_counts(decode_feats_fused=2, fused_mbconv=at640 + at320)
    if after640["fused_mbconv"] != at640 or launches != want:
        raise AssertionError(f"[main] fast engine: launches {after640}, {launches}; wanted {want}")

    check_result(d640, g640, [(640, 640)] * 32, "fast engine detect_batch bs32 640x640")
    check_result(d320, g320, [(384, 512)] * 4, "fast engine detect_batch bs4 at 320")
    # the counts are read; what follows compares and launches outside the count
    d640_f32 = det_f32.detect_batch(b640, score_thresh=0.05)
    with torch.inference_mode():
        hm_fast, hm_f32 = det_fast._forward(x)["hm"], det_f32._forward(x)["hm"]
    hm_err = {"fast": (hm_fast - hm_f32).abs().mean().item(),
              "module": (module_feats["hm"] - hm_f32).abs().mean().item()}
    n, bad = count_unmatched(d640, d640_module)
    n_fast, bad_fast = count_unmatched(d640, d640_f32)
    n_mod, bad_mod = count_unmatched(d640_module, d640_f32)
    log(f"[main] fast engine bs32@640, detections >= {BF16_FIRM} without a partner within {BF16_BOX_ATOL} px and "
        f"{BF16_SCORE_ATOL} (both ways): fast/module {bad} of {n}, fast/float32 {bad_fast} of {n_fast}, "
        f"module/float32 {bad_mod} of {n_mod}; mean |hm - float32 hm|: fast {hm_err['fast']:.4g}, "
        f"module {hm_err['module']:.4g}")
    if n < 100 or bad > (1.0 - FAST_MATCH_SHARE) * n:
        raise AssertionError(f"[main] fast engine: {bad} of {n} detections differ from the module forward's")
    if bad_fast > bad_mod + FAST_F32_SLACK or hm_err["fast"] > FAST_F32_HM_RATIO * hm_err["module"]:
        raise AssertionError("[main] fast engine: further from the float32 forward than the module forward is")
    return launches


def phase_main_landmarks():
    """A landmark model (random weights from a seed) at bs4 @ 320: with
    `use_pallas` the decode's dense stage runs the fused sigmoid + pseudo-NMS
    kernel, and boxes, scores and landmarks are bit-equal to the reference
    decode's. Returns the launch counts."""
    from tpucenterface_torch import DecodeConfig, Detector, DetectorConfig, ModelConfig

    model = ModelConfig(with_landmarks=True)
    on, off = (
        Detector(config=DetectorConfig(model=model, decode=DecodeConfig(use_pallas=flag), default_size=320), seed=11)
        for flag in (True, False)
    )
    imgs, _ = paint_batch(12, 4, (320, 320))
    zero_launches()
    d_on = on.detect_batch(imgs, score_thresh=0.0)
    launches = read_launches()
    d_off = off.detect_batch(imgs, score_thresh=0.0)
    after_off = read_launches()
    log(f"[main] landmark model bs4@320: kernel launches {launches}")
    if launches != launch_counts(sigmoid_pseudo_nms_fused=1) or after_off != launches:
        raise AssertionError(f"[main] landmark model: launches {launches}, then {after_off} without the switch")
    for a, b in zip(d_on, d_off):
        if a.landmarks is None or a.landmarks.shape != (len(a.scores), 5, 2) or len(a.scores) != 200:
            raise AssertionError("[main] landmark model: bad result shapes")
        if not (np.isfinite(a.boxes).all() and np.isfinite(a.scores).all() and np.isfinite(a.landmarks).all()):
            raise AssertionError("[main] landmark model: non-finite output")
        same = (a.boxes.tobytes() == b.boxes.tobytes() and a.scores.tobytes() == b.scores.tobytes()
                and a.landmarks.tobytes() == b.landmarks.tobytes())
        if not same:
            raise AssertionError("[main] landmark model: use_pallas changes the result")
    log("[main] landmark model bs4@320: boxes, scores and landmarks bit-equal with the fused dense stage on and off")
    return launches


def phase_main_planar(det_planar, det_planar320, det_planar_cpu, det_f32, d640_module, x, module_feats):
    """Path d, the detect path through PlanarEngine and the planar chain
    kernel: bs32 @ 640 on the batch of `phase_main`, whose module-forward
    detections `d640_module` it must agree with under the fast engine's rule
    (FAST_MATCH_SHARE, the float32 forward as arbiter), and bs4 at 320 against
    the port's CPU run of the same engine. Returns the launch counts."""
    b640, g640 = paint_batch(1, 32, (640, 640))
    s320, g320 = paint_batch(5, 4, (384, 512))
    runs = {size: det._engine.chain_runs(size) for size, det in ((640, det_planar), (320, det_planar320))}
    if runs != PLANAR_CHAINS:
        raise AssertionError(f"[main] planar engine: chains {runs}, wanted {PLANAR_CHAINS}")

    zero_launches()
    d640 = det_planar.detect_batch(b640, score_thresh=0.05)
    after640 = read_launches()
    d320 = det_planar320.detect_batch(s320, score_thresh=0.05)
    launches = read_launches()
    log(f"[main] planar engine: one forward at 640 {after640}, then one at 320 {launches}")
    if (after640 != launch_counts(decode_feats_fused=1, planar_mbconv_chain=3)
            or launches != launch_counts(decode_feats_fused=2, planar_mbconv_chain=3 + 4)):
        raise AssertionError(f"[main] planar engine: launches {after640}, {launches}; wanted 3 chains at 640 and 4 at 320")

    check_result(d640, g640, [(640, 640)] * 32, "planar engine detect_batch bs32 640x640")
    check_result(d320, g320, [(384, 512)] * 4, "planar engine detect_batch bs4 at 320")
    # the counts are read; what follows compares and launches outside the count
    ref320 = det_planar_cpu.detect_batch(s320, score_thresh=0.05)
    n320, bad320 = count_unmatched(d320, ref320)
    log(f"[main] planar engine at 320: card and CPU, detections >= {BF16_FIRM} of either without a partner within "
        f"{BF16_BOX_ATOL} px and {BF16_SCORE_ATOL} on the other: {bad320} of {n320}")
    if bad320 or not n320:
        raise AssertionError(f"[main] planar engine at 320: card and CPU differ on {bad320} of {n320} detections")
    d640_f32 = det_f32.detect_batch(b640, score_thresh=0.05)
    with torch.inference_mode():
        hm_planar, hm_f32 = det_planar._forward(x)["hm"], det_f32._forward(x)["hm"]
    hm_err = {"planar": (hm_planar - hm_f32).abs().mean().item(),
              "module": (module_feats["hm"] - hm_f32).abs().mean().item()}
    n, bad = count_unmatched(d640, d640_module)
    n_pl, bad_pl = count_unmatched(d640, d640_f32)
    n_mod, bad_mod = count_unmatched(d640_module, d640_f32)
    log(f"[main] planar engine bs32@640, detections >= {BF16_FIRM} without a partner within {BF16_BOX_ATOL} px and "
        f"{BF16_SCORE_ATOL} (both ways): planar/module {bad} of {n}, planar/float32 {bad_pl} of {n_pl}, "
        f"module/float32 {bad_mod} of {n_mod}; mean |hm - float32 hm|: planar {hm_err['planar']:.4g}, "
        f"module {hm_err['module']:.4g}")
    if n < 100 or bad > (1.0 - FAST_MATCH_SHARE) * n:
        raise AssertionError(f"[main] planar engine: {bad} of {n} detections differ from the module forward's")
    if bad_pl > bad_mod + FAST_F32_SLACK or hm_err["planar"] > FAST_F32_HM_RATIO * hm_err["module"]:
        raise AssertionError("[main] planar engine: further from the float32 forward than the module forward is")

    return launches


def large_preset_detectors(cfg):
    """The `large` preset (width 1.4, Cin up to 136 at the kernel's blocks)
    with `cfg`'s decode, on random weights from a seed: its module-forward,
    fast-engine and float32 Detectors, one set of weights."""
    import dataclasses

    from tpucenterface_torch import Detector, preset
    from tpucenterface_torch.model.centernet import init_model

    large = dataclasses.replace(preset("large"), decode=cfg.decode)
    _, variables = init_model(large.model, seed=17)
    # torch's default initializer shrinks the activations about threefold a
    # conv, so that the deep blocks would see values near 0: each kernel is
    # redrawn at variance gain / fan_in (He's 2 ahead of a ReLU, 1 for the
    # linear projects), and each BatchNorm's statistics and affine drawn
    # around the identity, so every block sees values of order 1
    rng = np.random.RandomState(17)

    def redraw(params, stats, path):
        for k, v in params.items():
            if isinstance(v, dict):
                redraw(v, stats.get(k, {}) if isinstance(stats, dict) else {}, path + (k,))
            elif k == "kernel":
                gain = 1.0 if "project" in path or path[-1] == "out" else 2.0
                params[k] = rng.normal(0, np.sqrt(gain / np.prod(v.shape[:-1])), v.shape).astype(np.float32)
            elif path[-1] == "bn":
                params[k] = rng.uniform(0.7, 1.3, v.shape) if k == "scale" else rng.uniform(-0.2, 0.2, v.shape)
                params[k] = params[k].astype(np.float32)
                stats["mean"] = rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
                stats["var"] = rng.uniform(0.7, 1.3, v.shape).astype(np.float32)

    redraw(variables["params"], variables["batch_stats"], ())

    def make(**model):
        return Detector(variables=variables, config=dataclasses.replace(
            large, model=dataclasses.replace(large.model, **model)))

    return make(), make(inference_engine="fast"), make(compute_dtype="float32")


def phase_main_large(dets, imgs, x):
    """Path g, the `large` preset's fast engine (random weights): one
    `detect_batch` at bs32 @ 640 on the painted batch `imgs` with every
    launch counter set to 0 just before and read just after (B3 once a
    kernel block, B2 once), the result finite and in bounds; then its head
    map on the normalized batch `x` against the module forward's, with the
    float32 forward as arbiter (FAST_F32_HM_RATIO, as for the flagship's
    fast engine). Returns the launch counts."""
    module, fast, f32 = dets
    blocks = fast._engine.kernel_blocks(640)
    zero_launches()
    d = fast.detect_batch(imgs, score_thresh=0.0)
    launches = read_launches()
    log(f"[main] large preset, fast engine bs32@640 ({len(blocks)} kernel blocks {blocks}): launches {launches}")
    if launches != launch_counts(decode_feats_fused=1, fused_mbconv=len(blocks)):
        raise AssertionError(f"[main] large preset: launches {launches}")
    for r in d:
        if not (np.isfinite(r.boxes).all() and np.isfinite(r.scores).all()) or len(r.scores) != 200:
            raise AssertionError("[main] large preset: non-finite or short result")
        if (r.boxes < 0).any() or (r.boxes > 640).any():
            raise AssertionError("[main] large preset: boxes outside the image")
    # the counts are read; what follows compares and launches outside the count
    with torch.inference_mode():
        hm = {name: det._forward(x)["hm"].float() for name, det in (("fast", fast), ("module", module), ("f32", f32))}
    err = {name: (hm[name] - hm["f32"]).abs().mean().item() for name in ("fast", "module")}
    between = (hm["fast"] - hm["module"]).abs()
    log(f"[main] large preset bs32@640, heat-map logits: mean |fast - float32| {err['fast']:.4g}, mean |module - "
        f"float32| {err['module']:.4g}; fast against module mean {between.mean().item():.4g}, max "
        f"{between.max().item():.4g} (logits spread {hm['f32'].std().item():.4g})")
    if not torch.isfinite(hm["fast"]).all() or err["fast"] > FAST_F32_HM_RATIO * err["module"]:
        raise AssertionError("[main] large preset: the fast engine is further from the float32 forward than the "
                             "module forward is")
    return launches


def _hm_distance(det, x, ref_hm):
    """Mean |hm - ref_hm| of `det`'s forward on the normalized batch `x`."""
    with torch.inference_mode():
        return (det._forward(x)["hm"] - ref_hm).abs().mean().item()


def phase_main_quant(dets, det_module, det_f32, d640_module, x, module_feats):
    """Path e, the quantized detect path on both routes, with every launch
    counter set to 0 just before and read just after: bs32 and bs128 @ 640
    (the batch of `phase_main`, whose module-forward detections are
    `d640_module`, and a painted bs128 batch) and bs4 at 320. Each route must
    find the painted faces, match the bf16 module forward on the same card
    under QUANT_MATCH_SHARE with the float32 forward as arbiter, and match
    the port's CPU run at 320 under the same scales; the B7 route must match
    the library route under B7_MATCH_SHARE. Returns the launch counts."""
    b640, g640 = paint_batch(1, 32, (640, 640))
    b128, g128 = paint_batch(13, 128, (640, 640))
    s320, g320 = paint_batch(5, 4, (384, 512))
    runs = {}
    zero_launches()
    for route in ("library", "b7"):
        runs[route] = {"bs32": dets[route].detect_batch(b640, score_thresh=0.05),
                       "bs128": dets[route].detect_batch(b128, score_thresh=0.05),
                       "320": dets[route + "320"].detect_batch(s320, score_thresh=0.05)}
    launches = read_launches()
    log(f"[main] quantized path, both routes at bs32 and bs128 @ 640 and bs4 at 320: kernel launches {launches}")
    want = launch_counts(decode_feats_fused=6, int8_block_s1=3 * len(QUANT_S1_BLOCKS))
    if launches != want:
        raise AssertionError(f"[main] quantized path: launches {launches}; wanted {want}")
    for route, r in runs.items():
        check_result(r["bs32"], g640, [(640, 640)] * 32, f"quantized {route} route detect_batch bs32 640x640")
        check_result(r["bs128"], g128, [(640, 640)] * 128, f"quantized {route} route detect_batch bs128 640x640")
        check_result(r["320"], g320, [(384, 512)] * 4, f"quantized {route} route detect_batch bs4 at 320")

    # the counts are read; what follows compares and launches outside the count
    imgs320, _ = paint_batch(9, 4, (320, 320))
    for route, r in runs.items():
        ref = dets[route + "320cpu"].detect_batch(s320, score_thresh=0.05)
        n, bad = count_unmatched(r["320"], ref)
        card, cpu = dets[route + "320"], dets[route + "320cpu"]
        with torch.inference_mode():
            hm_card = card._forward(normalize_raw(card, imgs320, "cuda"))["hm"].cpu()
            hm_cpu = cpu._forward(normalize_raw(cpu, imgs320, "cpu"))["hm"]
        hm_diff = (hm_card - hm_cpu).abs()
        log(f"[main] quantized {route} route at 320: card and CPU under one scales dict, detections >= {BF16_FIRM} "
            f"of either without a partner within {BF16_BOX_ATOL} px and {BF16_SCORE_ATOL}: {bad} of {n}; "
            f"identity-path heat maps: max |card - CPU| {hm_diff.max().item():.3g}, differing "
            f"{(hm_diff > 0).float().mean().item():.3g} of values")
        if bad or not n:
            raise AssertionError(f"[main] quantized {route} route at 320: card and CPU differ on {bad} of {n}")

    module_dets = {"bs32": d640_module, "bs128": det_module.detect_batch(b128, score_thresh=0.05)}
    f32_dets = {"bs32": det_f32.detect_batch(b640, score_thresh=0.05),
                "bs128": det_f32.detect_batch(b128, score_thresh=0.05)}
    with torch.inference_mode():
        hm_f32 = det_f32._forward(x)["hm"]
    hm_err = {"module": (module_feats["hm"] - hm_f32).abs().mean().item(),
              **{route: _hm_distance(dets[route], x, hm_f32) for route in runs}}
    failures = []
    for bs in ("bs32", "bs128"):
        n_mod, bad_mod = count_unmatched(module_dets[bs], f32_dets[bs])
        missed = {}
        for route, r in runs.items():
            n, bad = count_unmatched(r[bs], module_dets[bs])
            n_q, missed[route] = count_unmatched(r[bs], f32_dets[bs])
            log(f"[main] quantized {route} route {bs}@640, detections >= {BF16_FIRM} without a partner within "
                f"{BF16_BOX_ATOL} px and {BF16_SCORE_ATOL} (both ways): quantized/module {bad} of {n}, "
                f"quantized/float32 {missed[route]} of {n_q}, module/float32 {bad_mod} of {n_mod}")
            if n < 100 or bad > (1.0 - QUANT_MATCH_SHARE) * n:
                failures.append(f"{route} route {bs}: {bad} of {n} detections differ from the module forward's")
            if missed[route] > (1.0 - QUANT_MATCH_SHARE) * n_q:
                failures.append(f"{route} route {bs}: {missed[route]} of {n_q} detections differ from float32's")
        n, bad = count_unmatched(runs["b7"][bs], runs["library"][bs])
        log(f"[main] quantized {bs}@640, B7 route against the library route: {bad} of {n} detections without a partner")
        if n < 100 or bad > (1.0 - B7_MATCH_SHARE) * n:
            failures.append(f"{bs}: the B7 route differs from the library route on {bad} of {n}")
        if missed["b7"] > B7_F32_SLACK * missed["library"] + FAST_F32_SLACK:
            failures.append(f"{bs}: the B7 route misses the float32 forward on {missed['b7']}, the library route on "
                            f"{missed['library']}")
    log(f"[main] quantized bs32@640 mean |hm - float32 hm|: library route {hm_err['library']:.4g}, B7 route "
        f"{hm_err['b7']:.4g}, bf16 module forward {hm_err['module']:.4g}")
    if hm_err["library"] > QUANT_F32_HM_RATIO * hm_err["module"]:
        failures.append("library route: heat map too far from the float32 forward's")
    if hm_err["b7"] > B7_F32_HM_RATIO * hm_err["library"]:
        failures.append("B7 route: heat map further from the float32 one than the library route's")
    if failures:  # every comparison is logged before any fails the run
        raise AssertionError("[main] quantized path: " + "; ".join(failures))
    return launches


def mixed_painted_set(seed, n, sides=(384, 512)):
    """`n` painted scenes of mixed sizes, each side drawn from `sides`, and
    records of their faces for the WIDER scorer (xywh boxes, none invalid)."""
    from tpucenterface_torch.data.wider import WiderImage

    rng = np.random.RandomState(seed)
    imgs, recs = [], []
    for i in range(n):
        img, g = paint_scene(rng, tuple(rng.randint(sides[0], sides[1] + 1, 2)), int(rng.randint(2, 6)))
        imgs.append(img)
        xywh = np.concatenate([g[:, :2], g[:, 2:] - g[:, :2]], axis=1)
        recs.append(WiderImage("", f"painted/{i}", xywh, np.zeros(len(g), bool)))
    return imgs, recs


def _flip_halves(det, imgs):
    """The flip program of `det` on pre-sized images (the letterbox is the
    identity, so mirroring the square mirrors the image), and the batch
    program on the images and on their mirrors: (the flip's first halves,
    the batch program's, the flip's second halves, the batch program's on
    the mirrors, un-mirrored and with the landmark pairs swapped), lists of
    Detections of every score."""
    from tpucenterface_torch import Detections

    b, h, w, _ = imgs.shape
    dev = det.device
    hws = torch.tensor([[h, w]] * b, dtype=torch.int32, device=dev)
    flip = det._batch_flip_fn(b, (h, w), w)(torch.from_numpy(imgs).to(dev), hws)
    plain = det._batch_fn(b, (h, w), w)(torch.from_numpy(imgs).to(dev), hws)
    mir = det._batch_fn(b, (h, w), w)(torch.from_numpy(np.ascontiguousarray(imgs[:, :, ::-1])).to(dev), hws)
    flip = [x.cpu().numpy() for x in flip]
    k = flip[1].shape[1] // 2
    plain = [x.cpu().numpy() for x in plain]
    mir = [x.cpu().numpy() for x in mir]
    edge = w - 1.0
    boxes = np.stack([edge - mir[0][..., 2], mir[0][..., 1], edge - mir[0][..., 0], mir[0][..., 3]], axis=-1)
    boxes = np.minimum(np.maximum(boxes, 0.0), np.array([w, h, w, h], np.float32))
    lms = None
    if len(mir) == 3:
        lms = mir[2].copy()
        lms[..., 0] = edge - lms[..., 0]
        lms = np.minimum(np.maximum(lms[:, :, list(det.config.decode.lm_flip_perm)], 0.0), np.float32([w, h]))

    def dets(arrs, i, part):
        return Detections(*(a[i, part] for a in arrs))

    first = [dets(flip, i, slice(0, k)) for i in range(b)]
    second = [dets(flip, i, slice(k, 2 * k)) for i in range(b)]
    plain = [dets(plain, i, slice(None)) for i in range(b)]
    mirrored = [Detections(boxes[i], mir[1][i], None if lms is None else lms[i]) for i in range(b)]
    return first, plain, second, mirrored


def phase_eval(det, det_fast, det_cpu, smi):
    """Path f, the eval entry point, with every launch counter set to 0 just
    before and read just after:
    - the flip program (`Detector._batch_flip_fn`, one forward of 2B images)
      on the flagship weights at bs64 @ 640 (a 128-image forward), module
      forward and fast engine, K = 200: its first half against the batch
      program on the same batch, its second half against the batch program
      on the host-mirrored batch, un-mirrored, each matched as the fast
      engine is matched against the module forward (FAST_MATCH_SHARE);
    - `eval.batch_runner.batched_detect_tta` (flip at scales 0.7 and 1.0) on
      a set of mixed-size painted scenes, against the same set through the
      port's CPU Detector: the same launch plan, the merged detections
      matched one by one (FAST_MATCH_SHARE), and the AP of each split
      (`eval.synth_eval.score_detections` against the painted faces) within
      0.005;
    - a landmark model (random weights from a seed) through one flip
      program at bs4 @ 320: the fused dense stage launched, the points
      finite, inside the image, and matched, un-mirrored and pair-swapped,
      to the batch program's on the mirrored images.
    After the counts are read, `batched_detect_tta`'s throughput on
    EVAL_RATE_IMAGES scenes of sides EVAL_RATE_SIDES, EVAL_RATE_RUNS runs.
    Returns the launch counts."""
    from tpucenterface_torch import DecodeConfig, Detector, DetectorConfig, ModelConfig
    from tpucenterface_torch.eval.batch_runner import batched_detect_tta
    from tpucenterface_torch.eval.synth_eval import score_detections

    b64, _ = paint_batch(41, 64, (640, 640))
    tta_imgs, tta_recs = mixed_painted_set(42, EVAL_TTA_IMAGES)
    model = ModelConfig(with_landmarks=True)
    lm_det = Detector(config=DetectorConfig(model=model, decode=DecodeConfig(use_pallas=True), default_size=320),
                      seed=11)
    lm_imgs, _ = paint_batch(43, 4, (320, 320))

    zero_launches()
    halves = {name: _flip_halves(d, b64) for name, d in (("module", det), ("fast", det_fast))}
    after_flip = read_launches()
    logs = ([], [])
    tta = dict(scales=(0.7, 1.0), flip=True, score_thresh=0.02)
    batched_detect_tta(det, tta_imgs, launch_log=logs[0], **tta)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = batched_detect_tta(det, tta_imgs, launch_log=logs[1], **tta)
    tta_s = time.perf_counter() - t0
    lm_halves = _flip_halves(lm_det, lm_imgs)
    launches = read_launches()

    at640 = len(det_fast._engine.kernel_blocks(640))
    want_flip = launch_counts(decode_feats_fused=6, fused_mbconv=3 * at640)
    want = launch_counts(decode_feats_fused=6 + len(logs[0]) + len(logs[1]), fused_mbconv=3 * at640,
                         sigmoid_pseudo_nms_fused=3)
    log(f"[eval] launches: flip and batch programs bs64@640 (module, fast) {after_flip}; with "
        f"batched_detect_tta x2 ({len(logs[1])} launches each) and the landmark flip bs4@320 {launches} on {smi}")
    if after_flip != want_flip or launches != want or logs[0] != logs[1]:
        raise AssertionError(f"[eval] launches {after_flip}, {launches}; wanted {want_flip}, {want}")
    for name, (first, plain, second, mirrored) in halves.items():
        n1, bad1 = count_unmatched(first, plain)
        n2, bad2 = count_unmatched(second, mirrored)
        log(f"[eval] flip program bs64@640 ({name}), detections >= {BF16_FIRM} without a partner within "
            f"{BF16_BOX_ATOL} px and {BF16_SCORE_ATOL}: first half / batch program {bad1} of {n1}, second half / "
            f"batch program on the mirrored batch {bad2} of {n2} on {smi}")
        for n, bad in ((n1, bad1), (n2, bad2)):
            if n < 100 or bad > (1.0 - FAST_MATCH_SHARE) * n:
                raise AssertionError(f"[eval] flip program ({name}): {bad} of {n} detections unmatched")

    cpu_log = []
    cpu = batched_detect_tta(det_cpu, tta_imgs, launch_log=cpu_log, **tta)
    n, bad = count_unmatched(card, cpu)
    log(f"[eval] batched_detect_tta, card against CPU: merged detections >= {BF16_FIRM} of either without a "
        f"partner within {BF16_BOX_ATOL} px and {BF16_SCORE_ATOL} on the other: {bad} of {n}")
    if n < 100 or bad > (1.0 - FAST_MATCH_SHARE) * n:
        raise AssertionError(f"[eval] batched_detect_tta: card and CPU differ on {bad} of {n} detections")
    ap = {}
    for where, dets in (("card", card), ("cpu", cpu)):
        ap[where] = score_detections([np.concatenate([d.boxes, d.scores[:, None]], 1) for d in dets], tta_recs)
    log(f"[eval] batched_detect_tta scales (0.7, 1.0) + flip on {len(tta_imgs)} painted scenes (sides 384-512): "
        f"{len(logs[1])} launches {sorted(set(logs[1]))}; AP card {json.dumps(ap['card'])}, "
        f"CPU {json.dumps(ap['cpu'])} on {smi}")
    log(f"[eval] batched_detect_tta smoke reading: {len(tta_imgs) / tta_s:.2f} images/s ({tta_s * 1e3:.1f} ms "
        f"for {len(tta_imgs)} images, module forward, after one warm-up run) on {smi}")
    if cpu_log != logs[1]:
        raise AssertionError(f"[eval] launch plans differ: card {logs[1]}, CPU {cpu_log}")
    for split in ap["cpu"]:
        if not abs(ap["card"][split] - ap["cpu"][split]) <= 0.005:
            raise AssertionError(f"[eval] AP on {split}: card {ap['card'][split]}, CPU {ap['cpu'][split]}")
    if min(ap["card"].values()) < 0.9:
        raise AssertionError(f"[eval] the painted faces are not found: AP {ap['card']}")

    first, _, second, mirrored = lm_halves
    for d in first + second:
        if d.landmarks is None or d.landmarks.shape != (len(d.scores), 5, 2) or not np.isfinite(d.landmarks).all():
            raise AssertionError("[eval] landmark flip program: bad or non-finite landmarks")
        if (d.landmarks < 0).any() or (d.landmarks > 320).any():
            raise AssertionError("[eval] landmark flip program: points outside the 320x320 image")
    n, bad = count_unmatched(second, mirrored, firm=0.0)
    log(f"[eval] landmark flip program bs4@320: mirror half's detections (boxes and points) without a partner in "
        f"the batch program's on the mirrored images, un-mirrored and pair-swapped: {bad} of {n} on {smi}")
    if n < 100 or bad > (1.0 - FAST_MATCH_SHARE) * n:
        raise AssertionError(f"[eval] landmark flip program: {bad} of {n} detections unmatched")
    eval_throughput(det, tta, smi)
    return launches


def eval_throughput(det, tta, smi):
    """`batched_detect_tta` (module forward) over EVAL_RATE_IMAGES painted
    scenes of sides EVAL_RATE_SIDES: images/s of each of EVAL_RATE_RUNS runs
    after a warm-up run, and a profile of two runs (device busy and idle
    share, top device ops)."""
    from tpucenterface_torch.eval.batch_runner import batched_detect_tta

    imgs, _ = mixed_painted_set(44, EVAL_RATE_IMAGES, EVAL_RATE_SIDES)
    plan = []
    batched_detect_tta(det, imgs, launch_log=plan, **tta)  # warm-up
    torch.cuda.synchronize()
    rates = []
    for _ in range(EVAL_RATE_RUNS):
        t0 = time.perf_counter()
        batched_detect_tta(det, imgs, **tta)
        rates.append(len(imgs) / (time.perf_counter() - t0))
    shapes = sorted({p[1] for p in plan})
    rungs = sorted({p[0] for p in plan})
    log(f"[eval] batched_detect_tta throughput, scales (0.7, 1.0) + flip, module forward, {len(imgs)} painted "
        f"scenes of sides {EVAL_RATE_SIDES[0]}-{EVAL_RATE_SIDES[1]} ({len(shapes)} padded shapes, {len(plan)} "
        f"launches a run, rungs {rungs}, sizes {sorted({p[2] for p in plan})}): images/s of {EVAL_RATE_RUNS} runs "
        f"{[round(r, 2) for r in rates]}, median {float(np.median(rates)):.2f}, min {min(rates):.2f}, "
        f"max {max(rates):.2f} on {smi}")
    prof = device_profile(lambda: batched_detect_tta(det, imgs, **tta), iters=2)
    log(f"[eval] profile of batched_detect_tta on the {len(imgs)} scenes: {json.dumps(prof)} on {smi}")


# --------------------------------------------------------------------------- #
# the serving phase: ServingEngine, ServingRouter, MultiStreamPipeline
# --------------------------------------------------------------------------- #


def serving_requests(pool, n_images, seed):
    """Requests of 1 to SERVING_MAX_REQUEST images, `n_images` in all, each a
    copy of frames of `pool` (uint8, pre-sized) in a scrambled order."""
    rng = np.random.RandomState(seed)
    reqs, o = [], 0
    while o < n_images:
        n = min(int(rng.randint(1, SERVING_MAX_REQUEST + 1)), n_images - o)
        reqs.append(pool[(np.arange(o, o + n) * 7) % len(pool)])
        o += n
    return reqs


def submit_all(eng, reqs, threads=SERVING_THREADS):
    """Submit `reqs` to `eng` from `threads` threads, each its share as fast
    as it can, and wait for every result: (results in request order, seconds
    from the first submit to the last result)."""
    futs, errors = [None] * len(reqs), []

    def client(t):
        try:
            for j in range(t, len(reqs), threads):
                futs[j] = eng.submit(reqs[j])
        except Exception as e:  # reported below
            errors.append(e)

    workers = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=SERVING_TIMEOUT_S)
    if errors or any(w.is_alive() for w in workers):
        raise AssertionError(f"[serving] submitters failed or hung: {errors}")
    results = [f.result(timeout=SERVING_TIMEOUT_S) for f in futs]
    return results, time.perf_counter() - t0


def _engine(det, **kw):
    from tpucenterface_torch.runtime.serving import ServingEngine

    size = det.config.default_size
    return ServingEngine(det, (size, size), device_batch=SERVING_BATCH, max_dets=SERVING_MAX_DETS,
                         score_thresh=0.05, **kw)


def check_engine(name, det, reqs, per_launch, smi):
    """One formatted-staging engine over `det` fed `reqs` from
    SERVING_THREADS threads, with every launch counter set to 0 just before
    and read just after: each kernel launched `per_launch` times a serving
    launch, stats() agreeing with the launches counted, every launch staged
    through pinned buffers; then each request against a direct
    `detect_batch` of its images (FAST_MATCH_SHARE of the detections >=
    BF16_FIRM matched, as the flip checks). Returns the launch counts."""
    with _engine(det) as eng:
        zero_launches()
        results, wall = submit_all(eng, reqs)
        launches = read_launches()
        st = eng.stats()
    want = launch_counts(**{k: v * st["launches"] for k, v in per_launch.items()})
    n_img = sum(len(r) for r in reqs)
    log(f"[serving] {name}: {len(reqs)} requests, {n_img} images from {SERVING_THREADS} threads in {wall:.3f} s; "
        f"stats {json.dumps(st)}; kernel launches {launches} on {smi}")
    if launches != want or st["requests"] != len(reqs) or st["images"] != n_img:
        raise AssertionError(f"[serving] {name}: launches {launches}, wanted {want}; stats {st}")
    if st["pinned_launches"] != st["launches"]:
        raise AssertionError(f"[serving] {name}: {st['pinned_launches']} of {st['launches']} launches pinned-staged")
    # the counts are read; what follows compares and launches outside the count
    direct = [d for r in reqs for d in det.detect_batch(r, score_thresh=0.05)]
    n, bad = count_unmatched([d for res in results for d in res], direct)
    log(f"[serving] {name}: detections >= {BF16_FIRM} without a partner in a direct detect_batch of the same "
        f"request within {BF16_BOX_ATOL} px and {BF16_SCORE_ATOL}: {bad} of {n}")
    if n < 100 or bad > (1.0 - FAST_MATCH_SHARE) * n:
        raise AssertionError(f"[serving] {name}: {bad} of {n} detections unmatched")
    return launches


def check_launch_syncs(det, reqs):
    """A serving launch enqueues its program without waiting for the device:
    one launch of a formatted-staging engine (assembly, pinned staging,
    program) under torch.cuda.set_sync_debug_mode("error") raises on any
    synchronising call, while the same launch through the pageable "plain"
    staging does synchronise (it waits for the work queued ahead)."""
    for staging in ("formatted", "plain"):
        with _engine(det, staging=staging) as eng:
            group = [eng._make_request(r, None) for r in reqs]
            eng._finalize(group, eng._launch_inner(group))  # build and warm the program
            group = [eng._make_request(r, None) for r in reqs]
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                res, synced = eng._launch_inner(group), False
            except RuntimeError as e:
                if "synchroniz" not in str(e):
                    raise
                res, synced = None, True
            finally:
                torch.cuda.set_sync_debug_mode(0)
            eng._finalize(group, res)
        if synced != (staging == "plain"):
            raise AssertionError(f"[serving] a {staging}-staging launch {'did' if synced else 'did not'} synchronise")
    log(f"[serving] a formatted-staging launch of {sum(len(r) for r in reqs)} images ran with no host sync "
        "(torch.cuda.set_sync_debug_mode('error')); a plain-staging one synchronised")


def check_landmark_engine(size, smi):
    """A landmark model (random weights from a seed, the fused sigmoid +
    pseudo-NMS kernel) at `size` through an engine of 8 images a launch
    ({2, 8}): a launch of each rung, one B1 launch each, against a direct
    detect_batch."""
    from tpucenterface_torch import DecodeConfig, Detector, DetectorConfig, ModelConfig
    from tpucenterface_torch.runtime.serving import ServingEngine

    lm_det = Detector(config=DetectorConfig(model=ModelConfig(with_landmarks=True),
                                            decode=DecodeConfig(use_pallas=True), default_size=size), seed=11)
    imgs, _ = paint_batch(51, 10, (size, size))
    reqs = [imgs[:8], imgs[8:]]
    eng = ServingEngine(lm_det, (size, size), device_batch=8, score_thresh=0.0)
    zero_launches()
    got = list(eng.map_stream((r, None) for r in reqs))
    launches = read_launches()
    st = eng.stats()
    log(f"[serving] landmark engine, requests of 8 and 2 images at {size}: stats {json.dumps(st)}; "
        f"kernel launches {launches} on {smi}")
    if launches != launch_counts(sigmoid_pseudo_nms_fused=2) or st["launches"] != 2 or st["pad_images"] != 0:
        raise AssertionError(f"[serving] landmark engine: launches {launches}, stats {st}")
    n, bad = count_unmatched([d for res in got for d in res],
                             [d for r in reqs for d in lm_det.detect_batch(r, score_thresh=0.0)], firm=0.0)
    log(f"[serving] landmark engine: detections (boxes and points) without a partner in a direct detect_batch: "
        f"{bad} of {n}")
    if any(d.landmarks is None or d.landmarks.shape != (len(d.scores), 5, 2) for res in got for d in res):
        raise AssertionError("[serving] landmark engine: the landmarks are lost")
    if n < 100 or bad > (1.0 - FAST_MATCH_SHARE) * n:
        raise AssertionError(f"[serving] landmark engine: {bad} of {n} detections unmatched")
    return launches


def check_int8_engine(qdet, pool, smi):
    """The int8-input engine (host table staging, the int8-input program) on
    the quantized B7-route detector against the uint8 engine on the same
    detector, both through map_stream on the same requests (two full
    launches and a ragged tail on the small rung): bit-identical detections;
    B7 ten launches and B2 one a serving launch; the native table staging
    equal to the numpy `apply_stem_lut_plain` byte for byte. Returns the counts."""
    from tpucenterface_torch import native
    from tpucenterface_torch.quant.engine import apply_stem_lut_plain

    reqs = serving_requests(pool, SERVING_INT8_IMAGES, seed=52)
    u8, i8 = _engine(qdet), _engine(qdet, int8_input=True)
    programs = []
    orig = i8._fn
    i8._fn = lambda b, **kw: (programs.append((b, kw["int8_in"])), orig(b, **kw))[1]
    zero_launches()
    ref = list(u8.map_stream((r, None) for r in reqs))
    got = list(i8.map_stream((r, None) for r in reqs))
    launches = read_launches()
    n_launch = u8.stats()["launches"] + i8.stats()["launches"]
    log(f"[serving] int8-input engine against the uint8 engine, {len(reqs)} requests, {SERVING_INT8_IMAGES} images, "
        f"launches {programs}: stats {json.dumps(i8.stats())}; kernel launches {launches} on {smi}")
    want = launch_counts(decode_feats_fused=n_launch, int8_block_s1=len(QUANT_S1_BLOCKS) * n_launch)
    if launches != want or any(not i8_in for _, i8_in in programs):
        raise AssertionError(f"[serving] int8 engines: launches {launches}, wanted {want}; programs {programs}")
    differ = sum(a.boxes.tobytes() != b.boxes.tobytes() or a.scores.tobytes() != b.scores.tobytes()
                 for ra, rb in zip(ref, got) for a, b in zip(ra, rb))
    lut = qdet.stem_input_lut()
    staged = native.stem_lut_apply(pool[:16], lut)
    same_lut = staged.tobytes() == apply_stem_lut_plain(pool[:16], lut).tobytes()
    log(f"[serving] int8-input engine: {differ} of {SERVING_INT8_IMAGES} images differ from the uint8 engine's "
        f"(bit for bit); native table staging equal to the numpy apply_stem_lut_plain: {same_lut}")
    if differ or not same_lut or sum(len(r) for r in got) != SERVING_INT8_IMAGES:
        raise AssertionError("[serving] the int8-input engine is not bit-identical to the uint8 engine")
    return launches


def _perturbed_flagship(seed):
    from tpucenterface_torch.weights.io import load_safetensors

    variables = load_safetensors(FLAGSHIP)
    rng = np.random.RandomState(seed)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "kernel":
                tree[k] = (v * (1.0 + RELOAD_NOISE * rng.standard_normal(v.shape))).astype(np.float32)

    walk(variables["params"])
    return variables


def check_router(cfg, det, smi):
    """ServingRouter on painted images of mixed sizes (each side from
    ROUTER_SIDES, so many buckets), module forward, with every launch counter
    set to 0 just before and read just after: each result against `detect`
    of its image; then the hot reload: `reload_weights` from another thread
    while a second wave is in flight; every future resolves without error,
    and a third wave, after the swap, matches a fresh Detector on the new
    weights. Returns the launch counts."""
    from tpucenterface_torch import Detector
    from tpucenterface_torch.runtime.serving import ServingRouter

    rng = np.random.RandomState(53)
    imgs = [paint_scene(rng, tuple(int(v) for v in rng.randint(ROUTER_SIDES[0], ROUTER_SIDES[1] + 1, 2)),
                        int(rng.randint(2, 5)))[0] for _ in range(ROUTER_IMAGES)]
    new_vars = _perturbed_flagship(54)
    det_r = Detector.from_safetensors(FLAGSHIP, cfg)
    errors = []

    def reload():
        try:
            det_r.reload_weights(variables=new_vars)
        except Exception as e:  # reported below
            errors.append(e)

    with ServingRouter(det_r, device_batch=ROUTER_BATCH, max_dets=SERVING_MAX_DETS, score_thresh=0.05) as router:
        zero_launches()
        first = [f.result(timeout=SERVING_TIMEOUT_S) for f in [router.submit(im) for im in imgs]]
        swapper = threading.Thread(target=reload)
        swapper.start()
        during = [router.submit(im) for _ in range(3) for im in imgs]
        swapper.join(timeout=SERVING_TIMEOUT_S)
        during = [f.result(timeout=SERVING_TIMEOUT_S) for f in during]
        after = [f.result(timeout=SERVING_TIMEOUT_S) for f in [router.submit(im) for im in imgs]]
        launches = read_launches()
        st = router.stats()
    log(f"[serving] router: {len(imgs)} images of sides {ROUTER_SIDES[0]}-{ROUTER_SIDES[1]} in "
        f"{len(st['buckets'])} buckets, three waves around a hot reload: requests {st['requests']}, launches "
        f"{st['launches']} ({st['pinned_launches']} pinned-staged), pad {st['pad_images']}; kernel launches "
        f"{launches} on {smi}")
    if errors or swapper.is_alive() or det_r.weights_version != 1:
        raise AssertionError(f"[serving] router: the hot reload failed: {errors}")
    if launches != launch_counts(decode_feats_fused=st["launches"]) or st["pinned_launches"] != st["launches"]:
        raise AssertionError(f"[serving] router: launches {launches}, stats {st}")
    for d in during:
        if not (np.isfinite(d.boxes).all() and np.isfinite(d.scores).all()) or d.boxes.shape != (len(d.scores), 4):
            raise AssertionError("[serving] router: a bad result in flight across the reload")
    fresh = Detector(variables=new_vars, config=cfg)
    checks = {"before the reload / detect": count_unmatched(first, [det.detect(im, score_thresh=0.05) for im in imgs]),
              "after the reload / a fresh Detector on the new weights":
                  count_unmatched(after, [fresh.detect(im, score_thresh=0.05) for im in imgs]),
              "after / before the reload": count_unmatched(after, first)}
    log("[serving] router, detections >= 0.1 without a partner within 2 px and 0.03: " +
        "; ".join(f"{k} {bad} of {n}" for k, (n, bad) in checks.items()))
    for key in ("before the reload / detect", "after the reload / a fresh Detector on the new weights"):
        n, bad = checks[key]
        if n < 50 or bad > (1.0 - FAST_MATCH_SHARE) * n:
            raise AssertionError(f"[serving] router {key}: {bad} of {n} unmatched")
    if checks["after / before the reload"][1] == 0:
        raise AssertionError("[serving] router: the reload changed no detection")
    return launches


def check_multistream(det_fast, smi):
    """MultiStreamPipeline on the fast engine: STREAMS streams of
    STREAM_FRAMES painted 720p frames (one (768, 1280) bucket, launches on
    the rungs of STREAMS and STREAMS // 4 images), with every launch counter
    set to 0 just before and read just after: per-stream order kept, each
    frame's detections against `detect` of it. Returns the launch counts."""
    from tpucenterface_torch.runtime.video import MultiStreamPipeline

    distinct = [paint_scene(np.random.RandomState(60 + i), STREAM_HW, 5) for i in range(2 * STREAMS)]
    streams = [[distinct[(s * 3 + f) % len(distinct)][0].copy() for f in range(STREAM_FRAMES)]
               for s in range(STREAMS)]
    pipe = MultiStreamPipeline(det_fast, n_streams=STREAMS, score_thresh=0.05)
    out = {s: [] for s in range(STREAMS)}
    errors = []

    def consume():  # in a thread of its own: the pipeline waits on futures with no timeout
        try:
            for si, frame, dets in pipe.run(streams):
                out[si].append((frame, dets))
        except Exception as e:  # reported below
            errors.append(e)

    consumer = threading.Thread(target=consume, daemon=True)
    zero_launches()
    t0 = time.perf_counter()
    consumer.start()
    consumer.join(timeout=SERVING_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if consumer.is_alive() or errors:
        raise AssertionError(f"[serving] multi-stream pipeline failed or hung: {errors}")
    launches = read_launches()
    n_kernel_blocks = len(det_fast._engine.kernel_blocks(det_fast.config.default_size))
    serving_launches = launches["decode_feats_fused"]
    log(f"[serving] multi-stream pipeline, {STREAMS} streams x {STREAM_FRAMES} frames of {STREAM_HW[1]}x"
        f"{STREAM_HW[0]}, fast engine: {serving_launches} launches in {wall:.3f} s; kernel launches {launches} on {smi}")
    if launches != launch_counts(decode_feats_fused=serving_launches, fused_mbconv=n_kernel_blocks * serving_launches):
        raise AssertionError(f"[serving] multi-stream: launches {launches}")
    for s in range(STREAMS):
        if len(out[s]) != STREAM_FRAMES or any(a is not b for (a, _), b in zip(out[s], streams[s])):
            raise AssertionError(f"[serving] multi-stream: stream {s} out of order")
    ref = {i: det_fast.detect(img, score_thresh=0.05) for i, (img, _) in enumerate(distinct)}
    got = [d for s in range(STREAMS) for _, d in out[s]]
    want = [ref[(s * 3 + f) % len(distinct)] for s in range(STREAMS) for f in range(STREAM_FRAMES)]
    n, bad = count_unmatched(got, want)
    log(f"[serving] multi-stream: detections >= {BF16_FIRM} without a partner in detect of the same frame: "
        f"{bad} of {n}")
    if n < 100 or bad > (1.0 - FAST_MATCH_SHARE) * n:
        raise AssertionError(f"[serving] multi-stream: {bad} of {n} detections unmatched")
    return launches


def phase_serving(cfg, det, det_fast, qdet, smi):
    """Path h, the serving runtime (`runtime/serving.py`, `runtime/video.py`)
    on the flagship weights at full width, each sub-path with every launch
    counter set to 0 just before and read just after:
    - ServingEngine (SERVING_BATCH images a launch, K = SERVING_MAX_DETS,
      "formatted" staging) on the module forward and on the fast engine,
      SERVING_IMAGES pre-sized 640 frames from SERVING_THREADS threads;
    - a landmark model's engine (B1 at its rungs of 8 and 2);
    - the int8-input engine against the uint8 one on the quantized B7 route;
    - ServingRouter on mixed sizes with a hot reload;
    - MultiStreamPipeline of STREAMS 720p streams on the fast engine.
    After the counts are read: a formatted launch with no host sync, then
    the readings (`serving_readings`). Returns the summed launch counts."""
    size = det.config.default_size
    pool, _ = paint_batch(50, SERVING_POOL, (size, size))
    reqs = serving_requests(pool, SERVING_IMAGES, seed=55)
    n_fast = len(det_fast._engine.kernel_blocks(size))
    paths = [check_engine("module forward", det, reqs, {"decode_feats_fused": 1}, smi),
             check_engine("fast engine", det_fast, reqs, {"decode_feats_fused": 1, "fused_mbconv": n_fast}, smi),
             check_landmark_engine(size, smi),
             check_int8_engine(qdet, pool, smi),
             check_router(cfg, det, smi),
             check_multistream(det_fast, smi)]
    launches = {name: sum(p[name] for p in paths) for name in paths[0]}
    check_launch_syncs(det, reqs[:8])
    check_launch_syncs(det_fast, reqs[:8])
    serving_readings(det, qdet, reqs, smi)
    return launches


def _turn(det, reqs, **kw):
    """One timed turn: a fresh engine fed `reqs` from SERVING_THREADS
    threads; (images/s from the first submit to the last result, stats)."""
    with _engine(det, **kw) as eng:
        _, wall = submit_all(eng, reqs)
        st = eng.stats()
    return sum(len(r) for r in reqs) / wall, st


def serving_readings(det, qdet, reqs, smi):
    """Readings, not claims: images/s and stats() p50/p99 of SERVING_TURNS
    turns of each of two modes, in alternation after a warm-up turn of each
    (formatted and plain staging on the module forward; the uint8 and the
    int8-input engine on the quantized B7 route, formatted staging), and
    the device idle share in one torch.profiler window of a turn of each
    staging mode."""
    pairs = (("staging", det, {"staging": "formatted"}, {"staging": "plain"}),
             ("int8 input (B7 route)", qdet, {}, {"int8_input": True}))
    out = {}
    for what, d, a, b in pairs:
        _turn(d, reqs, **a)
        _turn(d, reqs, **b)
        runs = {0: [], 1: []}
        for _ in range(SERVING_TURNS):
            for k, kw in ((0, a), (1, b)):
                runs[k].append(_turn(d, reqs, **kw))
        for k, kw in ((0, a), (1, b)):
            rates = [r for r, _ in runs[k]]
            out[f"{what} {json.dumps(kw)}"] = {
                "img_s": rates, "img_s_median": float(np.median(rates)), "img_s_min": min(rates),
                "img_s_max": max(rates), "p50_ms": [st["latency_ms_p50"] for _, st in runs[k]],
                "p99_ms": [st["latency_ms_p99"] for _, st in runs[k]],
                "launches": [st["launches"] for _, st in runs[k]],
                "pinned_launches": [st["pinned_launches"] for _, st in runs[k]],
            }
    for staging in ("formatted", "plain"):
        prof = device_profile(lambda: _turn(det, reqs, staging=staging), iters=1)
        out[f"profile staging={staging}"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share")}
        out[f"profile staging={staging}"]["top_device_ms"] = dict(list(prof["top_device_ms"].items())[:6])
    log(f"[serving] readings, {sum(len(r) for r in reqs)} images in {len(reqs)} requests from {SERVING_THREADS} "
        f"threads a turn, {SERVING_BATCH} images a launch, K = {SERVING_MAX_DETS}: {json.dumps(out)} on {smi}")


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #


def train_samples(seed, n, size, max_objs):
    """`n` painted size x size scenes of 1-6 faces as training samples: the
    uint8 image and `data.targets.make_targets` of its boxes (numpy)."""
    from tpucenterface_torch.data.targets import make_targets

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img, boxes = paint_scene(rng, (size, size), rng.randint(1, 7))
        t = make_targets(boxes, size, max_objs=max_objs)
        t["image"] = img
        out.append(t)
    return out


def stack_samples(samples):
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def to_device(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _np_tree(tree):
    from tpucenterface_torch.train.step import tree_paths

    return {p: t.detach().double().cpu().numpy() for p, t in tree_paths(tree)}


def check_step_against(got, want, lr, what):
    """`got` and `want` are (grads, metrics, params, batch_stats, ema) of one
    step from one state, held to the TRAIN_CMP bounds (see the constants).
    Logs the worst errors, each over its bound's scale, then raises on any
    violation."""
    g, m, params, stats, ema = got
    wg, wm, wparams, wstats, wema = want
    worst = {"loss_rel": max(abs(m[k] - wm[k]) / abs(wm[k]) for k in wm), "grad_over_gmax": 0.0,
             "grad_over_own": 0.0, "param_firm_over_lr": 0.0, "param_all_over_lr": 0.0, "mean_over_std": 0.0,
             "var_rel": 0.0}
    bad = [] if set(m) == set(wm) and worst["loss_rel"] <= 1e-5 else [f"metrics {m} against {wm}"]
    gmax = max(np.abs(x).max() for x in wg.values())
    for path, want_g in wg.items():
        err, own = np.abs(g[path] - want_g).max(), np.abs(want_g).max()
        worst["grad_over_gmax"] = max(worst["grad_over_gmax"], float(err / gmax))
        worst["grad_over_own"] = max(worst["grad_over_own"], float(err / own) if own > 0 else 0.0)
        if err > TRAIN_GRAD_GMAX * gmax + 1e-3 * own:
            bad.append(f"gradient {path} off by {err}")
        firm = np.abs(want_g) > TRAIN_GRAD_GMAX * gmax
        for tree, ref in ((params, wparams), (ema, wema)):
            d = np.abs(tree[path] - ref[path])
            if firm.any():
                worst["param_firm_over_lr"] = max(worst["param_firm_over_lr"], float(d[firm].max() / lr))
            worst["param_all_over_lr"] = max(worst["param_all_over_lr"], float(d.max() / lr))
            if (d[firm] > 1e-3 * lr + 1e-7).any() or (d > 2 * lr + 1e-7).any():
                bad.append(f"params or EMA {path} off by {d.max()}")
    for path, want_s in wstats.items():
        if path[-1] == "mean":
            e = float((np.abs(stats[path] - want_s) / np.sqrt(wstats[path[:-1] + ("var",)])).max())
            worst["mean_over_std"] = max(worst["mean_over_std"], e)
        else:
            e = float((np.abs(stats[path] - want_s) / want_s).max())
            worst["var_rel"] = max(worst["var_rel"], e)
        if e > 1e-5:
            bad.append(f"batch_stats {path} off by {e}")
    log(f"[train] {what}: loss {m['loss']:.6f} / {wm['loss']:.6f}; largest gradient {gmax:.4g}; worst "
        f"{json.dumps(worst)}")
    if bad:
        raise AssertionError(f"[train] {what}: " + "; ".join(bad[:10]))


def check_train_card_cpu():
    """Check 1: one float32 step at TRAIN_CMP_BATCH @ TRAIN_SIZE from the
    flagship weights on the card against the port's CPU run."""
    from tpucenterface_torch.config import ModelConfig, TrainConfig
    from tpucenterface_torch.model.centernet import CenterFaceNet
    from tpucenterface_torch.train import step as ts
    from tpucenterface_torch.weights.io import load_safetensors

    variables = load_safetensors(FLAGSHIP)
    tcfg = TrainConfig(input_size=TRAIN_SIZE, batch_size=TRAIN_CMP_BATCH, max_objs=32, lr=2e-3, ema_decay=0.999,
                       grad_clip_norm=5.0)
    model = CenterFaceNet(ModelConfig(compute_dtype="float32"))
    tx = ts.make_optimizer(tcfg)
    batch = stack_samples(train_samples(61, TRAIN_CMP_BATCH, TRAIN_SIZE, tcfg.max_objs))
    out = {}
    for dev in ("cuda", "cpu"):
        state = ts.train_state_from_variables(variables, tx, ema=True, device=dev)
        b = to_device(batch, dev)
        grads, _, _ = ts.make_loss_fn(model, tcfg)(state.params, state.batch_stats, b)
        new, metrics = ts.make_train_step(model, tx, tcfg)(state, b)
        out[dev] = (_np_tree(grads), {k: float(v) for k, v in metrics.items()}, _np_tree(new.params),
                    _np_tree(new.batch_stats), _np_tree(new.ema_params))
    put = lambda x: torch.from_numpy(np.array(x, np.float64)).to("cuda")  # noqa: E731
    f64 = CenterFaceNet(ModelConfig(compute_dtype="float64", bn_compute_dtype="float64"))
    g64, _, _ = ts.make_loss_fn(f64, tcfg)(ts.tree_map(put, variables["params"]),
                                           ts.tree_map(put, variables["batch_stats"]), to_device(batch, "cuda"))
    g64 = _np_tree(g64)
    gmax = max(np.abs(x).max() for x in g64.values())
    off = {dev: max(float(np.abs(out[dev][0][p] - x).max() / gmax) for p, x in g64.items()) for dev in out}
    log(f"[train] check 1, float32 gradients against the same step's in float64 on the card, worst tensor over the "
        f"largest gradient: card {off['cuda']:.3g}, CPU {off['cpu']:.3g}")
    check_step_against(out["cuda"], out["cpu"], tcfg.lr, f"check 1, a float32 step at bs{TRAIN_CMP_BATCH}@"
                       f"{TRAIN_SIZE} from the flagship weights, card against the port's CPU run")


def train_recipe():
    """Checks 2, 3 and 6: the flagship recipe for TRAIN_STEPS steps through
    the loop's `run_steps` (log boundaries every 20 steps, the checkpoint
    at TRAIN_CKPT), the steps between the boundaries at 60 and 80 under
    torch.cuda.set_sync_debug_mode("error"), the batches through
    `prefetch_to_device`. Returns (state, model config, train config, the
    run's losses and its records)."""
    import shutil

    from tpucenterface_torch.cli.train_flagship import flagship_train_cfg, parser
    from tpucenterface_torch.config import ModelConfig
    from tpucenterface_torch.runtime.prefetch import prefetch_to_device
    from tpucenterface_torch.train import step as ts
    from tpucenterface_torch.train.loop import run_steps

    args = parser().parse_args(["--batch-size", str(TRAIN_BATCH), "--input-size", str(TRAIN_SIZE), "--steps",
                                str(TRAIN_STEPS), "--freeze-bn", str(TRAIN_FREEZE)])
    tcfg = flagship_train_cfg(args, TRAIN_SCENES)
    mcfg = ModelConfig()
    per_epoch = TRAIN_SCENES // TRAIN_BATCH
    model, state, tx = ts.make_train_state(mcfg, tcfg, seed=0, steps_per_epoch=per_epoch)
    stats0 = ts.tree_map(torch.clone, state.batch_stats)
    t0 = time.perf_counter()
    samples = train_samples(7, TRAIN_SCENES, TRAIN_SIZE, tcfg.max_objs)
    paint_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)

    def host_batches():
        while True:
            order = rng.permutation(TRAIN_SCENES)
            for i in range(per_epoch):
                yield stack_samples([samples[j] for j in order[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]])

    steps = {False: ts.make_train_step(model, tx, tcfg), True: ts.make_train_step(model, tx, tcfg, frozen_bn=True)}
    losses, rec, logs = [], {}, []
    quiet = range(TRAIN_CKPT + 1, TRAIN_STEPS - 1)  # between the boundaries at 60 and 80

    def step_for(i):
        def run(st, batch):
            if i == TRAIN_FREEZE:
                rec["stats_at_freeze"] = ts.tree_map(torch.clone, st.batch_stats)
            if i == TRAIN_CKPT:
                rec["batch"], rec["before"] = batch, st
            if i == quiet[0]:
                torch.cuda.set_sync_debug_mode("error")
            new, m = steps[i >= tcfg.freeze_bn_steps](st, batch)
            losses.append(m["loss"])
            if i == TRAIN_CKPT:
                rec["after"], rec["after_loss"] = new, m["loss"]
            if i == quiet[-1]:
                torch.cuda.set_sync_debug_mode("default")
            return new, m

        return run

    workdir = os.path.join(ROOT, "build", "train_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        state, step, last_ckpt = run_steps(
            step_for, state, prefetch_to_device(host_batches(), size=2), 0, TRAIN_STEPS, TRAIN_BATCH,
            log_every=20, log_fn=lambda s, m: logs.append((s, m)), ckpt_every=TRAIN_CKPT, workdir=workdir)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loss = torch.stack(losses).cpu().numpy()
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    log(f"[train] check 2, the flagship recipe at bs{TRAIN_BATCH}@{TRAIN_SIZE} ({TRAIN_SCENES} painted scenes in "
        f"{paint_s:.1f} s; LR drops at {[b for b, _ in tx.boundaries]}; FrozenBN from step {TRAIN_FREEZE}): "
        f"{len(loss)} steps in {wall:.2f} s with the loop's host work and the prefetch; losses by tens "
        f"{[round(float(x), 4) for x in loss.reshape(-1, 10).mean(axis=1)]}; logged {[(s, round(m['loss'], 4)) for s, m in logs]}")
    if step != TRAIN_STEPS or last_ckpt != TRAIN_CKPT or not np.isfinite(loss).all():
        raise AssertionError(f"[train] the recipe ran {step} steps, saved at {last_ckpt}, losses {loss}")
    if not last < TRAIN_LOSS_RATIO * first:
        raise AssertionError(f"[train] the loss fell from {first} to {last} only")
    moved = sum(not torch.equal(a, b) for (_, a), (_, b) in zip(ts.tree_paths(rec["stats_at_freeze"]),
                                                                 ts.tree_paths(stats0)))
    for (path, a), (_, b) in zip(ts.tree_paths(state.batch_stats), ts.tree_paths(rec["stats_at_freeze"])):
        if not torch.equal(a, b):
            raise AssertionError(f"[train] batch_stats {path} moved after the FrozenBN boundary")
    ema_differs = sum(not torch.equal(a, b) for (_, a), (_, b) in zip(ts.tree_paths(state.ema_params),
                                                                       ts.tree_paths(state.params)))
    if not moved or not ema_differs:
        raise AssertionError(f"[train] statistics moved in {moved} tensors before the boundary, EMA differs in "
                             f"{ema_differs}")
    log(f"[train] running statistics: {moved} tensors moved in the {TRAIN_FREEZE} live steps, all bit-equal over the "
        f"{TRAIN_STEPS - TRAIN_FREEZE} frozen ones; the EMA differs from the live params in {ema_differs} tensors; "
        f"steps {quiet[0]}-{quiet[-1]} ran under set_sync_debug_mode('error'), the batch copies included")
    return state, mcfg, tcfg, (model, tx, steps, rec, workdir)


def check_train_resume(mcfg, tcfg, run):
    """Check 3: the checkpoint at TRAIN_CKPT restored into a fresh state
    equals the run's state there bit for bit, and its next step equals the
    run's next step (see the constants)."""
    from tpucenterface_torch.train import step as ts
    from tpucenterface_torch.train.loop import restore_checkpoint

    model, tx, steps, rec, workdir = run
    _, template, _ = ts.make_train_state(mcfg, tcfg, seed=1, steps_per_epoch=TRAIN_SCENES // TRAIN_BATCH)
    restored = restore_checkpoint(workdir, template)
    for name in ("params", "batch_stats", "opt_state", "ema_params"):
        for (path, a), (_, b) in zip(ts.tree_paths(getattr(restored, name)), ts.tree_paths(getattr(rec["before"], name))):
            if not torch.equal(a, b):
                raise AssertionError(f"[train] the restored {name} {path} differs from the saved state")
    if int(restored.step) != TRAIN_CKPT:
        raise AssertionError(f"[train] restored step {int(restored.step)}")
    new, m = steps[True](restored, rec["batch"])
    lr = float(tx.learning_rate(torch.tensor(TRAIN_CKPT)))
    loss_rel = abs(float(m["loss"]) - float(rec["after_loss"])) / abs(float(rec["after_loss"]))
    worst = {}
    for name in ("params", "ema_params", "batch_stats"):
        worst[name] = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
            ts.tree_paths(getattr(new, name)), ts.tree_paths(getattr(rec["after"], name))))
    log(f"[train] check 3, the step after the checkpoint at {TRAIN_CKPT}, restored against uninterrupted: loss "
        f"relative difference {loss_rel:.3g}, max |difference| {json.dumps(worst)} (lr there {lr:.3g}; cuDNN's "
        f"default algorithms)")
    if loss_rel > 1e-5 or max(worst.values()) > TRAIN_RESUME_LR_FRAC * lr:
        raise AssertionError("[train] the resumed step differs from the uninterrupted one")


def check_train_export(state, cfg, smi):
    """Check 4: export model.safetensors and model_ema.safetensors, load each
    with Detector.from_safetensors on the fast engine and on the module
    forward, both with the fused decode, and detect on painted scenes with
    every launch counter set to 0 just before and read just after; the fast
    engine's detections against the module forward's, its heat map against
    the float32 forward's. Returns the launch counts."""
    import dataclasses

    from tpucenterface_torch import Detector, DetectorConfig, ModelConfig
    from tpucenterface_torch.train.loop import export_weights

    workdir = os.path.join(ROOT, "build", "train_smoke")
    export_weights(workdir, state)
    at = DetectorConfig(decode=cfg.decode, default_size=TRAIN_SIZE)
    imgs, gts = paint_batch(71, 32, (TRAIN_SIZE, TRAIN_SIZE))
    dets = {}
    for name in ("model", "model_ema"):
        path = os.path.join(workdir, f"{name}.safetensors")
        dets[name] = {kind: Detector.from_safetensors(path, dataclasses.replace(at, model=ModelConfig(**kw)))
                      for kind, kw in (("module", {}), ("fast", {"inference_engine": "fast"}),
                                       ("f32", {"compute_dtype": "float32"}))}
    n_blocks = len(dets["model"]["fast"]._engine.kernel_blocks(TRAIN_SIZE))
    zero_launches()
    out = {name: {kind: d[kind].detect_batch(imgs, score_thresh=0.02) for kind in ("module", "fast")}
           for name, d in dets.items()}
    launches = read_launches()
    log(f"[train] check 4, detect on the exports (bs32@{TRAIN_SIZE}, module forward and fast engine, fused decode): "
        f"launches {launches}")
    if launches != launch_counts(decode_feats_fused=4, fused_mbconv=2 * n_blocks):
        raise AssertionError(f"[train] export: launches {launches}")
    x = normalize_raw(dets["model"]["module"], imgs, "cuda")
    for name, d in dets.items():
        for r in out[name]["fast"] + out[name]["module"]:
            if not (np.isfinite(r.boxes).all() and np.isfinite(r.scores).all()) or (r.boxes < 0).any() or (
                    r.boxes > TRAIN_SIZE).any():
                raise AssertionError(f"[train] {name}: non-finite or out-of-image detections")
        n, bad = count_unmatched(out[name]["fast"], out[name]["module"], firm=0.05)
        with torch.inference_mode():
            ref = d["f32"]._forward(x)["hm"]
        hm = {kind: _hm_distance(d[kind], x, ref) for kind in ("fast", "module")}
        found = sum(int((iou(g, r.boxes[r.scores >= 0.05]).max(axis=1) >= 0.5).sum()) if len(g) and
                    (r.scores >= 0.05).any() else 0 for g, r in zip(gts, out[name]["module"]))
        log(f"[train] {name}: fast engine against the module forward, detections >= 0.05 without a partner within "
            f"{BF16_BOX_ATOL} px and {BF16_SCORE_ATOL}: {bad} of {n}; mean |hm - float32| fast {hm['fast']:.4g}, "
            f"module {hm['module']:.4g}; painted faces found >= 0.05 at IoU 0.5: {found} of {sum(map(len, gts))}")
        # the EMA (d = 0.999) of an 80-step run is 92% the random init: a
        # flat heat map of near-tied peaks, whose detections either rounding
        # moves, so only the live export's detections are matched
        if (name == "model" and bad > (1.0 - FAST_MATCH_SHARE) * n + FAST_F32_SLACK) or (
                hm["fast"] > FAST_F32_HM_RATIO * hm["module"]):
            raise AssertionError(f"[train] {name}: the fast engine differs from the module forward")
    return launches


def train_readings(samples320, smi):
    """Readings, not claims: training images/s (TRAIN_READ_STEPS steps on a
    device-resident batch, after three warm-up steps, host clock around
    synchronized runs) at bs32 @ 320 and @ 640 with float32 and bfloat16
    BatchNorm; peak memory of a step at bs32 @ 640 with remat off and on;
    the device idle share of five steps at bs32 @ 320 (torch.profiler)."""
    from tpucenterface_torch.config import ModelConfig, TrainConfig
    from tpucenterface_torch.train import step as ts

    big = train_samples(83, TRAIN_BATCH, TRAIN_SIZE_BIG, 32)
    batches = {TRAIN_SIZE: to_device(stack_samples(samples320), "cuda"),
               TRAIN_SIZE_BIG: to_device(stack_samples(big), "cuda")}

    def stepper(size, bn="float32", remat=False):
        tcfg = TrainConfig(input_size=size, batch_size=TRAIN_BATCH, max_objs=32, lr=2e-3, ema_decay=0.999,
                           grad_clip_norm=5.0, remat=remat)
        model, st, tx = ts.make_train_state(ModelConfig(bn_compute_dtype=bn), tcfg)
        fn = ts.make_train_step(model, tx, tcfg)
        box = [st]

        def one():
            box[0], _ = fn(box[0], batches[size])

        return one

    out = {}
    for size in (TRAIN_SIZE, TRAIN_SIZE_BIG):
        for bn in ("float32", "bfloat16"):
            one = stepper(size, bn)
            for _ in range(3):
                one()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_READ_STEPS):
                one()
            torch.cuda.synchronize()
            out[f"img_s bs{TRAIN_BATCH}@{size} bn {bn}"] = TRAIN_READ_STEPS * TRAIN_BATCH / (time.perf_counter() - t0)
            del one
    for remat in (False, True):
        one = stepper(TRAIN_SIZE_BIG, remat=remat)
        one()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        one()
        torch.cuda.synchronize()
        out[f"peak_gib bs{TRAIN_BATCH}@{TRAIN_SIZE_BIG} remat {remat}"] = torch.cuda.max_memory_allocated() / 2**30
        out[f"step_gib_above_resident remat {remat}"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        del one
    one = stepper(TRAIN_SIZE)
    prof = device_profile(one, iters=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        one()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    out[f"profile bs{TRAIN_BATCH}@{TRAIN_SIZE} step"] = {
        k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share")}
    # the profiler's wall includes its own host cost and a synchronize a step;
    # five steps back to back without it give the loop's own wall a step
    out[f"profile bs{TRAIN_BATCH}@{TRAIN_SIZE} step"]["unprofiled_wall_ms"] = wall_ms
    out[f"profile bs{TRAIN_BATCH}@{TRAIN_SIZE} step"]["device_idle_share_unprofiled"] = 1.0 - prof[
        "device_busy_ms"] / wall_ms
    out[f"profile bs{TRAIN_BATCH}@{TRAIN_SIZE} step"]["top_device_ms"] = dict(list(prof["top_device_ms"].items())[:8])
    log(f"[train] readings: {json.dumps(out)} on {smi}")


def phase_train(cfg, smi):
    """Path i, training (`[train]`): checks 1-6 in order (see the constants
    and each check's docstring). The card has no cv2, so the batches are
    painted with numpy and the targets rendered by `data.targets`; the phase
    drives `train.step` and `train.loop`'s `run_steps`, checkpoint and
    export functions. Returns the launch counts of check 4."""
    check_train_card_cpu()
    state, mcfg, tcfg, run = train_recipe()
    check_train_resume(mcfg, tcfg, run)
    launches = check_train_export(state, cfg, smi)
    del run, state
    train_readings(train_samples(7, TRAIN_BATCH, TRAIN_SIZE, 32), smi)
    return launches


def _grads_np(tree):
    from tpucenterface_torch.train.step import tree_paths

    return {p: t.detach().double().cpu().numpy() for p, t in tree_paths(tree)}


def _ste_step(eng, x, target, keys):
    from tpucenterface_torch.quant.qat import ste_loss_and_grads

    dev = eng.device
    loss, grads = ste_loss_and_grads(eng, eng.p, x.to(dev), {k: v.to(dev) for k, v in target.items()}, keys)
    return float(loss), _grads_np(grads)


def _step_apart(card, cpu):
    """(loss rtol, worst gradient element over the largest, gradient distance
    over the norm) of two (loss, gradients) results."""
    (l_a, g_a), (l_b, g_b) = card, cpu
    gmax = max(np.abs(a).max() for a in g_b.values())
    gnorm = np.sqrt(sum((a ** 2).sum() for a in g_b.values()))
    worst = max(np.abs(g_a[p] - g_b[p]).max() for p in g_b) / gmax
    norm = np.sqrt(sum(((g_a[p] - g_b[p]) ** 2).sum() for p in g_b)) / gnorm
    return abs(l_a - l_b) / abs(l_b), worst, norm


def _step_bounds_broken(apart):
    rtol, worst, norm = apart
    bad = []
    if rtol > QFT_LOSS_RTOL:
        bad.append(f"loss apart by {rtol:.3g} (bound {QFT_LOSS_RTOL})")
    if worst > QFT_GRAD_MAX:
        bad.append(f"gradients apart by {worst:.3g} of the largest (bound {QFT_GRAD_MAX})")
    if norm > QFT_GRAD_NORM:
        bad.append(f"gradients apart by {norm:.3g} of the norm (bound {QFT_GRAD_NORM})")
    return bad


def quant_ft_step_check(frames, scales):
    """Check (a): one STE step of the flagship's int8_dw engine at
    QFT_CMP_BATCH @ QFT_SIZE, card against the port's CPU run, under one
    scales dict and one float target; the control, the card's step with TF32
    on, must break the bounds; then the bias-correction means of the two
    devices."""
    from tpucenterface_torch import Detector, DetectorConfig
    from tpucenterface_torch.quant import QuantEngine

    keys = ["hm", "whoff"]
    det = Detector.from_safetensors(FLAGSHIP, DetectorConfig(default_size=QFT_SIZE), device="cpu")
    x_cpu = normalize_raw(det, frames[:QFT_CMP_BATCH], "cpu")
    engines = {}
    for dev in ("cuda", "cpu"):
        eng = QuantEngine(det.variables, det.config.model, int8_dw=True, pp_cfg=det.config.preprocess, device=dev)
        eng.set_scales(scales)
        engines[dev] = eng
    with torch.no_grad():
        target = {k: v.float() for k, v in engines["cuda"]._forward(x_cpu.to("cuda"), "float").items() if k in keys}
    cpu = _ste_step(engines["cpu"], x_cpu, target, keys)
    card = _ste_step(engines["cuda"], x_cpu, target, keys)
    apart = _step_apart(card, cpu)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        control = _step_apart(_ste_step(engines["cuda"], x_cpu, target, keys), cpu)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    bad, caught = _step_bounds_broken(apart), _step_bounds_broken(control)
    log(f"[quant_ft] (a) one STE step at bs{QFT_CMP_BATCH}@{QFT_SIZE}: fakequant loss card {card[0]:.9g}, CPU "
        f"{cpu[0]:.9g}; card against CPU: loss rtol {apart[0]:.3g}, gradients worst element {apart[1]:.3g} of "
        f"the largest, {apart[2]:.3g} of the norm; control (TF32 on) against CPU: loss rtol {control[0]:.3g}, "
        f"gradients {control[1]:.3g} of the largest, {control[2]:.3g} of the norm; the control breaks "
        f"{len(caught)} of the 3 bounds")
    if not caught:
        bad.append("the TF32 control stays inside the bounds, so they cannot tell a device fault")
    for mode in ("quant", "float"):
        means = {}
        for dev, eng in engines.items():
            eng._bc_collector = {}
            with torch.no_grad():
                eng._forward(x_cpu.to(dev), mode, params=eng.p)
            means[dev], eng._bc_collector = {k: v.double().cpu().numpy() for k, v in eng._bc_collector.items()}, None
        top = max(np.abs(v).max() for v in means["cpu"].values())
        off = max(np.abs(means["cuda"][t] - v).max() for t, v in means["cpu"].items()) / top
        log(f"[quant_ft] (a) bias-correction means, {mode} mode, {len(means['cpu'])} convs: card against CPU "
            f"{off:.3g} of the largest mean ({top:.4g})")
        if set(means["cuda"]) != set(means["cpu"]) or off > QFT_MEAN_ATOL[mode]:
            bad.append(f"{mode}-mode means apart by {off:.3g} of the largest")
    if bad:
        raise AssertionError("[quant_ft] (a) card against CPU: " + "; ".join(bad))


def phase_quant_ft(cfg, smi, ptq_b7):
    """Path j, int8 fine-tuning (`[quant_ft]`): checks (a)-(e) and readings
    (see the constants). Returns the launch counts of the serving run (d);
    the fine-tuning itself runs the per-conv route and launches no kernel
    (counted and required 0)."""
    import shutil

    from tpucenterface_torch import Detector, DetectorConfig
    from tpucenterface_torch.weights.io import load_packed_weights, load_safetensors, save_packed_weights
    from tpucenterface_torch.weights.io import save_safetensors

    frames, _ = paint_batch(31, QFT_CALIB_FRAMES, (QFT_SIZE, QFT_SIZE))
    secs = {}
    zero_launches()
    t0 = time.perf_counter()
    scales = Detector.from_safetensors(FLAGSHIP, cfg).quantize(calib_images=frames, size=QFT_SIZE, int8_dw=True)
    torch.cuda.synchronize()
    secs["calibration"] = time.perf_counter() - t0
    quant_ft_step_check(frames, scales)

    tuned = {}
    for name, kw in (("w8_qat", dict(qat_steps=QFT_QAT_STEPS)), ("w4_adaround", dict(weight_bits=4,
                                                                                       adaround_steps=QFT_ADA_STEPS))):
        det = Detector.from_safetensors(FLAGSHIP, cfg)
        t0 = time.perf_counter()
        s = det.quantize(calib_images=frames, size=QFT_SIZE, int8_dw=True, **kw)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        tuned[name] = (det, s)
    launched = read_launches()
    if any(launched.values()):
        raise AssertionError(f"[quant_ft] calibration and fine-tuning launched kernels: {launched}")
    m = tuned["w8_qat"][0].last_qat_metrics
    log(f"[quant_ft] (b) QAT, {QFT_QAT_STEPS} steps on {QFT_CALIB_FRAMES} painted {QFT_SIZE} frames: {json.dumps(m)}")
    if not m["loss_last"] <= m["loss_bc"] <= m["loss_first"] or m["steps"] != QFT_QAT_STEPS:
        raise AssertionError(f"[quant_ft] (b) QAT is not monotone: {m}")
    # the served int8 weights are formed by the rule that QAT selected with
    det = tuned["w8_qat"][0]
    with torch.no_grad():
        x = normalize_raw(det, frames[:QFT_CMP_BATCH], "cuda")
        served, selected = det._quant(x), det._quant._forward(x, "quant", params=det._quant.p)
    if any(not torch.equal(served[k], selected[k]) for k in ("hm", "whoff")):
        raise AssertionError("[quant_ft] (b) the installed forward differs from the selected params' forward")
    rep = tuned["w4_adaround"][0].last_adaround_report
    ratios = {k: v for k, v in rep.items() if not k.startswith("_")}
    log(f"[quant_ft] (c) W4 AdaRound, {QFT_ADA_STEPS} steps: {len(ratios)} layers, ratios min "
        f"{min(ratios.values()):.4g} median {float(np.median(list(ratios.values()))):.4g} max "
        f"{max(ratios.values()):.4g}; accepted {rep['_accepted']}; end-to-end loss of the W4 nearest-rounding "
        f"detector {rep['_e2e_first']:.6g}, after AdaRound {rep['_e2e_last']:.6g}")
    if not ratios or max(ratios.values()) > 1.0:
        raise AssertionError(f"[quant_ft] (c) a layer's ratio above 1: {ratios}")
    log(f"[quant_ft] seconds on the card: calibration {secs['calibration']:.2f}; quantize with QAT "
        f"{secs['w8_qat']:.2f}; quantize with W4 AdaRound {secs['w4_adaround']:.2f} (each includes its own "
        f"calibration)")

    # (d) both tuned detectors on both routes: the B7 route installs the
    # persisted pair with fused_blocks=True
    dets = {}
    for name, (det, s) in tuned.items():
        dets[name, "library"] = det
        dets[name, "b7"] = Detector.from_safetensors(FLAGSHIP, cfg)
        dets[name, "b7"].quantize(scales=s, quant_params=det.quant_variables, fused_blocks=True)
        if dets[name, "b7"]._quant.fused_block_indices() != QUANT_S1_BLOCKS:
            raise AssertionError(f"[quant_ft] {name}: the B7 route does not take the ten residual blocks")
    b640, g640 = paint_batch(33, 32, (640, 640))
    zero_launches()
    runs = {key: d.detect_batch(b640, score_thresh=0.05) for key, d in dets.items()}
    launches = read_launches()
    want = launch_counts(decode_feats_fused=len(dets), int8_block_s1=len(QUANT_S1_BLOCKS) * len(tuned))
    log(f"[quant_ft] (d) the tuned detectors, both routes, bs32@640: kernel launches {launches}")
    if launches != want:
        raise AssertionError(f"[quant_ft] (d) launches {launches}; wanted {want}")
    for (name, route), r in runs.items():
        check_result(r, g640, [(640, 640)] * 32, f"[quant_ft] {name} {route} route bs32 640x640")
    for name in tuned:
        n, bad = count_unmatched(runs[name, "b7"], runs[name, "library"])
        log(f"[quant_ft] (d) {name}: B7 route against the library route, {bad} of {n} detections >= {BF16_FIRM} "
            f"without a partner")
        if n < 100 or bad > (1.0 - B7_MATCH_SHARE) * n:
            raise AssertionError(f"[quant_ft] (d) {name}: the B7 route differs on {bad} of {n}")

    # (e) persistence, outside the count
    before = read_launches()
    workdir = os.path.join(ROOT, "build", "quant_ft_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    det, s = tuned["w8_qat"]
    path = os.path.join(workdir, "qat.safetensors")
    save_safetensors(det.quant_variables, path)
    fresh = Detector.from_safetensors(FLAGSHIP, cfg)
    fresh.quantize(scales=s, quant_params=load_safetensors(path))
    for a, b in zip(fresh.detect_batch(b640, score_thresh=0.05), runs["w8_qat", "library"]):
        if not (np.array_equal(a.scores, b.scores) and np.array_equal(a.boxes, b.boxes)):
            raise AssertionError("[quant_ft] (e) quant_variables reinstalled: detections differ")
    packed = os.path.join(workdir, "w4.npz")
    sizes = save_packed_weights(dets["w4_adaround", "b7"], packed)
    fresh = Detector.from_safetensors(FLAGSHIP, cfg)
    ps, pq = load_packed_weights(packed)
    fresh.quantize(scales=ps, quant_params=pq, fused_blocks=True)
    for a, b in zip(fresh.detect_batch(b640, score_thresh=0.05), runs["w4_adaround", "b7"]):
        if not (np.array_equal(a.scores, b.scores) and np.array_equal(a.boxes, b.boxes)):
            raise AssertionError("[quant_ft] (e) the packed W4 artifact reloaded: detections differ")
    log(f"[quant_ft] (e) quant_variables and the packed W4 artifact reload bit-equal on the card; packed "
        f"{sizes['packed_bytes']} bytes against {sizes['f32_bytes']} of float32 params")
    if sizes["packed_bytes"] >= 0.5 * sizes["f32_bytes"]:
        raise AssertionError(f"[quant_ft] (e) the W4 artifact is not under half the float32 bytes: {sizes}")

    # readings: the B7 route at bs32 @ 640, tuned W8, tuned W4 and the PTQ
    # detector in turns (the same program: expected equal within noise)
    order = [("ptq", ptq_b7), ("w8_qat", dets["w8_qat", "b7"]), ("w4_adaround", dets["w4_adaround", "b7"])]
    times = {name: [] for name, _ in order}
    for name, d in order + order[::-1]:
        times[name].extend(cuda_times(lambda d=d: d.detect_batch(b640, score_thresh=0.05), iters=10))
    rates = {name: {"p50_ms": float(np.median(t)), "min_ms": min(t), "max_ms": max(t),
                    "img_s": 32e3 / float(np.median(t))} for name, t in times.items()}
    for name, fn in kernel_wrappers().items():
        fn.launches = before[name]
    log(f"[quant_ft] readings, detect_batch bs32@640 on the B7 route, 20 calls each in two turns ({smi}): "
        + json.dumps(rates))
    shutil.rmtree(workdir, ignore_errors=True)
    return launches


# --------------------------------------------------------------------------- #
# [entry]: how users start the system
# --------------------------------------------------------------------------- #


def _same_dets(a_dets, b_dets):
    return all(a.boxes.tobytes() == b.boxes.tobytes() and a.scores.tobytes() == b.scores.tobytes()
               and (a.landmarks is None) == (b.landmarks is None)
               and (a.landmarks is None or a.landmarks.tobytes() == b.landmarks.tobytes())
               for a, b in zip(a_dets, b_dets)) and len(a_dets) == len(b_dets)


def _twin_checkpoint(variables, mcfg):
    """The state dict a torch twin of `mcfg` holds after loading
    JAX-layout `variables` (num_batches_tracked buffers included), on the
    CPU."""
    from tpucenterface_torch.weights.convert import state_dict_from_variables
    from tpucenterface_torch.weights.torch_twin import TorchCenterFace

    twin = TorchCenterFace(mcfg)
    missing, unexpected = twin.load_state_dict(state_dict_from_variables(variables), strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise AssertionError(f"[entry] the twin takes other keys: missing {missing}, unexpected {unexpected}")
    return twin.state_dict()


def _foreign_renamed(sd):
    """`sd` under torchvision-like names (features.N.M.<leaf>) with extra
    num_batches_tracked buffers: tests/test_parity.py::_foreign_renamed_state."""
    foreign = {}
    for i, (k, v) in enumerate(sd.items()):
        leaf = k.rsplit(".", 1)[-1]
        foreign[f"features.{i // 4}.{i % 4}.{leaf}"] = v.clone()
        if leaf == "running_var":
            foreign[f"features.{i // 4}.{i % 4}.num_batches_tracked"] = torch.tensor(42, dtype=torch.long)
    return foreign


def _run_cli(tag, main, argv):
    """Run a CLI's main in this process -> (return value, its standard
    output), which is logged line by line."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"[entry] {tag} | {line}")
    return rc, out


def _served_lines(path):
    return [json.loads(line) for line in open(path)]


def _lines_of(dets):
    """What `cli.serve --out` writes for Detections."""
    return [{"boxes": np.round(d.boxes, 2).tolist(), "scores": np.round(d.scores, 4).tolist()} for d in dets]


def entry_checkpoints(workdir):
    """Write the flagship as twin-layout `.pth` files (bare, wrapped in
    {"state_dict": ...}, with `module.` prefixes, and foreign-renamed) ->
    ({form: path}, the twin state dict)."""
    from tpucenterface_torch import ModelConfig
    from tpucenterface_torch.weights.io import load_safetensors

    sd = _twin_checkpoint(load_safetensors(FLAGSHIP), ModelConfig())
    forms = {
        "bare": sd,
        "state_dict": {"state_dict": sd},
        "module": {f"module.{k}": v for k, v in sd.items()},
        "foreign": _foreign_renamed(sd),
    }
    paths = {}
    for name, ckpt in forms.items():
        paths[name] = os.path.join(workdir, f"flagship_{name}.pth")
        torch.save(ckpt, paths[name])
    return paths, sd


def entry_cpp_nms():
    """(d) The C++ `bbox_overlaps` and `nms` (`native/nms_ext.cpp`, built by
    g++ on the card's host) against the numpy loops on random float32
    detections. Returns a summary for the log."""
    from tpucenterface_torch import native
    from tpucenterface_torch.eval import tta, wider_eval

    rng = np.random.RandomState(41)
    worst, kept, t_cpp, t_np = 0.0, 0, 0.0, 0.0
    for case in range(200):
        n = int(rng.randint(1, 400))
        xy = rng.uniform(0, 600, (n, 2))
        wh = rng.uniform(4, 120, (n, 2))
        dets = np.concatenate([xy, xy + wh, rng.choice([0.9, 0.7, 0.5], (n, 1)) if case % 4 == 0
                               else rng.rand(n, 1)], axis=1).astype(np.float32)
        t0 = time.perf_counter()
        got_nms = tta.nms(dets, 0.4)
        got_iou = wider_eval.bbox_overlaps(dets[:, :4].astype(np.float64), dets[:50, :4].astype(np.float64))
        t1 = time.perf_counter()
        want_nms = tta.nms_plain(dets, 0.4)
        want_iou = wider_eval.bbox_overlaps_plain(dets[:, :4].astype(np.float64), dets[:50, :4].astype(np.float64))
        t_cpp += t1 - t0
        t_np += time.perf_counter() - t1
        if not np.array_equal(got_nms, want_nms):
            raise AssertionError(f"[entry] (d) C++ nms differs from the numpy loop on case {case} ({n} detections)")
        worst = max(worst, float(np.abs(got_iou - want_iou).max()))
        kept += len(got_nms)
    if worst > 1e-12:
        raise AssertionError(f"[entry] (d) C++ bbox_overlaps differs from the numpy loop by {worst}")
    return (f"C++ nms equal to the numpy loop on 200 random float32 sets ({kept} kept), bbox_overlaps within "
            f"{worst:.3g}; host seconds C++ {t_cpp:.3f}, numpy {t_np:.3f} ({native.NMS_SOURCE.name})")


def phase_entry(smi):
    """Path k, the entry points (`[entry]`): (a) the flagship as `.pth`
    checkpoints (bare, wrapped, `module.`-prefixed; a foreign-renamed copy
    through `load_torch_pth(auto_map=True, allow_ambiguous=True)`) loaded with
    `Detector.from_torch_pth` on the fast engine with the fused decode, each
    bs32 @ 640 call on painted frames bit-equal to `from_safetensors(FLAGSHIP)`
    under the same config (B3 ten launches a forward, B2 one a call), and
    `reload_weights(torch_pth_path=)` on a live detector; (b) a random
    landmark twin saved as `.pth`, `from_torch_pth` with `use_pallas=True`
    (B1 once a call) bit-equal to the variables route; (c) the CLIs in this
    process: `port_weights`, `serve` (uint8 against direct `detect_batch`,
    then `--int8 --int8-dw --save-packed` against `--packed`), `demo`, and
    the parity report's layer and boxes stages (float32) on numpy-painted
    scenes, passing their gates and failing them on one corrupted tensor;
    (d) the C++ eval NMS against the numpy loops. The references are
    computed before the counts are set to 0; everything else is counted.
    Returns the launch counts."""
    import dataclasses
    import shutil

    from tpucenterface_torch import DecodeConfig, Detector, DetectorConfig, ModelConfig
    from tpucenterface_torch.cli import demo, parity_report, port_weights, serve
    from tpucenterface_torch.weights.io import flatten, load_safetensors
    from tpucenterface_torch.weights.port import load_torch_pth, variables_from_torch_module, variables_from_torch_state
    from tpucenterface_torch.weights.torch_twin import TorchCenterFace

    workdir = os.path.join(ROOT, "build", "entry_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    paths, sd = entry_checkpoints(workdir)
    fast_cfg = DetectorConfig(model=ModelConfig(inference_engine="fast"), decode=DecodeConfig(use_pallas=True),
                              default_size=ENTRY_SIZE)
    frames, gts = paint_batch(51, ENTRY_BATCH, (ENTRY_SIZE, ENTRY_SIZE))
    want = Detector.from_safetensors(FLAGSHIP, fast_cfg).detect_batch(frames, score_thresh=0.05)
    # (b)'s twin and its variables-route reference
    lm_model = ModelConfig(with_landmarks=True)
    lm_cfg = DetectorConfig(model=lm_model, decode=DecodeConfig(use_pallas=True), default_size=320)
    gen = torch.Generator().manual_seed(23)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(23)
        lm_twin = TorchCenterFace(lm_model).eval()
    with torch.no_grad():
        for m in lm_twin.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    lm_pth = os.path.join(workdir, "landmarks.pth")
    torch.save(lm_twin.state_dict(), lm_pth)
    lm_imgs, _ = paint_batch(52, 4, (320, 320))
    lm_want = Detector(variables=variables_from_torch_module(lm_twin, lm_model), config=lm_cfg).detect_batch(
        lm_imgs, score_thresh=0.0)

    zero_launches()
    # (a)
    load_s, dets = {}, {}
    for form, path in paths.items():
        t0 = time.perf_counter()
        if form == "foreign":
            v = load_torch_pth(path, fast_cfg.model, auto_map=True, allow_ambiguous=True)
        else:
            v = load_torch_pth(path, fast_cfg.model)
        load_s[form] = time.perf_counter() - t0
        det = Detector(variables=v, config=fast_cfg) if form == "foreign" else Detector.from_torch_pth(path, fast_cfg)
        dets[form] = det.detect_batch(frames, score_thresh=0.05)
    per_forward = len(det._engine.kernel_blocks(ENTRY_SIZE))
    live = Detector(config=fast_cfg, seed=5)
    before = live.detect_batch(frames, score_thresh=0.05)
    v0 = live.weights_version
    live.reload_weights(torch_pth_path=paths["bare"])
    dets["reloaded"] = live.detect_batch(frames, score_thresh=0.05)
    after_a = read_launches()
    calls_a = len(dets) + 1
    # (b)
    lm_got = Detector.from_torch_pth(lm_pth, lm_cfg).detect_batch(lm_imgs, score_thresh=0.0)
    after_b = read_launches()
    # (c)
    st_out = os.path.join(workdir, "port.safetensors")
    _run_cli("port_weights", port_weights.main, ["--pth", paths["state_dict"], "--out", st_out])
    ported, flagship = flatten(load_safetensors(st_out)), flatten(load_safetensors(FLAGSHIP))
    same_ported = ported.keys() == flagship.keys() and all(np.array_equal(ported[k], flagship[k]) for k in flagship)
    n_serve, rung = ENTRY_SERVE_IMAGES, str(ENTRY_SERVE_BATCH)
    serve_args = ["--source", "synthetic", "--n-synthetic", str(n_serve), "--device-batch", rung, "--ladder", rung,
                  "--size", str(ENTRY_SIZE), "--weights", paths["bare"], "--thresh", "-1"]
    outs = {name: os.path.join(workdir, f"{name}.jsonl") for name in ("u8", "int8", "packed")}
    packed = os.path.join(workdir, "serve.npz")
    _, text = _run_cli("serve", serve.main, serve_args + ["--out", outs["u8"]])
    summary = json.loads(text.strip().splitlines()[-1])
    _run_cli("serve --int8", serve.main, serve_args + ["--int8", "--int8-dw", "--save-packed", packed,
                                                       "--out", outs["int8"]])
    _run_cli("serve --packed", serve.main, serve_args + ["--packed", packed, "--out", outs["packed"]])
    _, demo_text = _run_cli("demo", demo.main, ["--source", "synthetic", "--max-frames", str(ENTRY_DEMO_FRAMES),
                                                "--size", str(ENTRY_SIZE), "--weights", paths["bare"]])
    p32 = ModelConfig(compute_dtype="float32")
    clean = variables_from_torch_state(sd, p32)
    scenes = [paint_scene(np.random.RandomState(100 + i), (360, 480), 4)[0] for i in range(4)]
    size = ENTRY_PARITY_SIZE
    det32 = Detector(variables=clean, config=DetectorConfig(model=p32, default_size=size))
    layers, twin = parity_report.layer_stage(p32, sd, clean, size, 2e-3, device=det32.device)
    boxes = parity_report.boxes_stage(det32, twin, scenes, size)
    bad_sd = dict(sd, **{"heads.wh.out.bias": sd["heads.wh.out.bias"] + 3.0})
    bad_layers, bad_twin = parity_report.layer_stage(p32, bad_sd, clean, size, 2e-3, device=det32.device)
    bad_boxes = parity_report.boxes_stage(det32, bad_twin, scenes, size)
    launches = read_launches()

    # the counts are read; what follows compares
    log(f"[entry] (a) load_torch_pth seconds on the flagship: {json.dumps(load_s)} ({smi})")
    log(f"[entry] kernel launches: after (a) {after_a}, after (b) {after_b}, after (c) {launches}")
    want_counts = launch_counts(fused_mbconv=per_forward * calls_a, decode_feats_fused=calls_a,
                                sigmoid_pseudo_nms_fused=1)
    if (after_a != launch_counts(fused_mbconv=per_forward * calls_a, decode_feats_fused=calls_a)
            or launches != want_counts):
        raise AssertionError(f"[entry] launches {after_a}, {after_b}, {launches}; wanted {want_counts}")
    check_result(dets["bare"], gts, [(ENTRY_SIZE, ENTRY_SIZE)] * ENTRY_BATCH, "[entry] from_torch_pth fast engine")
    for form, d in dets.items():
        if not _same_dets(d, want):
            raise AssertionError(f"[entry] (a) the {form} .pth route differs from from_safetensors(FLAGSHIP)")
    if live.weights_version != v0 + 1 or _same_dets(before, want):
        raise AssertionError("[entry] (a) reload_weights(torch_pth_path=) did not swap the weights")
    log(f"[entry] (a) bare, state_dict, module. and foreign-renamed .pth and a reload_weights(torch_pth_path=) "
        f"bit-equal to from_safetensors(FLAGSHIP) at bs{ENTRY_BATCH}@{ENTRY_SIZE} ({sum(len(d.scores) for d in want)} "
        f"detections >= 0.05; {per_forward} B3 launches a forward)")
    if not _same_dets(lm_got, lm_want) or any(d.landmarks is None or len(d.scores) != 200 for d in lm_got):
        raise AssertionError("[entry] (b) the landmark .pth route differs from the variables route")
    log("[entry] (b) landmark twin .pth with use_pallas: B1 once, boxes, scores and landmarks bit-equal to the "
        "variables route")
    if not same_ported:
        raise AssertionError("[entry] (c) port_weights: the .safetensors differs from the flagship's")
    # the serving decode's K (`--max-dets`, 100): exactly tied zero scores
    # are ordered by the decode's chunks, which depend on K
    det_u8 = Detector.from_torch_pth(paths["bare"], DetectorConfig(decode=DecodeConfig(max_dets=100),
                                                                   default_size=ENTRY_SIZE))
    rng = np.random.RandomState(0)
    synth = np.stack([rng.randint(0, 255, (ENTRY_SIZE, ENTRY_SIZE, 3), np.uint8) for _ in range(n_serve)])
    b = ENTRY_SERVE_BATCH
    direct = []
    for s in range(0, n_serve, b):  # launches of b images, as the engine pads them
        chunk = np.zeros((b, ENTRY_SIZE, ENTRY_SIZE, 3), np.uint8)
        chunk[: len(synth[s:s + b])] = synth[s:s + b]
        direct += det_u8.detect_batch(chunk, score_thresh=-1.0)[: len(synth[s:s + b])]
    served = _served_lines(outs["u8"])
    if [r["image"] for r in served] != [f"synthetic_{i}" for i in range(n_serve)]:
        raise AssertionError("[entry] (c) serve wrote other images")
    if [{k: r[k] for k in ("boxes", "scores")} for r in served] != _lines_of(direct):
        raise AssertionError("[entry] (c) serve --out differs from a direct detect_batch")
    if _served_lines(outs["int8"]) != _served_lines(outs["packed"]):
        raise AssertionError("[entry] (c) serve --packed differs from the --int8 run that saved the artifact")
    if not (" fps" in demo_text and f"{ENTRY_DEMO_FRAMES} frames" in demo_text):
        raise AssertionError(f"[entry] (c) demo: {demo_text}")
    log(f"[entry] (c) port_weights equal; serve --out equal to detect_batch on {n_serve} images (K=100, "
        f"rounded as the CLI writes); --packed equal to --int8 --save-packed; demo ran")
    passes = layers["pass"] and boxes["worst_match_frac"] >= 0.9
    caught = not bad_layers["pass"] and bad_boxes["worst_match_frac"] < 0.9
    log(f"[entry] (c) parity at {size}, float32: {layers['n_layers_compared']} layers, worst |diff| "
        f"{layers['worst_abs_diff']:.3g}; boxes worst top-20 match {boxes['worst_match_frac']}; with heads.wh.out.bias "
        f"+3: worst |diff| {bad_layers['worst_abs_diff']:.3g}, match {bad_boxes['worst_match_frac']}")
    if not (passes and caught):
        raise AssertionError("[entry] (c) the parity gates: the clean flagship must pass and the corrupted fail")
    log(f"[entry] (d) {entry_cpp_nms()}")
    engines = summary["engines"]
    log(f"[entry] readings, serve on {n_serve} synthetic {ENTRY_SIZE} frames at {b} a launch, module forward ({smi}): "
        f"{summary['img_per_s']} images/s, wall {summary['wall_s']} s; engines "
        + json.dumps({hw: {k: st[k] for k in ("launches", "images", "latency_ms_p50", "latency_ms_p99")}
                      for hw, st in engines.items()}))
    shutil.rmtree(workdir, ignore_errors=True)
    return launches


# --------------------------------------------------------------------------- #
# [alternates]: the off-by-default stem, letterbox and 1x1 forms
# --------------------------------------------------------------------------- #

# The scale_and_translate letterbox (float32 on both devices) on the card
# against the port's CPU run of the same inputs: raw values reach ~280, where
# a float32 ulp is 3e-5 and the two devices sum in other orders.
ST_CARD_CPU_ATOL = 1e-3


def _stem_ms(det, x):
    """Device ms of `det`'s stem alone on the normalized NHWC batch `x` (the
    space-to-depth included for an s2d model)."""
    from tpucenterface_torch.model.backbone import space_to_depth

    bb = det.model.backbone

    def run():
        with torch.inference_mode():
            y = x.permute(0, 3, 1, 2).to(bb.dtype)
            return bb.stem(space_to_depth(y) if bb.s2d else y)

    return cuda_ms(run, 20)


def phase_alternates(cfg, det, det_f32, d640_module, x, smi):
    """Path l, the alternates that are off by default (`[alternates]`): (1)
    an s2d Detector (`ModelConfig(s2d_stem=True)`: the stem remapped after
    the bake, a 2x space-to-depth and a 2x2 stem, the module forward) with
    the fused decode against the standard stem's detections at bs32 @ 640;
    (2) the scale_and_translate letterbox (`resize_impl="scale_translate"`,
    cubic) on the card against the port's CPU run on letterboxed 640
    inputs, and a bilinear scale_translate Detector (the matmul letterbox's
    triangle) against the matmul letterbox's detections there; (3) a float32 planar Detector (the engine with no chain) against
    the float32 module forward, bs32 @ 640; (4) one `ConvBN(as_matmul=True)`
    forward against the conv forward on block 1's expand at bs32 @ 640.
    Returns the launch counts (B2 once a detect_batch call)."""
    import dataclasses

    from tpucenterface_torch import Detector, ModelConfig, PreprocessConfig
    from tpucenterface_torch.model.blocks import ConvBN
    from tpucenterface_torch.preprocess import letterbox_normalize_batch

    b640, g640 = paint_batch(1, 32, (640, 640))
    lb_imgs, lb_gts, lb_hws = letterboxed_batch(2)
    det_s2d = Detector.from_safetensors(FLAGSHIP, dataclasses.replace(cfg, model=ModelConfig(s2d_stem=True)))
    # cubic on its own against the CPU run; bilinear, the matmul letterbox's
    # own triangle, in the Detector held to the matmul letterbox's detections
    st_pre = PreprocessConfig(resize_impl="scale_translate", method="cubic")
    det_st = Detector.from_safetensors(FLAGSHIP, dataclasses.replace(
        cfg, preprocess=PreprocessConfig(resize_impl="scale_translate", method="bilinear")))
    planar_f32 = Detector.from_safetensors(
        FLAGSHIP, dataclasses.replace(cfg, model=ModelConfig(inference_engine="planar", compute_dtype="float32")))
    stem = det_s2d.variables["params"]["backbone"]["stem"]["conv"]["kernel"]
    if not (det_s2d.config.model.s2d_stem and np.shape(stem) == (2, 2, 12, 32) and det_s2d._engine is None):
        raise AssertionError(f"[alternates] the s2d Detector: config {det_s2d.config.model}, stem {np.shape(stem)}")
    if planar_f32._engine is None or planar_f32._engine.max_chain_res != 0:
        raise AssertionError("[alternates] the float32 planar Detector has no chainless planar engine")

    zero_launches()
    d_s2d = det_s2d.detect_batch(b640, score_thresh=0.05)
    d_st = det_st.detect_batch(lb_imgs, hws=lb_hws, score_thresh=0.05)
    d_planar = planar_f32.detect_batch(b640, score_thresh=0.05)
    launches = read_launches()
    log(f"[alternates] s2d, scale_translate and float32 planar detect_batch: kernel launches {launches}")
    if launches != launch_counts(decode_feats_fused=3):
        raise AssertionError(f"[alternates] launches {launches}: wanted B2 once a detect_batch call")

    # (1) the s2d stem against the 3x3 stem
    check_result(d_s2d, g640, [(640, 640)] * 32, "s2d Detector detect_batch bs32 640x640")
    n, bad = count_unmatched(d_s2d, d640_module)
    log(f"[alternates] (1) s2d against the 3x3 stem, bs32@640, detections >= {BF16_FIRM} without a partner within "
        f"{BF16_BOX_ATOL} px and {BF16_SCORE_ATOL} (both ways): {bad} of {n}")
    if n < 100 or bad > (1.0 - FAST_MATCH_SHARE) * n:
        raise AssertionError(f"[alternates] (1) the s2d Detector: {bad} of {n} detections differ from the 3x3 stem's")

    # (2) the scale_and_translate letterbox, card against CPU, and its detections
    with torch.inference_mode():
        card = letterbox_normalize_batch(torch.from_numpy(lb_imgs).cuda(), torch.from_numpy(lb_hws).cuda(), 640,
                                         st_pre, raw=True)
        cpu = letterbox_normalize_batch(torch.from_numpy(lb_imgs[:4]), torch.from_numpy(lb_hws[:4]), 640, st_pre,
                                        raw=True)
    err = max((card[0][:4].cpu() - cpu[0]).abs().max().item(), (card[1][:4].cpu() - cpu[1]).abs().max().item(),
              (card[2][:4].cpu() - cpu[2]).abs().max().item())
    check_result(d_st, lb_gts, lb_hws, "scale_translate Detector detect_batch bs32 letterboxed to 640")
    d_mm = det.detect_batch(lb_imgs, hws=lb_hws, score_thresh=0.05)
    n, bad = count_unmatched(d_st, d_mm)
    log(f"[alternates] (2) scale_translate letterbox (cubic, float32), card against CPU on 4 letterboxed 640 "
        f"images: max |diff| {err:.3g} (bound {ST_CARD_CPU_ATOL}); the bilinear scale_translate Detector against "
        f"the matmul letterbox's, bs32 letterboxed: {bad} of {n} detections >= {BF16_FIRM} without a partner")
    if err > ST_CARD_CPU_ATOL:
        raise AssertionError(f"[alternates] (2) the scale_translate letterbox: card and CPU {err} apart")
    if n < 100 or bad > (1.0 - FAST_MATCH_SHARE) * n:
        raise AssertionError(f"[alternates] (2) the scale_translate Detector: {bad} of {n} detections differ")

    # (3) the float32 planar Detector against the float32 module forward
    d_f32 = det_f32.detect_batch(b640, score_thresh=0.05)
    s_err = max((np.abs(a.scores - b.scores).max() if len(a.scores) else 0.0) for a, b in zip(d_planar, d_f32))
    b_err = max((np.abs(a.boxes - b.boxes).max() if len(a.boxes) else 0.0) for a, b in zip(d_planar, d_f32))
    same_n = all(len(a.scores) == len(b.scores) for a, b in zip(d_planar, d_f32))
    log(f"[alternates] (3) float32 planar engine (no chain) against the float32 module forward, bs32@640: "
        f"same counts {same_n}, max |score diff| {s_err:.3g}, max |box diff| {b_err:.3g} px")
    if not same_n or s_err > SCORE_ATOL or b_err > BOX_ATOL:
        raise AssertionError("[alternates] (3) the float32 planar Detector differs from the float32 module forward")

    # (4) as_matmul against the conv, block 1's expand (folded, bfloat16)
    expand = det.model.backbone.block_1.expand
    mm = ConvBN(expand.conv.in_channels, expand.conv.out_channels, kernel=1, folded=True, dtype=expand.dtype,
                as_matmul=True).cuda().requires_grad_(False)
    mm.conv.load_state_dict(expand.conv.state_dict())
    with torch.inference_mode():
        bb = det.model.backbone
        y = bb.block_0(bb.stem(x.permute(0, 3, 1, 2).to(bb.dtype)))
        got, want = mm(y), expand(y)
    diff = (got.float() - want.float()).abs()
    ulp = 2.0 ** -8 * want.float().abs().max().item()
    over = (diff > 2.0 ** -7 * want.float().abs() + ulp).sum().item()
    with torch.inference_mode():
        mm_ms, conv_ms = cuda_ms(lambda: mm(y), 20), cuda_ms(lambda: expand(y), 20)
    log(f"[alternates] (4) ConvBN(as_matmul=True) against the conv on block 1's expand {tuple(y.shape)} -> "
        f"{tuple(want.shape)} bfloat16: max |diff| {diff.max().item():.3g}, {over} values beyond one bfloat16 "
        f"step; ms matmul {mm_ms:.4f} against conv {conv_ms:.4f} ({smi})")
    if over:
        raise AssertionError(f"[alternates] (4) as_matmul: {over} values beyond one bfloat16 step of the conv")

    # readings: the s2d stem against the 3x3 stem, stem alone and whole forward
    with torch.inference_mode():
        x_s2d = x  # both take the same raw, stem-baked input
        fwd = {"3x3": cuda_ms(lambda: det._forward(x), 10), "s2d": cuda_ms(lambda: det_s2d._forward(x_s2d), 10)}
    stems = {"3x3": _stem_ms(det, x), "s2d": _stem_ms(det_s2d, x)}
    log(f"[alternates] readings bs32@640 ({smi}): stem alone ms {json.dumps(stems)}, forward ms {json.dumps(fwd)}")
    return launches


# --------------------------------------------------------------------------- #
# [dp]: data parallelism on a one-rank NCCL group
# --------------------------------------------------------------------------- #

DP_TRAIN_STEPS = 3


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _dp_serving(det, mesh, reqs, what):
    """`ServingEngine(mesh=)` at 32 a launch on `reqs` (32-image requests)
    against a direct `detect_batch` of each: bit for bit (one device: the
    same program on the same rows). Returns (engine launches, direct
    calls)."""
    from tpucenterface_torch.runtime.serving import ServingEngine

    with ServingEngine(det, (640, 640), device_batch=32, score_thresh=0.05, mesh=mesh) as eng:
        got = [f.result(timeout=SERVING_TIMEOUT_S) for f in [eng.submit(r) for r in reqs]]
        stats = eng.stats()
    want = [det.detect_batch(r, score_thresh=0.05) for r in reqs]
    same = all(_same_dets(a, b) for a, b in zip(got, want))
    log(f"[dp] ServingEngine(mesh=data_mesh()) on the {what}: {stats['launches']} launches of 32, pinned "
        f"{stats['pinned_launches']}; bit-equal to detect_batch: {same}")
    if not same or stats["launches"] != len(reqs) or stats["pinned_launches"]:
        raise AssertionError(f"[dp] the {what}: the DP engine differs from detect_batch or staged otherwise")
    return stats["launches"], len(reqs)


def _dp_train(mesh):
    """DP_TRAIN_STEPS `shard_train_step` steps at TRAIN_BATCH @ TRAIN_SIZE,
    each against `make_train_step` from the same state, under the bounds of
    `[train]`'s check 1 (`check_step_against`; the gradients read from
    Adam's first moment)."""
    from tpucenterface_torch.config import ModelConfig, TrainConfig
    from tpucenterface_torch.model.centernet import CenterFaceNet
    from tpucenterface_torch.runtime.sharding import put_sharded
    from tpucenterface_torch.train import step as ts
    from tpucenterface_torch.weights.io import load_safetensors

    tcfg = TrainConfig(input_size=TRAIN_SIZE, batch_size=TRAIN_BATCH, max_objs=32, lr=2e-3, ema_decay=0.999,
                       grad_clip_norm=5.0)
    tx = ts.make_optimizer(tcfg)
    step = ts.make_train_step(CenterFaceNet(ModelConfig(compute_dtype="float32")), tx, tcfg)
    state = ts.train_state_from_variables(load_safetensors(FLAGSHIP), tx, ema=True, device="cuda")
    dstep, state = ts.shard_train_step(step, mesh, state)
    b1 = 0.9
    for k in range(DP_TRAIN_STEPS):
        batch = stack_samples(train_samples(70 + k, TRAIN_BATCH, TRAIN_SIZE, tcfg.max_objs))
        mu0 = _np_tree(state.opt_state["mu"])
        out = {}
        for name, run, feed in (("dp", dstep, put_sharded(batch, mesh)), ("plain", step, to_device(batch, "cuda")),
                                ("plain again", step, to_device(batch, "cuda"))):
            new, metrics = run(state, feed)
            mu = _np_tree(new.opt_state["mu"])
            grads = {p: (mu[p] - b1 * mu0[p]) / (1 - b1) for p in mu}
            out[name] = (grads, {k2: float(v) for k2, v in metrics.items()}, _np_tree(new.params),
                         _np_tree(new.batch_stats), _np_tree(new.ema_params)), new
        apart = {name: max(float(np.abs(out[name][0][2][p] - out["plain"][0][2][p]).max()) / tcfg.lr
                           for p in out["plain"][0][2]) for name in ("dp", "plain again")}
        log(f"[dp] step {k + 1}: largest |param difference| / lr against the plain step: DP {apart['dp']:.3g}, the "
            f"plain step run again from the same state {apart['plain again']:.3g} (cuDNN's default algorithms)")
        check_step_against(out["dp"][0], out["plain"][0], tcfg.lr,
                           f"[dp] step {k + 1} of {DP_TRAIN_STEPS}, shard_train_step against make_train_step, "
                           f"bs{TRAIN_BATCH}@{TRAIN_SIZE}")
        state = out["dp"][1]


def phase_dp(det, det_fast, smi):
    """Path m, data parallelism (`[dp]`, `runtime/sharding.py`) on a
    one-rank NCCL process group (a free local port): (1)
    `ServingEngine(mesh=data_mesh())` against a direct `detect_batch` on the
    module forward (B2) and on the fast engine (B2, B3); (2)
    DP_TRAIN_STEPS `shard_train_step` steps (the BatchNorm moments, loss
    normalizers, gradients and metrics all-reduced) against
    `make_train_step`; (3) `prefetch_to_device(sharding=batch_sharding(mesh))`
    keeps the order and puts each batch on the mesh's card. The group is
    destroyed at the end. Returns the launch counts."""
    import torch.distributed as dist

    from tpucenterface_torch.runtime.prefetch import prefetch_to_device
    from tpucenterface_torch.runtime.sharding import ShardedTensor, batch_sharding, data_mesh, maybe_init_distributed

    if not maybe_init_distributed(coordinator_address=f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0):
        raise AssertionError("[dp] no process group")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"[dp] the group's backend is {dist.get_backend()}, not NCCL")
        mesh = data_mesh()
        log(f"[dp] process group: backend nccl, world {dist.get_world_size()}, mesh {mesh}")
        if (mesh.size, mesh.devices) != (1, (torch.device("cuda", torch.cuda.current_device()),)):
            raise AssertionError(f"[dp] mesh {mesh}")
        reqs = [paint_batch(80 + i, 32, (640, 640))[0] for i in range(2)]
        zero_launches()
        lm, cm = _dp_serving(det, mesh, reqs, "module forward")
        lf, cf = _dp_serving(det_fast, mesh, reqs, "fast engine")
        launches = read_launches()
        blocks = len(det_fast._engine.kernel_blocks(640))
        want = launch_counts(decode_feats_fused=lm + cm + lf + cf, fused_mbconv=blocks * (lf + cf))
        log(f"[dp] (1) kernel launches {launches}")
        if launches != want:
            raise AssertionError(f"[dp] (1) launches {launches}; wanted {want}")
        _dp_train(mesh)
        batches = [{"x": np.full((TRAIN_BATCH, 4), i, np.float32)} for i in range(5)]
        out = list(prefetch_to_device(iter(batches), size=2, sharding=batch_sharding(mesh)))
        ok = len(out) == 5 and all(
            isinstance(b["x"], ShardedTensor) and b["x"].devices == mesh.devices
            and float(b["x"].shards[0][0, 0]) == i and b["x"].shape == (TRAIN_BATCH, 4) for i, b in enumerate(out))
        log(f"[dp] (3) prefetch_to_device(sharding=) order and device: {ok}")
        if not ok:
            raise AssertionError("[dp] (3) prefetch_to_device(sharding=) lost the order or the device")
    finally:
        dist.destroy_process_group()
    log(f"[dp] passed on {smi}")
    return launches


def _bench_suite(det, det_fast):
    """`cli/bench_suite.py`'s configs 1-4 on the fast engine and config 5 on
    the module forward, over a one-rank NCCL group (as `[dp]`), with the
    flagship's weights and the fused decode; each config's JSON line."""
    import torch.distributed as dist

    from tpucenterface_torch.cli import bench_suite

    log(f"[bench] cuts: configs 2 and 5 time {BENCH_ITERS} launches a rate (the suite's 100); configs 1, 3 "
        "and 4 run at the suite's counts (20 calls, 256 TTA images, 60 frames)")
    runs = ((1, lambda: bench_suite.config1_single_320(det_fast)),
            (2, lambda: bench_suite.config2_batch640(det_fast, iters=BENCH_ITERS)),
            (3, lambda: bench_suite.config3_tta(det_fast)),
            (4, lambda: bench_suite.config4_video(det_fast)))
    for n, run in runs:
        t0 = time.perf_counter()
        out = run()
        log(f"[bench] config {n} ({time.perf_counter() - t0:.1f} s): " + json.dumps({"config": n, **out}))
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        t0 = time.perf_counter()
        out = bench_suite.config5_dp(det, iters=BENCH_ITERS)
        log(f"[bench] config 5 ({time.perf_counter() - t0:.1f} s, backend {dist.get_backend()}): "
            + json.dumps({"config": 5, **out}))
    finally:
        dist.destroy_process_group()
    if out["int8_img_s"] is None:
        raise AssertionError(f"[bench] config 5: no int8 variant ({out['int8_unavailable']})")


def _check_share(what, v, tag="[bench]"):
    if v is None or not 0.0 <= v <= 1.0:
        raise AssertionError(f"{tag} {what} = {v}, not a share in [0, 1]")


def phase_bench(det, det_fast, smi):
    """Path n, the measurement tools (`[bench]`, `bench/`, `cli/bench_suite.py`):
    (1) `bench_suite` configs 1-5 (`_bench_suite`): B2 and B3 launched, no
    other kernel; (2) `profile_detect_program` at bs128 @ 640, identity, K =
    100, bf16: roofline, sections, the top ten ops; `mfu` and `hbm_frac` in
    [0, 1], the total device ms within BENCH_TOTAL_RTOL of the same
    program's CUDA-event time; then the eval flip program's top three ops
    at bs64 @ 640 and the calls that launched them; (3) `roofline_of_fn` of the module forward
    and of the fast engine at bs32 @ 640: GFLOP within BENCH_GFLOP_RTOL;
    (4) `profile_forward` at bs32 @ 640: the blocks' sum within
    BENCH_BLOCKS_RATIO of the whole forward; (5) `sweep_preset` on small,
    default and large; (6) `slo_sweep` on the module forward at 128 a launch,
    requests of 32, loads 0.5 and 0.95. Returns the launch counts of (1)-(6),
    set to 0 just before (1) and read just after (6)."""
    from tpucenterface_torch import Detector, DetectorConfig
    from tpucenterface_torch.bench.op_profile import capture_trace, kernel_owners, op_profile_table, profile_detect_program
    from tpucenterface_torch.bench.preset_sweep import sweep_preset
    from tpucenterface_torch.bench.profile_forward import profile
    from tpucenterface_torch.bench.roofline import roofline_of_fn
    from tpucenterface_torch.bench.slo_sweep import slo_sweep
    from tpucenterface_torch.bench.timing import op_time_ms
    from tpucenterface_torch.detector import stage_inputs

    t_phase = time.perf_counter()
    zero_launches()
    _bench_suite(det, det_fast)
    suite = read_launches()
    log(f"[bench] (1) kernel launches of the suite {suite}")
    if not suite["decode_feats_fused"] or not suite["fused_mbconv"] or any(
            n for k, n in suite.items() if k not in ("decode_feats_fused", "fused_mbconv")):
        raise AssertionError(f"[bench] (1) launches {suite}: B2 and B3, and no other kernel")

    # (2) the canonical serving program, profiled; then its CUDA-event time
    t0 = time.perf_counter()
    logdir = tempfile.mkdtemp(prefix="tcf_bench_")
    prof = profile_detect_program(batch=128, size=640, max_dets=100, identity=True, logdir=logdir)
    owners = kernel_owners(sorted(glob.glob(os.path.join(logdir, "*.json"))))
    shutil.rmtree(logdir)
    log(f"[bench] (2) profile_detect_program bs128 @ 640 ({time.perf_counter() - t0:.1f} s): total_ms "
        f"{prof['total_ms']} img_per_s {prof['img_per_s']} roofline {json.dumps(prof['roofline'])}")
    log(f"[bench] (2) sections {json.dumps(prof['sections'])}; by category {json.dumps(prof['by_category_ms'])}")
    for r in prof["top_ops"][:10]:
        launched_by = owners.get(r["name"], {})
        log(f"[bench] (2) top op {r['ms_per_iter']:.4f} ms {r['category']}: {r['name'][:110]} "
            f"({r['gflops_per_iter']:.3f} GFLOP, {r['gbytes_per_iter']:.4f} GB, x{r['occurrences']}; launched by "
            f"{json.dumps(launched_by)})")
    _check_share("mfu", prof["roofline"]["mfu"])
    _check_share("hbm_frac", prof["roofline"]["hbm_frac"])
    ref = Detector(config=DetectorConfig())  # the same random weights (seed 0)
    rng = np.random.RandomState(0)
    fn, fmt = ref._batch_fn_auto(128, (640, 640), 640, identity=True, max_dets=100)
    im, hw = stage_inputs(fmt, rng.randint(0, 255, (128, 640, 640, 3), np.uint8),
                          np.full((128, 2), 640, np.int32), ref.device)
    event_ms = op_time_ms(fn, im, hw, k_pair=(2, 6))
    log(f"[bench] (2) the same program between CUDA events: {event_ms:.3f} ms a call; profile total "
        f"{prof['total_ms']} ms ({prof['total_ms'] / event_ms:.3f})")
    if abs(prof["total_ms"] / event_ms - 1.0) > BENCH_TOTAL_RTOL:
        raise AssertionError(f"[bench] (2) profile total {prof['total_ms']} ms against {event_ms:.3f} ms")
    del ref, fn, fmt, im, hw
    # the eval path's flip program (bs64 @ 640, letterboxed: one forward of
    # 128 images), profiled for its top ops and the calls that launched them
    lb_imgs, _, lb_hws = letterboxed_batch(91)
    flip_in = tuple(torch.from_numpy(np.concatenate([a, a])).cuda() for a in (lb_imgs, lb_hws))
    logdir = tempfile.mkdtemp(prefix="tcf_bench_")
    paths = capture_trace(det._batch_flip_fn(64, (640, 640), 640), flip_in, logdir)
    rows, owners = op_profile_table(paths), kernel_owners(paths)
    shutil.rmtree(logdir)
    total = sum(r["ms_per_iter"] for r in rows)
    for r in rows[:3]:
        log(f"[bench] (2) eval flip program bs64 @ 640 ({total:.3f} ms a call): top op {r['ms_per_iter']:.4f} ms "
            f"{r['category']}: {r['name'][:110]} (x{r['occurrences']}; launched by "
            f"{json.dumps(owners.get(r['name'], {}))})")
    del flip_in

    # (3) one count of work on two implementations
    imgs, _ = paint_batch(90, 32, (640, 640))
    with torch.inference_mode():
        x = normalize_raw(det, imgs, "cuda")
    roof = {name: roofline_of_fn(lambda x, d=d: d._forward(x), (x,))
            for name, d in (("module", det), ("fast", det_fast))}
    for name, r in roof.items():
        log(f"[bench] (3) roofline_of_fn {name} forward bs32 @ 640: "
            + json.dumps({k: v for k, v in r.items() if k != "sections"}) + f" sections {json.dumps(r['sections'])}")
        _check_share(f"{name} mfu", r["mfu"])
        _check_share(f"{name} hbm_frac", r["hbm_frac"])
    gm, gf = roof["module"]["gflops"], roof["fast"]["gflops"]
    log(f"[bench] (3) GFLOP module {gm} fast {gf}: apart {abs(gm - gf) / gm:.2e} of the module's "
        f"(bound {BENCH_GFLOP_RTOL})")
    if not gm or abs(gm - gf) > BENCH_GFLOP_RTOL * gm:
        raise AssertionError(f"[bench] (3) GFLOP module {gm}, fast engine {gf}")

    # (4) per-section times of the module forward
    t0 = time.perf_counter()
    rows = profile(batch=32, size=640)
    blocks = sum(ms for name, ms in rows.items() if name.startswith("block_"))
    ratio = blocks / rows["FULL forward"]
    log(f"[bench] (4) profile_forward bs32 @ 640 ({time.perf_counter() - t0:.1f} s): " + json.dumps(rows)
        + f"; blocks {blocks:.3f} ms, whole forward {rows['FULL forward']:.3f} ms ({ratio:.3f})")
    if not 1.0 / BENCH_BLOCKS_RATIO <= ratio <= BENCH_BLOCKS_RATIO:
        raise AssertionError(f"[bench] (4) the blocks sum to {ratio:.3f} times the whole forward")

    # (5) the width presets
    log(f"[bench] (5) cuts: sweep_preset {BENCH_PRESET_ITERS} launches a pass, {BENCH_PRESET_PASSES} passes "
        "(the sweep's 100, 3)")
    for name in ("small", "default", "large"):
        t0 = time.perf_counter()
        out = sweep_preset(name, iters=BENCH_PRESET_ITERS, passes=BENCH_PRESET_PASSES)
        log(f"[bench] (5) ({time.perf_counter() - t0:.1f} s) " + json.dumps(out))
        if out["serving_int8_img_s"] is None:
            raise AssertionError(f"[bench] (5) {name}: no int8 reading ({out['int8_unavailable']})")

    # (6) the latency curve
    log(f"[bench] (6) cuts: slo_sweep {BENCH_SLO_SECONDS} s a load point (the sweep's 8)")
    t0 = time.perf_counter()
    slo = slo_sweep(det, (640, 640), request_bs=32, device_batch=128, fractions=(0.5, 0.95), seconds=BENCH_SLO_SECONDS)
    log(f"[bench] (6) slo_sweep ({time.perf_counter() - t0:.1f} s): " + json.dumps(slo))
    if not slo["saturation_img_s"] > 0 or any(not (pt["achieved_requests"] and pt["p99_ms"]) for pt in slo["loaded"]):
        raise AssertionError(f"[bench] (6) slo_sweep {slo}")
    launches = read_launches()
    log(f"[bench] kernel launches {launches}")
    if any(n for k, n in launches.items() if k not in ("decode_feats_fused", "fused_mbconv")):
        raise AssertionError(f"[bench] launches {launches}: a kernel that no tool's path runs")
    log(f"[bench] passed in {time.perf_counter() - t_phase:.1f} s on {smi}")
    return launches


def check_headline_int8_input(det, imgs128, hws128, smi):
    """C5 on the card's host and the int8-input program against the uint8
    one: the C++ table staging (`apply_stem_lut`, nthreads=0) on the 128
    frames equal to the numpy loop (`apply_stem_lut_plain`) byte for byte,
    both timed; then, quantized as `cli/bench.py` quantizes, the int8-input
    serving program on the staged frames against the uint8 program on the
    raw ones: boxes and scores equal bit for bit."""
    from tpucenterface_torch.detector import stage_inputs
    from tpucenterface_torch.quant.engine import apply_stem_lut, apply_stem_lut_plain

    b, side = imgs128.shape[:2]
    det.quantize(calib_images=imgs128[:8], int8_dw=True)  # the first 8 of the 32 frames, as measure does
    try:
        lut = det.stem_input_lut()
        cpp_s, plain_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            i8 = apply_stem_lut(imgs128, lut)
            cpp_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        plain = apply_stem_lut_plain(imgs128, lut)
        plain_s.append(time.perf_counter() - t0)
        same = i8.tobytes() == plain.tobytes()
        del plain
        log(f"[headline] C5: apply_stem_lut (C++, nthreads=0, {os.cpu_count()} CPUs) on {imgs128.shape} "
            f"({imgs128.nbytes / 1e6:.1f} MB): {min(cpp_s) * 1e3:.2f} ms (best of 3; "
            f"{', '.join(f'{t * 1e3:.2f}' for t in cpp_s)}), apply_stem_lut_plain {plain_s[0] * 1e3:.2f} ms; "
            f"equal byte for byte: {same}")
        if not same:
            raise AssertionError("[headline] C5: the C++ table staging differs from the numpy loop")
        outs = []
        for int8_in, images in ((False, imgs128), (True, i8)):
            fn, fmt = det._batch_fn_auto(b, (side, side), side, identity=True, max_dets=100, int8_in=int8_in)
            outs.append(tuple(t.cpu() for t in fn(*stage_inputs(fmt, images, hws128, det.device))))
        del i8
    finally:
        det.dequantize()
    (boxes, scores), (boxes_i8, scores_i8) = outs
    differ = sum(not (torch.equal(boxes[i], boxes_i8[i]) and torch.equal(scores[i], scores_i8[i])) for i in range(b))
    log(f"[headline] the int8-input program against the uint8 int8 program, bs{b} @ {side}, K = 100: {differ} of "
        f"{b} images differ (bit for bit); scores >= 0.1: {int((scores >= 0.1).sum())} on {smi}")
    if differ or boxes.shape != (b, 100, 4) or not torch.isfinite(boxes).all():
        raise AssertionError(f"[headline] the int8-input program differs from the uint8 one on {differ} images")


def phase_headline(smi):
    """Path o, the headline (`[headline]`, `cli/bench.py`, the counterpart of
    the root `bench.py`): `measure` on a default Detector (random weights,
    module forward, reference decode, the library int8 route) at bench.py's
    sizes, its counts cut to HEADLINE_*: every key of bench.py's line, the
    two `*vs_baseline` null, the four rates finite and positive inside their
    spreads, the four roofline shares in [0, 1], both section tables
    non-empty; then `check_headline_int8_input`. At these defaults the
    headline launches none of the port's kernels. Returns the launch counts
    of the phase, set to 0 just before it and read just after."""
    from tpucenterface_torch import Detector, DetectorConfig
    from tpucenterface_torch.cli.bench import frames, measure

    t_phase = time.perf_counter()
    zero_launches()
    det = Detector(config=DetectorConfig())
    log(f"[headline] cuts: {HEADLINE_ITERS} launches of the bs32 program a pass (bench.py's BENCH_ITERS 100), "
        f"{HEADLINE_SERVE_ITERS} launches of each bs128 serving program a pass (200), {HEADLINE_PASSES} passes "
        "(BENCH_PASSES 5)")
    out = measure(det, iters=HEADLINE_ITERS, passes=HEADLINE_PASSES, serve_iters=HEADLINE_SERVE_ITERS)
    log(f"[headline] measure took {time.perf_counter() - t_phase:.1f} s; its line:")
    log("[headline] " + json.dumps(out))
    if set(out) != set(HEADLINE_KEYS):
        raise AssertionError(f"[headline] keys {sorted(set(out) ^ set(HEADLINE_KEYS))} differ from bench.py's")
    if out["vs_baseline"] is not None or out["serving_int8_vs_baseline"] is not None:
        raise AssertionError("[headline] a vs_baseline is set: no card target exists")
    for rate, spread in (("value", "value_spread"), ("serving_coalesced_img_s", "serving_coalesced_spread"),
                         ("serving_int8_img_s", "serving_int8_spread"),
                         ("serving_int8in_img_s", "serving_int8in_spread")):
        v, (lo, hi) = out[rate], out[spread]
        if not (np.isfinite(v) and v > 0 and lo <= v <= hi):
            raise AssertionError(f"[headline] {rate} {v}, spread {[lo, hi]}")
    for share in ("serving_mfu", "serving_hbm_frac", "serving_int8_mfu", "serving_int8_hbm_frac"):
        _check_share(share, out[share], "[headline]")
    if not out["serving_sections"] or not out["serving_int8_sections"]:
        raise AssertionError("[headline] a section table is empty")
    imgs, hws = frames(32, 640)
    check_headline_int8_input(det, np.tile(imgs, (4, 1, 1, 1)), np.tile(hws, (4, 1)), smi)
    launches = read_launches()
    log(f"[headline] kernel launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"[headline] launches {launches}: the headline's defaults run none of the kernels")
    log(f"[headline] passed in {time.perf_counter() - t_phase:.1f} s on {smi}")
    return launches


def normalize_raw(det, imgs, dev):
    """The identity-path input of `det` for uint8 images at its size."""
    from tpucenterface_torch.preprocess import normalize_images

    return normalize_images(torch.from_numpy(imgs).to(dev), det.config.preprocess, raw=det.config.model.stem_preprocess)


def letterboxed_batch(seed):
    """32 images of mixed content sizes zero-padded to one 640x640 bucket:
    the letterbox resize runs for each."""
    rng = np.random.RandomState(seed)
    sizes = [(480, 640), (640, 480), (360, 640), (512, 512)]
    imgs = np.zeros((32, 640, 640, 3), np.uint8)
    gts, hws = [], []
    for i in range(32):
        h, w = sizes[i % len(sizes)]
        img, g = paint_scene(rng, (h, w), 3)
        imgs[i, :h, :w] = img
        gts.append(g)
        hws.append((h, w))
    return imgs, gts, np.array(hws, np.int32)


def bound(nbytes, ops_by_rate):
    """(least ms the card could take, what bounds it): the bytes over the HBM
    rate against each (operations, peak rate) pair; work on different pipes
    can overlap, so the largest single term is the bound."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(ops / rate * 1e3 for ops, rate in ops_by_rate)
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def times_decode(det_feats):
    """The decode kernel at the main path's heads (bs32@640, K=200), and at
    one 640 image and DECODE_TIMED_SHAPES: one call between CUDA events (the
    wrapper's host time included), beside the bound, the plain version and
    the reference decode with the two-stage top-K."""
    from tpucenterface_torch.config import DecodeConfig
    from tpucenterface_torch.decode.fused_decode import decode_feats_fused, decode_feats_fused_plain
    from tpucenterface_torch.decode.reference import decode_feats_with_idx

    cfg = DecodeConfig(max_dets=200)
    lib_cfg = DecodeConfig(max_dets=200, fast_topk=True)
    gen = torch.Generator().manual_seed(17)
    heads = [det_feats, {name: t[:1] for name, t in det_feats.items()}]
    heads += [_random_feats(gen, *shape, det_feats["hm"].device) for shape in DECODE_TIMED_SHAPES]
    shapes = []
    for feats in heads:
        b, h, w, _ = feats["hm"].shape
        k = min(cfg.max_dets, h * w)
        # least work: hm read once, wh/off read at the K peaks, boxes, scores and
        # indices written once; per cell the sigmoid (4), 8 window maxima and the
        # peak select, float32
        nbytes = b * h * w * 4 + b * k * 4 * 4 + b * k * (4 + 1 + 1) * 4
        bound_ms, bound_by = bound(nbytes, [(b * h * w * 13, F32_OPS_PER_S)])
        shapes.append({
            "heads": [b, h, w], "k": k,
            "ms": cuda_ms(lambda: decode_feats_fused(feats, cfg), iters=50),
            "plain_ms": cuda_ms(lambda: decode_feats_fused_plain(feats, cfg), iters=50),
            "library_ms": cuda_ms(lambda: decode_feats_with_idx(feats, lib_cfg), iters=50),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
    return {**{key: shapes[0][key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "shapes": shapes}


def times_mbconv(det, block_inputs):
    """The MBConv kernel at each main-path shape (batch 32, 640x640 input)
    beside its bound, its plain version and the port's `InvertedResidual`
    module on the same block (cuDNN convolutions), and their sums over the
    ten launches of one forward. `ms`: one call on packed weights (as the
    fast engine calls it) between CUDA events; `unpacked_ms`: one call on the
    six weights (packed on every call); `device_ms`: calls on packed weights
    back to back."""
    from tpucenterface_torch.ops.fused_mbconv import (
        fused_mbconv,
        fused_mbconv_plain,
        pack_fused_mbconv,
        plan_fused_mbconv,
    )

    shapes = []
    for i, (x, args, skip) in block_inputs.items():
        b, h, w, cin = x.shape
        ce, cout = args[2].shape[-1], args[4].shape[-1]
        mod = getattr(det.model.backbone, f"block_{i}")
        x_nchw = x.permute(0, 3, 1, 2)
        pos = b * h * w
        # x read once, out written once, the weights and biases read once
        nbytes = 2 * (pos * (cin + cout) + (cin * ce if args[0] is not None else 0) + 9 * ce + ce * cout
                      + 2 * ce + cout)
        products = 2 * pos * ((cin * ce if args[0] is not None else 0) + ce * cout)
        bound_ms, bound_by = bound(nbytes, [(products, BF16_TC_OPS_PER_S), (2 * pos * 9 * ce, F32_OPS_PER_S)])
        packed = pack_fused_mbconv(*args)
        plan = plan_fused_mbconv(b, h, w, cin, ce, cout, args[0] is not None)
        with torch.inference_mode():
            shapes.append({
                "block": i, "blocks_per_forward": MBCONV_BLOCKS_640[i], "x": [b, h, w, cin], "ce": ce, "cout": cout,
                "skip": bool(skip), "plan": mbconv_plan_desc(plan),
                "ms": cuda_ms(lambda: fused_mbconv(x, packed, skip=skip), iters=30),
                "unpacked_ms": cuda_ms(lambda: fused_mbconv(x, *args, skip=skip), iters=30),
                "device_ms": back_to_back_ms(lambda: fused_mbconv(x, packed, skip=skip)),
                "plain_ms": cuda_ms(lambda: fused_mbconv_plain(x, *args, skip=skip), iters=5, warmup=1),
                "library_ms": cuda_ms(lambda: mod(x_nchw), iters=30),
                "bound_ms": bound_ms, "bound_by": bound_by,
            })
    total = {k: sum(sh[k] * sh["blocks_per_forward"] for sh in shapes)
             for k in ("ms", "unpacked_ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}
    by = {w: sum(sh["bound_ms"] * sh["blocks_per_forward"] for sh in shapes if sh["bound_by"] == w)
          for w in ("bytes", "operations")}
    # the totals are those of one bs32@640 forward (ten launches); the bound is
    # the sum of each launch's own, named after the larger part of it
    return {**total, "bound_by": max(by, key=by.get), "shapes": shapes}


def times_nms():
    """The sigmoid + pseudo-NMS kernel at (32, 160, 160): one call between
    CUDA events (`ms`, the wrapper's host time included) and the device time
    a call (`device_ms`, calls back to back in a CUDA graph)."""
    from tpucenterface_torch.decode.fused_nms import sigmoid_pseudo_nms_fused, sigmoid_pseudo_nms_plain
    from tpucenterface_torch.decode.reference import pseudo_nms

    hm = 3.0 * torch.randn(32, 160, 160, generator=torch.Generator().manual_seed(5)).cuda()
    cells = hm.numel()
    # logits read once, scores written once; per cell nine sigmoids (4 each),
    # eight maxima and the select
    bound_ms, bound_by = bound(2 * cells * 4, [(cells * 45, F32_OPS_PER_S)])
    return {
        "ms": cuda_ms(lambda: sigmoid_pseudo_nms_fused(hm), iters=50),
        "device_ms": graph_ms(lambda: sigmoid_pseudo_nms_fused(hm)),
        "plain_ms": cuda_ms(lambda: sigmoid_pseudo_nms_plain(hm), iters=50),
        "library_ms": cuda_ms(lambda: pseudo_nms(torch.sigmoid(hm)), iters=50),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def _block_work(pos, cin, blk):
    """(weight bytes, product operations, depthwise operations) of one block
    over `pos` positions: w1 and w2 in bfloat16, wd and the biases in float32."""
    ce, cout = blk["wd"].shape[-1], blk["w2"].shape[-1]
    expand = cin * ce if blk["w1"] is not None else 0
    wbytes = 2 * (expand + ce * cout) + 4 * (9 * ce + ce + cout + (ce if blk["w1"] is not None else 0))
    return wbytes, 2 * pos * (expand + ce * cout), 2 * pos * 9 * ce


def times_planar(chains, singles):
    """The planar chain kernel (B4b) at every chain of the planar engine
    (`chains`), and the one-block kernel (B4a), which is on no path, at
    blocks 0 and 2 of a 640 input (`singles`) and at each 640 chain's first
    block, batch 32, beside their bounds, their plain versions and the port's
    `InvertedResidual` modules over the same blocks (cuDNN convolutions). Both
    wrappers are timed on packed weights; B4a's entries carry its planner's
    plan and its device time (calls back to back). B4b's totals are those of
    one bs32@640 forward (three launches), B4a's those of blocks 0 and 2.
    Bytes: x and out once (bfloat16) and every weight once."""
    from tpucenterface_torch.ops.planar_mbconv import (
        nhwc_from_planar, pack_planar_chain, planar_mbconv, planar_mbconv_chain, planar_mbconv_chain_plain,
        planar_mbconv_plain,
    )

    def run_modules(mods, y):
        for m in mods:
            y = m(y)
        return y

    one, many = [], []
    for ch, single in [(ch, True) for ch in singles] + [(ch, False) for ch in chains]:
        x, h, w, blocks = ch["x"], ch["H"], ch["W"], ch["blocks"]
        b, c0, _ = x.shape
        pos = b * h * w
        y = nhwc_from_planar(x, h, w).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        packed = pack_planar_chain(blocks, c0, x.device)
        work, cin = [], c0
        for blk in blocks:
            work.append(_block_work(pos, cin, blk))
            cin = blk["w2"].shape[-1]
        nbytes = 2 * pos * (c0 + cin) + sum(wk[0] for wk in work)
        bound_ms, bound_by = bound(nbytes, [(sum(wk[1] for wk in work), BF16_TC_OPS_PER_S),
                                            (sum(wk[2] for wk in work), F32_OPS_PER_S)])
        tag = {"blocks": [ch["first"], ch["first"] + ch["count"] - 1], "input": ch["size"], "x": [b, c0, h, w],
               "widths": [c0] + [blk["w2"].shape[-1] for blk in blocks]}
        with torch.inference_mode():
            if not single:
                many.append({
                    **tag,
                    "ms": cuda_ms(lambda: planar_mbconv_chain(x, packed, H=h, W=w), iters=20),
                    "plain_ms": cuda_ms(lambda: planar_mbconv_chain_plain(x, blocks, H=h, W=w), iters=3, warmup=1),
                    "library_ms": cuda_ms(lambda: run_modules(ch["modules"], y), iters=20),
                    "bound_ms": bound_ms, "bound_by": bound_by, "in_total": ch["size"] == 640,
                })
            if ch["size"] != 640:
                continue
            blk = blocks[0]
            args = [blk[k] for k in _BLOCK_KEYS]
            packed_one = pack_planar_chain(blocks[:1], c0, x.device)
            cout = blk["w2"].shape[-1]
            bound_ms, bound_by = bound(2 * pos * (c0 + cout) + work[0][0],
                                       [(work[0][1], BF16_TC_OPS_PER_S), (work[0][2], F32_OPS_PER_S)])
            one.append({
                "block": ch["first"], "input": ch["size"], "x": [b, c0, h, w], "ce": blk["wd"].shape[-1], "cout": cout,
                "plan": _planar_block_plan(x, packed_one, h, w).describe(),
                "ms": cuda_ms(lambda: planar_mbconv(x, packed_one, H=h, W=w), iters=20),
                "device_ms": back_to_back_ms(lambda: planar_mbconv(x, packed_one, H=h, W=w)),
                "plain_ms": cuda_ms(lambda: planar_mbconv_plain(x, *args, H=h, W=w, skip=blk["skip"]), iters=3, warmup=1),
                "library_ms": cuda_ms(lambda: ch["modules"][0](y), iters=20),
                "bound_ms": bound_ms, "bound_by": bound_by, "in_total": single,
            })

    def totals(shapes):
        at640 = [sh for sh in shapes if sh["in_total"]]
        total = {k: sum(sh[k] for sh in at640) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by = {wh: sum(sh["bound_ms"] for sh in at640 if sh["bound_by"] == wh) for wh in ("bytes", "operations")}
        return {**total, "bound_by": max(by, key=by.get), "shapes": shapes}

    return totals(one), totals(many)


def _int8_block_bound(x, a, stride):
    """(bound ms, by) of one int8 block launch: x and out once (int8 at
    stride 2, bf16 at stride 1), the weights once; every operation is on int8
    operands (the expand at the input's positions, the depthwise's nine
    multiply-adds an output, the project), so all of them at the card's int8
    peak."""
    b, h, w, cin = x.shape
    cmid, cout = a["we"].shape[0], a["wp"].shape[0]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    esize = x.element_size()
    nbytes = esize * (b * h * w * cin + b * ho * wo * cout) + cmid * cin + cout * cmid + 9 * cmid * 4 + 4 * (6 * cmid + 2 * cout)
    products = 2 * (b * h * w * cin * cmid + b * ho * wo * cmid * cout)
    return bound(nbytes, [(products + 2 * 9 * b * ho * wo * cmid, INT8_TC_OPS_PER_S)])


def times_int8(inputs, eng):
    """The three int8 kernels at their flagship shapes (bs32@640) beside their
    bounds, their plain versions and the engine's library route over the same
    conv or block (`QuantEngine._conv` / `run_block`: torch._int_mm, int32
    depthwise sums and elementwise epilogues; for a block it starts from the
    bf16 input and ends at the bf16 output, as the engine does). B6's and
    B7's totals are over the blocks of one forward (four and ten)."""
    from tpucenterface_torch.ops.int8_block import (
        fused_block_int8_plain, fused_block_s1_plain, int8_block_s1, int8_block_s2, plan_int8_block_s2,
    )
    from tpucenterface_torch.ops.int8_conv import conv1x1_int8_plain, int8_conv1x1, plan_int8_conv1x1

    out = {}
    x, a = inputs["b5"]
    b, cin, p = x.shape
    cout = a["w"].shape[0]
    bound_ms, bound_by = bound(b * p * (cin + cout) + cout * cin + 8 * cout, [(2 * b * p * cin * cout, INT8_TC_OPS_PER_S)])
    x_nhwc = inputs["b5_nhwc"]
    with torch.inference_mode():
        # B5's plan and device time a call (calls back to back), beside the one-call time
        out["int8_conv1x1"] = {
            "block": 0, "x": [b, cin, p], "cout": cout, "plan": plan_int8_conv1x1(b, cin, p, cout).describe(),
            "device_ms": back_to_back_ms(lambda: int8_conv1x1(x, **a)),
            "ms": cuda_ms(lambda: int8_conv1x1(x, **a), iters=50),
            "plain_ms": cuda_ms(lambda: conv1x1_int8_plain(x, **a), iters=10),
            "library_ms": cuda_ms(lambda: eng._conv("b0.project", "quant", x_nhwc, "none", out_int8_tag="b1.expand"),
                                  iters=30),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    b7 = {i: (x, a, lambda x=x, a=a, packed=packed: int8_block_s1(x, a["inv_se"], packed))
          for i, (x, a, packed) in inputs["b7"].items()}
    b6 = {i: (x, a, lambda x=x, packed=packed: int8_block_s2(x, packed)) for i, (x, a, packed) in inputs["b6"].items()}
    for name, runs, plain, stride in (("int8_block_s2", b6, fused_block_int8_plain, 2),
                                      ("int8_block_s1", b7, fused_block_s1_plain, 1)):
        shapes = []
        for i, (x, a, kernel) in runs.items():
            bound_ms, bound_by = _int8_block_bound(x, a, stride)
            y = inputs["ys"][i]
            cmid, cout = a["we"].shape[0], a["wp"].shape[0]
            # B6's plan and device time a call (calls back to back), beside the one-call time
            extra = {} if stride == 1 else {"plan": plan_int8_block_s2(*x.shape, cmid, cout).describe(),
                                            "device_ms": back_to_back_ms(kernel)}
            with torch.inference_mode():
                shapes.append({
                    "block": i, "x": list(x.shape), "cmid": cmid, "cout": cout, **extra,
                    "ms": cuda_ms(kernel, iters=20),
                    "plain_ms": cuda_ms(lambda: plain(x, **a), iters=5, warmup=1),
                    "library_ms": cuda_ms(lambda: eng.run_block(i, y), iters=20),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                })
        total = {k: sum(sh[k] for sh in shapes) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by = {w: sum(sh["bound_ms"] for sh in shapes if sh["bound_by"] == w) for w in ("bytes", "operations")}
        out[name] = {**total, "bound_by": max(by, key=by.get), "shapes": shapes}
    return out


def phase_times_quant(dets, det, inputs, x):
    """Times of the quantized path on the H100: detect_batch at bs32 and
    bs128 @ 640 on both routes in turns, each forward alone at bs32, the peak
    device memory of one bs128 batch on each route, torch.profiler summaries
    of one bs32 batch on each route, and the int8 kernels' times. The
    launches made here are not main-path launches: the counts are put back."""
    before = read_launches()
    b640, _ = paint_batch(6, 32, (640, 640))
    b128, _ = paint_batch(14, 128, (640, 640))
    lib, b7 = dets["library"], dets["b7"]
    times = {"library": {}, "b7": {}}
    for route, d in (("library", lib), ("b7", b7), ("b7", b7), ("library", lib)):
        times[route].setdefault("bs32", []).extend(cuda_times(lambda: d.detect_batch(b640, score_thresh=0.05), iters=10))
        times[route].setdefault("bs128", []).extend(cuda_times(lambda: d.detect_batch(b128, score_thresh=0.05), iters=4, warmup=1))
    peak = {}
    for route, d in (("library", lib), ("b7", b7)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        d.detect_batch(b128, score_thresh=0.05)
        peak[route] = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.inference_mode():
        order = ("module", "library", "b7", "b7", "library", "module")
        fwd = {"module": det, "library": lib, "b7": b7}
        fwd_ms = [cuda_ms(lambda d=fwd[name]: d._forward(x), iters=10) for name in order]
    prof = {route: device_profile(lambda d=d: d.detect_batch(b640, score_thresh=0.05))
            for route, d in (("library", lib), ("b7", b7))}
    ktimes = times_int8(inputs, lib._quant)
    for name, fn in kernel_wrappers().items():
        fn.launches = before[name]

    def spread(ts):
        return {"p50": float(np.median(ts)), "min": min(ts), "max": max(ts), "n": len(ts)}

    out = {}
    for route in ("library", "b7"):
        for bs, n in (("bs32", 32), ("bs128", 128)):
            ts = times[route][bs]
            out[f"quant_{route}_detect_batch_{bs}_640_ms"] = spread(ts)
            out[f"quant_{route}_detect_batch_{bs}_640_img_s"] = n * 1e3 / float(np.median(ts))
        out[f"quant_{route}_peak_memory_bs128_640_gib"] = peak[route]
        out[f"profile_quant_{route}_bs32_640"] = prof[route]
    out["forward_bs32_640_ms_runs_" + "_".join(order)] = fwd_ms
    log("[times] quant " + json.dumps(out))
    return out, ktimes


def phase_times(det, det_fast, det_planar, det_feats, block_inputs, chains, singles):
    """End-to-end times (pre-sized and letterboxed bs32@640, single 640) of
    the module forward and the pre-sized bs32@640 and single 640 of the fast
    and the planar engine, where the time goes at bs32@640 in each, and every
    kernel's times. The launches made here are not main-path launches: the
    counts are put back."""
    from tpucenterface_torch.preprocess import normalize_images

    before = read_launches()
    b640, _ = paint_batch(6, 32, (640, 640))
    lb_imgs, _, lb_hws = letterboxed_batch(8)
    one, _ = paint_batch(7, 1, (640, 640))
    batch = cuda_times(lambda: det.detect_batch(b640, score_thresh=0.05), iters=20)
    fast = cuda_times(lambda: det_fast.detect_batch(b640, score_thresh=0.05), iters=20)
    planar = cuda_times(lambda: det_planar.detect_batch(b640, score_thresh=0.05), iters=20)
    lbox = cuda_times(lambda: det.detect_batch(lb_imgs, hws=lb_hws, score_thresh=0.05), iters=20)
    # the three forwards in turns, twice: module, fast, planar, module, fast, planar
    singles_ms = {name: [] for name in ("module", "fast", "planar")}
    for name, d in (("module", det), ("fast", det_fast), ("planar", det_planar)) * 2:
        singles_ms[name] += cuda_times(lambda d=d: d.detect(one[0], score_thresh=0.05), iters=50)
    single, fast_single, planar_single = (singles_ms[name] for name in ("module", "fast", "planar"))

    planar_one, planar_many = times_planar(chains, singles)
    ktimes = {
        "decode_feats_fused": times_decode(det_feats),
        "fused_mbconv": times_mbconv(det, block_inputs),
        "sigmoid_pseudo_nms_fused": times_nms(),
        "planar_mbconv": planar_one,
        "planar_mbconv_chain": planar_many,
    }

    imgs = torch.from_numpy(b640).to("cuda")
    pp, raw = det.config.preprocess, det.config.model.stem_preprocess
    with torch.inference_mode():
        x = normalize_images(imgs, pp, raw=raw)
        # the three forwards in turns on one card
        order = ("module", "fast", "planar", "planar", "fast", "module")
        dets = {"module": det, "fast": det_fast, "planar": det_planar}
        fwd = [cuda_ms(lambda d=dets[name]: d._forward(x), iters=10) for name in order]
        stages = {
            "h2d_copy": cuda_ms(lambda: torch.from_numpy(b640).to("cuda"), iters=10),
            "preprocess": cuda_ms(lambda: normalize_images(imgs, pp, raw=raw), iters=10),
            "forward": fwd[0],
            "forward_runs_" + "_".join(order): fwd,
            "forward_fast_engine": fwd[1],
            "forward_planar_engine": fwd[2],
            "decode": ktimes["decode_feats_fused"]["ms"],
        }
    prof = device_profile(lambda: det.detect_batch(b640, score_thresh=0.05))
    prof_fast = device_profile(lambda: det_fast.detect_batch(b640, score_thresh=0.05))
    prof_planar = device_profile(lambda: det_planar.detect_batch(b640, score_thresh=0.05))
    for name, fn in kernel_wrappers().items():
        fn.launches = before[name]

    def spread(ts):
        return {"p50": float(np.median(ts)), "min": min(ts), "max": max(ts), "n": len(ts)}

    def tail(ts):
        return {"p50": float(np.median(ts)), "p90": float(np.percentile(ts, 90)), "n": len(ts)}

    times = {
        "detect_batch_bs32_640_ms": spread(batch),
        "detect_batch_bs32_640_img_s": 32e3 / float(np.median(batch)),
        "fast_engine_detect_batch_bs32_640_ms": spread(fast),
        "fast_engine_detect_batch_bs32_640_img_s": 32e3 / float(np.median(fast)),
        "detect_batch_bs32_640_letterbox_ms": spread(lbox),
        "detect_batch_bs32_640_letterbox_img_s": 32e3 / float(np.median(lbox)),
        "planar_engine_detect_batch_bs32_640_ms": spread(planar),
        "planar_engine_detect_batch_bs32_640_img_s": 32e3 / float(np.median(planar)),
        "detect_single_640_ms": tail(single),
        "fast_engine_detect_single_640_ms": tail(fast_single),
        "planar_engine_detect_single_640_ms": tail(planar_single),
        "stages_bs32_640_ms": stages,
        "profile_bs32_640": prof,
        "profile_fast_engine_bs32_640": prof_fast,
        "profile_planar_engine_bs32_640": prof_planar,
    }
    log("[times] " + json.dumps(times))
    return times, ktimes


def main() -> int:
    smi = phase_device()
    import dataclasses

    from tpucenterface_torch import DecodeConfig, Detector, DetectorConfig, ModelConfig
    from tpucenterface_torch.preprocess import normalize_images

    phase_build()
    cfg = DetectorConfig(decode=DecodeConfig(use_pallas=True))
    fast_cfg = dataclasses.replace(cfg, model=ModelConfig(inference_engine="fast"))
    det = Detector.from_safetensors(FLAGSHIP, cfg)
    det_fast = Detector.from_safetensors(FLAGSHIP, fast_cfg)
    feats_imgs, _ = paint_batch(0, 32, (640, 640))
    with torch.inference_mode():
        x = normalize_images(torch.from_numpy(feats_imgs).to("cuda"), det.config.preprocess, raw=True)
        det_feats = det._forward(x)
    block_inputs = mbconv_block_inputs(det, x)
    # the eval path's flip batches (bs64 and its mirror, the flip program's
    # 128-image forward) at 640 and at the TTA buckets of EVAL_MBCONV_SIZES,
    # and the `large` preset's blocks at bs32 @ 640
    more_inputs = {}
    for size in (640,) + EVAL_MBCONV_SIZES:
        if not set(MBCONV_BLOCKS_640) <= set(det_fast._engine.kernel_blocks(size)):
            raise AssertionError(f"[kernels] the fast engine's blocks at {size}: {det_fast._engine.kernel_blocks(size)}")
        imgs, _ = paint_batch(size, 64, (size, size))
        with torch.inference_mode():
            flip_x = normalize_raw(det, np.concatenate([imgs, imgs[:, :, ::-1]]), "cuda")
            if size == 640:
                flip_feats = det._forward(flip_x)
        more_inputs[f"bs128@{size} flip batch"] = mbconv_block_inputs(det, flip_x)
        del flip_x
    large_dets = large_preset_detectors(cfg)
    with torch.inference_mode():
        x_large = normalize_raw(large_dets[0], feats_imgs, "cuda")
    if not set(MBCONV_BLOCKS_640) <= set(large_dets[1]._engine.kernel_blocks(640)):
        raise AssertionError(f"[kernels] the large preset's blocks at 640: {large_dets[1]._engine.kernel_blocks(640)}")
    more_inputs["bs32@640 large preset"] = mbconv_block_inputs(large_dets[0], x_large)
    # the rungs of the serving phase's multi-stream pipeline (8 streams: 8 and 2)
    for b in (8, 2):
        more_inputs[f"bs{b}@640 serving rung"] = mbconv_block_inputs(det, x[:b].contiguous())
    imgs320, _ = paint_batch(9, 32, (320, 320))
    with torch.inference_mode():
        x320 = normalize_images(torch.from_numpy(imgs320).to("cuda"), det.config.preprocess, raw=True)
    chains = planar_chain_inputs(det, x, 640, PLANAR_CHAINS[640]) + planar_chain_inputs(det, x320, 320, PLANAR_CHAINS[320])
    singles = planar_chain_inputs(det, x, 640, PLANAR_SINGLE_BLOCKS)
    planar_one, planar_many = phase_kernels_planar(chains, singles)
    errs = {
        "decode_feats_fused": phase_kernels_decode(det_feats, flip_feats),
        "fused_mbconv": max(phase_kernels_mbconv(block_inputs, more_inputs).values()),
        "sigmoid_pseudo_nms_fused": phase_kernels_nms(),
        "planar_mbconv": max(planar_one.values()),
        "planar_mbconv_chain": max(planar_many.values()),
    }
    del more_inputs, flip_feats
    quant_dets, _ = quant_detectors(cfg)
    int8_inputs = quant_kernel_inputs(quant_dets["library"]._quant, x)
    errs.update(phase_kernels_int8(int8_inputs))

    at320 = dict(decode=cfg.decode, default_size=320)
    det320 = Detector.from_safetensors(FLAGSHIP, DetectorConfig(**at320))
    det_cpu = Detector.from_safetensors(FLAGSHIP, DetectorConfig(**at320), device="cpu")
    det_fast320 = Detector.from_safetensors(FLAGSHIP, DetectorConfig(model=fast_cfg.model, **at320))
    # each path is driven with the counts set to 0 just before it and read
    # just after; a kernel's launches are those of all the paths
    module_launches, d640 = phase_main(det, det320, det_cpu)
    det_f32 = Detector.from_safetensors(
        FLAGSHIP, dataclasses.replace(cfg, model=ModelConfig(compute_dtype="float32")))
    planar_model = ModelConfig(inference_engine="planar")
    det_planar = Detector.from_safetensors(FLAGSHIP, dataclasses.replace(cfg, model=planar_model))
    det_planar320 = Detector.from_safetensors(FLAGSHIP, DetectorConfig(model=planar_model, **at320))
    det_planar_cpu = Detector.from_safetensors(FLAGSHIP, DetectorConfig(model=planar_model, **at320), device="cpu")
    paths = [module_launches, phase_main_fast(det_fast, det_fast320, det_f32, d640, x, det_feats),
             phase_main_landmarks(),
             phase_main_planar(det_planar, det_planar320, det_planar_cpu, det_f32, d640, x, det_feats),
             phase_main_quant(quant_dets, det, det_f32, d640, x, det_feats),
             phase_eval(det, det_fast, det_cpu, smi),
             phase_main_large(large_dets, feats_imgs, x_large),
             phase_serving(cfg, det, det_fast, quant_dets["b7"], smi),
             phase_train(cfg, smi),
             phase_quant_ft(cfg, smi, quant_dets["b7"]),
             phase_entry(smi),
             phase_alternates(cfg, det, det_f32, d640, x, smi),
             phase_dp(det, det_fast, smi),
             phase_bench(det, det_fast, smi),
             phase_headline(smi)]
    launches = {name: sum(p[name] for p in paths) for name in errs}
    # no engine calls the one-block planar kernel (as in the JAX package), the
    # int8 1x1 conv or the stride-2 int8 block (their int8 outputs fit no
    # conv of the quantized engine): they are on no path, and a launch of
    # one of them on a path would be a fault
    on_path = {name: name not in ("planar_mbconv", "int8_conv1x1", "int8_block_s2") for name in errs}
    if any((launches[name] > 0) != on_path[name] for name in errs):
        raise AssertionError(f"[main] launches {launches}: every kernel of the paths at least once, the others never")
    times, ktimes = phase_times(det, det_fast, det_planar, det_feats, block_inputs, chains, singles)
    ktimes.update(phase_times_quant(quant_dets, det, int8_inputs, x)[1])

    sources = {
        "decode_feats_fused": ("tpucenterface_torch/csrc/decode.cu", "tpucenterface/decode/pallas_decode.py:134"),
        "fused_mbconv": ("tpucenterface_torch/csrc/mbconv.cu", "tpucenterface/ops/fused_mbconv.py:150"),
        "sigmoid_pseudo_nms_fused": ("tpucenterface_torch/csrc/nms.cu", "tpucenterface/decode/pallas_nms.py:45"),
        "planar_mbconv": ("tpucenterface_torch/csrc/planar_chain.cu", "tpucenterface/ops/planar_mbconv.py:151"),
        "planar_mbconv_chain": ("tpucenterface_torch/csrc/planar_chain.cu", "tpucenterface/ops/planar_mbconv.py:303"),
        "int8_conv1x1": ("tpucenterface_torch/csrc/int8_conv.cu", "tpucenterface/bench/probe_int8_conv.py:36"),
        "int8_block_s2": ("tpucenterface_torch/csrc/int8_block.cu", "tpucenterface/bench/probe_fused_block.py:161"),
        "int8_block_s1": ("tpucenterface_torch/csrc/int8_block_s1.cu", "tpucenterface/bench/probe_fused_block.py:318"),
    }
    record = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": launches[name],
                "on_path": on_path[name],
                "max_abs_err": errs[name],
                **ktimes[name],
            }
            for name, (source, replaces) in sources.items()
        ]
    }
    log(smi)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
