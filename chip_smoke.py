#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final line):
1. device: CUDA must be present (no CPU fallback); prints the card's name and
   power limit from nvidia-smi;
2. build: compiles the seven sources under csrc/ (snake_alias, snake_alias_bwd,
   snake_alias_strips, snake_alias_mma, amp_iter, viterbi_trellis,
   crepe_conv) with nvcc,
   one process per source, started together, and times the build; where
   build/prev_kernels/ holds an earlier version's snake_alias_mma.cu,
   amp_iter.cu and snake_alias.cuh (a copy kept out of git), builds those
   two sources in the same batch;
2b. [trellis]: CREPE's Viterbi trellis kernel against its plain version,
   on the card and on the CPU, values and pointers bitwise equal, at 1, 50,
   64 and 2,000 frames of observations with masked bins, with and without
   planted ties, from the first frame, from a carried value and from a
   large carried value (~-8,000), one launch a call (the value bins whose
   bits differ, the largest difference and the pointer rows that differ
   are counted and printed); times at a push's 50 frames: the kernel (CUDA
   events), the card path of a stream's push (upload, launch, the int16
   pointers and the value back, host clock), the CPU stream's numpy
   trellis and the plain version on the card and on the CPU; the kernel at
   2,000 frames; the bound of each from this card's latencies (an empty
   kernel's launch, a shuffle level of a first-index maximum, an exchange
   across a block's warps: chains built from TRELLIS_PROBE_SOURCE into
   build/latency_probe/), the launch plus 9 levels and one exchange a
   frame;
2c. [crepe-conv]: CREPE's convolution kernel against its plain version on
   the card: the whole forward's probabilities at 1, 50, 64 and 512 rows of
   "full" and "tiny" (largest difference, within 1e-6), six launches a
   forward, a second call bitwise equal to the first, a stream's 64-row
   batch through crepe_probabilities running the kernel and no cuDNN
   convolution (torch.profiler); then each layer of
   "full" at 64 rows (the stream's batch) and at 512 (the offline batch):
   the kernel's ms, the plain version's, cuDNN's Conv1d alone with its
   heuristic and with cudnn.benchmark (library_ms), the bound (FLOPs at
   67 TFLOP/s against bytes at 3.35 TB/s), the tile plan
   (tools/crepe_conv_probe.py::layer_lines);
3. kernel vs plain: the snake kernel against its plain PyTorch version at the
   five base-width stage shapes of a 1020-frame chunk and at odd shapes, in
   float32 and bfloat16, with CUDA-event times (inputs rotated over >100 MB
   so that the 50 MB L2 is cold; in the pipeline the input may still sit in
   L2 after the convolution that wrote it);
4. backward kernel vs plain: the snake backward kernel against
   torch.autograd.grad of the plain version at the five stage shapes of a
   training step (batch 16, 25-frame segments) and at the JAX package's test
   shapes, float32 and bfloat16; dalpha and dbeta must be bitwise equal
   across two calls; CUDA-event times as in phase 3 (the earlier kernel's
   beside them);
   the forward kernel against its plain version at the same five training
   shapes, and at the five stage shapes of one validation utterance (batch
   1, padded to 400 frames), as in phase 3;
4b. the corners of the kernels' work plan, forward and backward, float32
   and bfloat16, untimed: packed and misaligned rows (T = 1, T < 12,
   T = 32 * 8 +- 1, odd T with B * C no multiple of a block's 8 warps, the
   JAX package's backward test shapes), a tensor whose start is not 16-byte
   aligned, and large arguments (x * 100, e^alpha up to 4.5, beta down to
   -3: |e^alpha u| ~ 1e3, 1 / e^beta ~ 20), at the same tolerances;
5. requests: seeded random weights at full configs/base.yaml width through
   `svc_infer`: 30.5 s, 12.3 s and 2 s of features with unvoiced runs
   (7 chunks of 1000 frames); checks finite, non-silent output of
   frames * 320 samples, 91 snake launches per chunk and no backward launch;
   prints wall ms per request after a warm-up and the realtime factor, then a
   torch.profiler table of one chunk's device time;
6. card vs CPU: the 2 s request (out_chunk=200) on the card and on the CPU,
   compared at float32 tolerance, which TF32 convolutions are expected to
   exceed;
6b. [fold-wn]: the seeded weight-norm checkpoint written to a temporary
   .pth and loaded into a model built with fold_wn=True (every weight-norm
   pair folded into a plain kernel on the way in); the three requests
   through it (91 B1 launches a chunk), each waveform within 5e-5 of the
   weight-norm model's; wall ms per chunk of both models in ABBA turns and
   one profiled chunk of each (device busy ms, device ops);
6c. [device-trace]: utils/device_trace.py over one chunk of svc_infer:
   measure_device_ms(fn, "snake_alias"), B1's launches and total in one
   torch.profiler trace (as many traced kernels as launches counted), then
   the chunk's B1 launches replayed on their captured inputs and timed by
   CUDA events and by the trace (within 0.5-2x of each other);
6d. [med]: MelspecDiscriminator (unwired, as in the JAX package) with
   seeded weights and BatchNorm statistics on a [16, 48000, 1] batch, the
   card against the CPU (each feature map and the scores within 2e-5 of
   their largest entry), ms per call and one profiled call;
7. training steps: `init_train_states` + `make_train_step` at full
   configs/base.yaml width (batch 16, accum_step 2) on synthetic 300-frame
   utterances; one warm-up step, then 4 timed steps; checks finite losses
   and grad norms, 91 forward and 91 backward snake launches per step (and
   in the profiled step 91 kernels of each: one kernel per backward call),
   finite non-zero gradients for every snake alpha and beta, D moving on
   every step and G on every accum_step-th step only; prints ms per step,
   utterances per second, peak device memory and a torch.profiler table of
   one more step;
8. training card vs CPU: the seeded initial weights, a 2 x 100-frame batch,
   every stochastic node frozen, the CPU taking the card's ReLU/abs
   branches on 8 threads, pinned (the reference's float32 sums move with
   the thread count; PERF.md); loss terms within rtol 1e-4; G's
   backward of one fixed audio
   gradient within relative L2 1e-4 per parameter; each audio loss term's
   gradient with respect to the audio, and every parameter gradient of the
   step, within relative L2 1e-3.

9. alternative kernels vs plain: the strips and the mma snake kernels at the
   five stage shapes, at odd shapes and at the JAX package's strips test
   shapes, float32 and bfloat16: strips bitwise equal to the direct kernel,
   mma within the float32 tolerance of the direct kernel and of the plain
   version, with the direct kernel's time on the same inputs beside theirs;
   the mma kernel also at large arguments (x * 100) and at a start off
   16-byte alignment; with build/prev_kernels/, the earlier mma kernel
   timed on the same inputs in turns (new, old, old, new);
   the fused AMP iteration against its plain version at the 18 (shape, k, d)
   cases of a chunk, at the JAX package's test shapes and at odd ones (T
   shorter than the halo, T = 1, C = 32, B = 2), at large arguments and at a
   start off 16-byte alignment, with its time, its two bounds (the mixes on
   the CUDA cores and as 3xTF32 on the tensor cores), the earlier kernel's
   time in turns (with build/prev_kernels/) and the time of the unfused
   route (two direct snake launches, two cuDNN float32 convolutions, the
   add);
10. alternative configurations: the same seeded weights through `svc_infer`
   with `amp_fused_iter=True`, `snake_variant="strips"` and
   `snake_variant="mma"` (1230, 200 and 1000 frames: 4 chunks each), every
   count set to 0 before each path; checks the launches per chunk (18
   amp_iter + 55 direct; 37 strips + 54 direct; 91 mma), each waveform
   within 5e-5 of the default configuration's on the card, and the fused
   one against the CPU on the 200-frame request; prints wall ms, the
   realtime factor and device ms per chunk beside the default's.

11. training loop: a synthetic dataset (40 utterances of 160-400 frames,
   about 80 MB: int16 wavs, specs, F0, PPG, vec, speaker vectors; 2 of
   them the validation set) in a temporary directory, and the loop's entry
   point `train` at full base width (batch 16, accum_step 2, info, eval
   and save intervals 1): one epoch (validation, 3 steps, the third in
   train's profiler window, a checkpoint),
   a resume from that checkpoint for 18 more steps (6 epochs, each with its
   validation and checkpoint, the newest 2 kept), and a NaN-poisoned
   second batch with auto-resume off; checks the step counter, the epoch,
   finite metrics, 91 forward and 91 backward snake launches per loop step
   and 91 forward per validation utterance, one validation utterance
   through the snake kernel against the plain version (same weights and
   generator seed, within 5e-5), the resumed run's checkpoint
   restored on the card against its states to the bit (parameters, AdamW
   moments, acc, mini_step) and TrainDivergence with no checkpoint after
   it; prints wall ms per loop step (median and range of the steady steps)
   beside the bare step's of the same call, the writer's
   steps_per_s and audio_seconds_per_s, the prefetch queue wait, checkpoint
   size and save/load ms, validation ms per utterance, the profiled step's
   device busy share and kernels by kind, peak memory and the loader route.

12. audio in: seeded random extractor checkpoints at the published widths
   in the reference layouts, written to a temporary directory (whisper
   large-v2: dims and 32 encoder blocks of 1280 in float16, cut to 24 by
   the loader; hubert-soft 12 x 768; CREPE "full"; the LSTM speaker encoder
   3 x 768 -> 256), the singer's d-vector from the port's compute_embedding
   on a synthetic voice, a 30.5 s synthetic song at 44.1 kHz (three whisper
   windows and two HuBERT windows, each with a masked tail), and the port
   CLI's `main` from the wave alone in a fresh directory; then retrieval
   banks from the extractors' features of a 200 s synthetic corpus (the
   port's build_index) and `main` again with --enable-retrieval. Checks
   svc_out.wav (finite, not silent, 32 kHz, the chunk plan's length), 91
   snake launches per chunk and none of another kernel, a waveform that
   retrieval changed; each extractor on the card against the CPU at full
   width (one 15 s whisper window, one 20 s HuBERT window, a 4 s clip for
   CREPE and the speaker encoder; PPG and units 1e-3, CREPE probabilities
   1e-4, d-vector 1e-5, the retrieval blend 1e-4) and the Viterbi path
   decoded on the card and on the CPU from the card's probabilities, equal.
   Prints ms by stage and the realtime factor of each request, the peak
   device memory, and the device busy share of a profiled extraction.

13. the rest of inference: on a 30.5 s song with features in, the CLI's
   `main` in float32 and with --bf16 (91 snake launches a chunk, all
   bfloat16 under --bf16; the bf16 waveform against the float32 one within
   the JAX package's bf16 bound, median abs < 0.05 and correlation > 0.9;
   wall, realtime factor, peak memory, device ms of one chunk in each dtype
   from torch.profiler); a fast_edges request (200 frames) on the card and
   the CPU within 5e-5 with no snake kernel launched; every --f0-engine on
   the song, the card's F0 against the CPU's where the engine has a device
   part (voicing equal on all but 1% of frames, voiced F0 within 50 cents);
   the silero VAD with seeded random weights on the card against the CPU
   (1e-4) and apply_vad_mask on the song; merge and eva through cli.misc,
   the merged model through one chunk.

14. streaming: the snake kernel against its plain version at the five stage
   shapes of the streaming window (100-frame blocks after 50 frames of
   context: [1,160,750] .. [1,10,48000]); StreamingSvc at full base width
   over 30 blocks of seeded features (wall per push, a CUDA graph replay
   a block, 91 snake launches a block counted from the graph's capture,
   one profiled block, the card against the CPU over 4 blocks and
   blocks 1-3 against one forward on their window with the whole
   utterance's excitation, 5e-5 each); then audio in and out: the
   streaming extractors at the published widths (seeded random
   checkpoints) and push_audio over a 10 s synthetic voice in 1 s blocks,
   lag 4 (wall and latency per block, each stage's share, a replay and
   91 launches a synthesis push, one trellis launch a push and at the
   flush with every CREPE frame's trellis on the card, six CREPE
   convolution launches a CREPE batch, a streaming CREPE's
   flush path equal to the offline decode, the first block's features card
   vs CPU at [audio-in]'s bounds).

15. training with train.bf16_discriminator at base width (ms per step
   beside [train]'s float32 D, peak memory, the D scores within 0.05 mean
   relative error of a float32 D with the same parameters, float32
   gradients, parameters and AdamW states, convolution kernels by dtype);
   then `train` for 2 loop steps without a process group and through
   hp.dist as a one-rank NCCL group on cuda:0, the two runs' states equal
   to the bit.

16. making a voice model through the port's entry points, with seeded
   random extractor checkpoints at the published widths (as phase 12):
   `[prep]` the preprocessing CLI on a synthetic dataset_raw/ of two
   speakers at 44.1 kHz (2.5-21 s: 17 and 21 s cross whisper's 15 s and
   HuBERT's 20 s windows), staged and --serial in ABBA turns into four
   trees (the first two held file by file: pitch equal,
   features and specs within 1e-4, each spec within 1e-5 of
   linear_spectrogram of its 32 kHz wave), a rerun that skips every stage,
   8 filelist rows and the dry run, wall ms by stage, audio s per wall s,
   the staged driver's busy share under torch.profiler, peak memory and
   CREPE's memory at 512- and 2048-frame batches, then --stage cdc / trim against the
   port's functions; no kernel launches; `[prep-flow]` the trainer CLI for
   2 steps on those filelists at base width from a .json config (91 + 91
   launches a step), the export CLI with --artifact at 1020 frames, the
   artifact (B1 through the operator svc::snake_alias, 91 launches a call)
   against the kernel model on one chunk of the features with the same
   noise (5e-5), its ms per chunk beside svc_infer's in turns, the
   inference CLI from the exported checkpoint with the features (91 a
   chunk), the three extractor artifacts against their modules (whisper at
   its width cut to 4 layers; PPG and units 1e-3, CREPE 1e-4) with export
   seconds and bytes, CREPE's running its convolution kernel through the
   operator svc::crepe_conv (6 launches a call); `[webui]` the WebUI's server in a thread: GET / in
   both languages, POST /export and POST /infer polled on /log until done
   (91 launches a chunk); `[tp]` sharded_ppg_fn in a one-rank NCCL group
   equal to the plain 24-layer WhisperEncoder on a 15 s window to the bit,
   unmasked and with a key mask;
   `[resnet-spk]` ResNetSpeakerEncoder at (3, 4, 6, 3), card vs CPU within
   1e-5.

17. `[train-health]`: the learnable synthetic workspace of
   tools/make_synth_dataset.py (60 utterances of 2.2-3.9 s, 6 speakers,
   seed 0, 10 held out; the spectrograms on the card) in a temporary
   directory, then the trainer CLI from it at base width, batch 8, for 80
   epochs (560 steps at 7 batches an epoch; a validation of the 10 held-out
   utterances every 20 epochs, one info line an epoch, a checkpoint every 20)
   and a resume from the newest checkpoint for one more epoch. Checks no
   divergence and finite losses and validation mel, 91 forward and 91
   backward snake launches a step and 91 forward a validation utterance,
   the last validation mel of the run at most 0.95 x the first, the
   resume's step and epoch counters, AdamW steps and G's accumulation
   continued from the checkpoint, and validation after the resume within
   2.5% of the one before it; prints the validation mel at each evaluation, the
   g / mel / d losses at each info line, steps/s of wall time, peak memory
   and the phase's seconds.

Then prints a {"kernels": [...]} line, the nvidia-smi line, and as its last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from scipy.io import wavfile

from whisper_vits_svc_tpu_torch.cli import export as cli_export
from whisper_vits_svc_tpu_torch.cli import inference as cli_inference
from whisper_vits_svc_tpu_torch.cli import preprocessing as cli_prep
from whisper_vits_svc_tpu_torch.cli import trainer as cli_trainer
from whisper_vits_svc_tpu_torch.cli import webui as cli_webui
from whisper_vits_svc_tpu_torch.data import native_loader
from whisper_vits_svc_tpu_torch.data import preprocess as prep_mod
from whisper_vits_svc_tpu_torch.data.dataset import (
    MAX_SEGMENTS, BucketBatcher, SvcDataset, boundaries_for,
)
from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer import retrieval as retrieval_mod
from whisper_vits_svc_tpu_torch.infer import serving
from whisper_vits_svc_tpu_torch.infer import stream as stream_mod
from whisper_vits_svc_tpu_torch.infer import stream_extract
from whisper_vits_svc_tpu_torch.infer.retrieval import DummyRetrieval
from whisper_vits_svc_tpu_torch.infer.stream import StreamingSvc
from whisper_vits_svc_tpu_torch.models import crepe as crepe_mod
from whisper_vits_svc_tpu_torch.models import hubert as hubert_mod
from whisper_vits_svc_tpu_torch.models import speaker_encoder as spk_mod
from whisper_vits_svc_tpu_torch.models import whisper as whisper_mod
from whisper_vits_svc_tpu_torch.models.synthesizer import slice_segments
from whisper_vits_svc_tpu_torch.nn.nsf import source_hn_nsf
from whisper_vits_svc_tpu_torch.nn.snake import snake_alias_fused_cm
from whisper_vits_svc_tpu_torch.ops import amp_cuda, crepe_conv_cuda, cuda_build, snake_cuda
from whisper_vits_svc_tpu_torch.ops import viterbi_cuda
from whisper_vits_svc_tpu_torch.ops import stft as stft_mod
from whisper_vits_svc_tpu_torch.parallel import ddp as tddp
from whisper_vits_svc_tpu_torch.parallel import sharding
from whisper_vits_svc_tpu_torch.tools import crepe_conv_probe, make_synth_dataset, train_health
from whisper_vits_svc_tpu_torch.train import checkpoint as tckpt
from whisper_vits_svc_tpu_torch.train import loop as tloop
from whisper_vits_svc_tpu_torch.train import step as tstep
from whisper_vits_svc_tpu_torch.models.discriminator import MelspecDiscriminator
from whisper_vits_svc_tpu_torch.utils import audio_io
from whisper_vits_svc_tpu_torch.utils import device_trace
from whisper_vits_svc_tpu_torch.utils.audio_io import save_wav
from whisper_vits_svc_tpu_torch.utils.config import BASE_MODEL_CONFIG, config_from_dict
from whisper_vits_svc_tpu_torch.utils.device import resolve_device
from whisper_vits_svc_tpu_torch.utils.profiling import StepTimer, trace

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# per output element: two 6-tap up FIRs (24), snake on two phases (2 x 5,
# counting sin as one), two 6-tap down FIRs (24)
SNAKE_OPS_PER_ELEM = 58
# backward, per element: two 6-tap up FIRs recomputed (24), two 6-tap
# down-FIR adjoints (24), on two phases sincos and du = ds (1 + ib a sin 2au)
# (2 x 9) and the dalpha/dbeta terms (2 x 6), two 6-tap up-FIR adjoints (24)
SNAKE_BWD_OPS_PER_ELEM = 102
# kernel vs plain on the same inputs. f32: FMA contraction and sinf/expf
# rounding, a few ulp of outputs up to ~10. bf16: the two sides round the
# same f32 result to bf16, which may land one bf16 ulp apart (2^-8 relative).
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
# backward kernel vs plain backward in f32, as the JAX package holds its
# backward kernel to jax.grad (tests/test_snake_fused.py:189): dalpha/dbeta
# are sums over B*T terms taken in another order
BWD_F32_TOL = dict(atol=3e-4, rtol=2e-4)
# card vs CPU waveform (tanh output in [-1, 1]): float32 convolutions summed
# in other orders through ~60 layers (3.6e-6 measured on an H100); TF32 keeps
# ~3 decimal digits, so TF32 convolutions are expected far above this
CARD_VS_CPU_ATOL = 5e-5
# training step card vs CPU, every ReLU, leaky ReLU and abs on the CPU taking
# the branch it took on the card (an input within f32 rounding of zero can
# take the other one, and the gradient there then changes by (1 - slope)
# of its size; PERF.md). Loss terms within 1e-4. G's own backward (its
# VJP of one fixed d loss / d audio, through the snake kernels) within 1e-4
# relative L2 per parameter. Each audio loss term's gradient with respect to
# the audio, and every parameter gradient of the step, within 1e-3: the
# MR-STFT log-magnitude loss divides by magnitudes down to its 3e-4 floor,
# so its audio gradient carries the f32 rounding of long DFT sums, which
# differs between cuBLAS and the CPU, into the generator's gradients.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_VJP_REL_L2 = 1e-4
TRAIN_GRAD_REL_L2 = 1e-3
# d loss / d (attention conv_k.bias) is zero in exact arithmetic: the bias
# adds q.b to every score of a query's row, which the softmax cancels. Both
# sides hold rounding noise there, so each side's norm is held under
# TRAIN_GRAD_REL_L2 of the same layer's conv_q.bias gradient instead.
ZERO_GRAD_SUFFIX = ".conv_k.bias"

# ~0.1 s at the H100's clock: longer than the host takes to enqueue a timing loop
SPIN_CYCLES = 200_000_000

CHUNK_FRAMES = 1020  # out_chunk 1000 + 2 * hop_frame 10
# 4 + 2 + 1 chunks. The reference's chunk walk repeats frames for lengths in
# (3000, 3010), so the long request is 3050 frames, where output = frames * hop.
REQUEST_FRAMES = (3050, 1230, 200)
ODD_SHAPES = ((1, 8, 130), (1, 80, 20401), (2, 16, 1024))
# the JAX package's backward test shapes (tests/test_snake_fused.py:171-191)
BWD_ODD_SHAPES = ((1, 10, 700), (2, 16, 1024), (1, 3, 130), (2, 20, 4000))
# the work plan's corners: T = 1, T < 12, T = 32 * RUN +- 1 (a warp's lanes),
# T = SEG_LEN - 1 (rows whose aligned start needs a second segment), odd T
# with B * C no multiple of a block's WARPS
PLAN_ODD_SHAPES = ((1, 1, 1), (2, 3, 1), (1, 5, 5), (3, 3, 11),
                   (1, 3, 32 * snake_cuda.RUN - 1), (1, 3, 32 * snake_cuda.RUN + 1),
                   (2, 3, snake_cuda.SEG_LEN - 1), (3, 5, 131), (1, 7, 997))
# the large-argument inputs at a small, a short-row and a long shape
LARGE_ARG_SHAPES = ((2, 16, 1024), (16, 160, 125), (1, 20, 163200))
TRAIN_FRAMES = 300  # 3 s utterances, as bench_train.py:22
TIMED_STEPS = 4
CHECK_BATCH, CHECK_FRAMES, CHECK_SLICE_IDS = 2, 100, (0, 61)
# the CPU reference's thread count, pinned: oneDNN and MKL split their float32
# sums by thread, and the MR-STFT log loss's audio gradient carries that
# rounding into the last stage's gradients. Measured on an H100 host
# (PERF.md): worst gradient 4.03e-3 / 1.08e-3 / 0.93e-3 / 0.94e-3 / 0.52e-3 on
# 1 / 2 / 4 / 8 / 16 threads, 2.07e-3 against a float64 CPU (the card's own
# float32 error in that ill-conditioned loss). 8: the card machine's cores,
# the thread count that earlier passing runs of this check had by default
CHECK_CPU_THREADS = 8
# the JAX package's fused-iteration and strips test shapes
# (tests/test_snake_fused.py:230-231, :297-298) and odd ones: T no multiple of
# anything, T shorter than the halo, T = 1, C = 32, B = 2
AMP_ODD_CASES = ((1, 10, 1280, 3, 1), (2, 16, 1024, 7, 3), (1, 12, 2560, 11, 5),
                 (1, 10, 1279, 7, 3), (1, 10, 30, 11, 5), (1, 10, 1, 11, 5),
                 (2, 32, 3000, 11, 5))
# the fused iteration's large-argument and misaligned cases: a C = 20 and a
# C = 10 shape of the chunk's kinds, and the widest K (C = 32, k = 11)
AMP_CORNER_CASES = ((1, 20, 4000, 11, 5), (1, 10, 8000, 3, 1), (2, 32, 1000, 11, 5))
# the [train-loop] dataset: utterances in the (6, 12] and (12, 16] segment
# buckets, 160-300 and 301-400 frames at base width: 1 + 2 batches of 16, an
# odd count, so that G's checkpoint holds a half-full accumulator
LOOP_UTTERANCES = (16, 24)
LOOP_VAL_UTTERANCES = 2
# 6 more epochs of 3 batches: 12 steady loop steps; 21 steps in all leave G
# half way through an accumulation, so the checkpoint carries a full `acc`
LOOP_RESUME_STEPS = 18
PROFILED_LOOP_STEP = 3  # train(profile_dir=..., profile_steps=1) traces step 3
STRIPS_ODD_SHAPES = ((2, 10, 5120), (2, 20, 6400), (2, 6, 8192), (2, 10, 3200))
# fused iteration vs plain in f32, as the JAX package holds its kernel
# (tests/test_snake_fused.py:242)
AMP_F32_TOL = dict(atol=2e-5, rtol=1e-5)
ALT_REQUEST_FRAMES = (1230, 200, 1000)  # 2 + 1 + 1 chunks
# launches per 1020-frame chunk at base width: the fused iteration takes the
# C = 20 and C = 10 stages (2 x 9 iterations, 36 of the 91 snakes); strips
# takes the same stages' 36 snakes and activation_post; mma takes every snake
ALT_LAUNCHES_PER_CHUNK = {
    "fused": dict(amp=18, direct=55),
    "strips": dict(strips=37, direct=54),
    "mma": dict(mma=91),
}
ALT_CONFIGS = {
    "fused": dict(amp_fused_iter=True),
    "strips": dict(snake_variant="strips"),
    "mma": dict(snake_variant="mma"),
}
SNAKE_KERNELS = {"direct": snake_cuda.snake_alias_cuda,
                 "strips": snake_cuda.snake_alias_strips_cuda,
                 "mma": snake_cuda.snake_alias_mma_cuda}
REPLACES = "whisper_vits_svc_tpu/ops/pallas_snake.py:596"
SOURCE = "whisper_vits_svc_tpu_torch/csrc/snake_alias.cu"
REPLACES_BWD = "whisper_vits_svc_tpu/ops/pallas_snake.py:438"
SOURCE_BWD = "whisper_vits_svc_tpu_torch/csrc/snake_alias_bwd.cu"
REPLACES_AMP = "whisper_vits_svc_tpu/ops/pallas_amp.py:157"
SOURCE_AMP = "whisper_vits_svc_tpu_torch/csrc/amp_iter.cu"
REPLACES_STRIPS = "whisper_vits_svc_tpu/ops/pallas_snake.py:539"
SOURCE_STRIPS = "whisper_vits_svc_tpu_torch/csrc/snake_alias_strips.cu"
REPLACES_MMA = "whisper_vits_svc_tpu/ops/pallas_snake.py:280"
SOURCE_MMA = "whisper_vits_svc_tpu_torch/csrc/snake_alias_mma.cu"
# a lax.scan, not a Pallas kernel: the port's kernel for a scan on the hot path
REPLACES_TRELLIS = "whisper_vits_svc_tpu/models/crepe.py:148"
SOURCE_TRELLIS = "whisper_vits_svc_tpu_torch/csrc/viterbi_trellis.cu"
# no Pallas kernel: the JAX package leaves CREPE's convolutions to XLA
REPLACES_CREPE_CONV = "whisper_vits_svc_tpu/models/crepe.py (XLA convolutions)"
SOURCE_CREPE_CONV = "whisper_vits_svc_tpu_torch/csrc/crepe_conv.cu"
CREPE_CONV_ROWS = (1, 50, 64, 512)
# an earlier version's tensor-core snake and fused AMP kernels, for the
# comparison: a copy of their files (snake_alias_mma.cu, amp_iter.cu and the
# snake_alias.cuh they include) kept out of git (build/ is ignored)
PREV_DIR = Path(__file__).resolve().parent / "build" / "prev_kernels"
PREV_SOURCES = (PREV_DIR / "snake_alias_mma.cu", PREV_DIR / "amp_iter.cu")
# H100 SXM dense TF32 tensor-core rate (NVIDIA data sheet); a 3xTF32 product
# takes three of its operations for each useful one
TF32_OPS_PER_S = 495e12


def check(ok: bool, msg: str) -> None:
    """A failed check ends the run without the final line (also under -O)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def stage_shapes(hp, batch: int, frames: int) -> list[tuple[tuple[int, int, int], int]]:
    """((batch, C, T), snake calls) per generator stage for `frames` latent
    frames."""
    out, t = [], frames
    n_act = 2 * sum(len(d) for d in hp.gen.resblock_dilation_sizes)
    for i, u in enumerate(hp.gen.upsample_rates):
        t *= u
        c = hp.gen.upsample_initial_channel // 2 ** (i + 1)
        out.append(((batch, c, t), n_act))
    shape, n = out[-1]
    out[-1] = (shape, n + 1)  # activation_post
    return out


def cuda_ms(fn, iters: int) -> float:
    """Device time per call: a spin kernel keeps the card busy while the host
    enqueues all `iters` calls, so the events time the card alone."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    byte_s, op_s = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(byte_s, op_s) * 1e3, ("bytes" if byte_s >= op_s else "operations")


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    snake_cuda.launches = snake_cuda.launches_bwd = 0
    snake_cuda.launches_strips = snake_cuda.launches_mma = 0
    amp_cuda.launches = 0


def read_counts() -> dict:
    return dict(direct=snake_cuda.launches, bwd=snake_cuda.launches_bwd,
                strips=snake_cuda.launches_strips, mma=snake_cuda.launches_mma,
                amp=amp_cuda.launches)


def snake_params(c: int, g, large: bool = False):
    """alpha, beta [C]: small, or (large) e^alpha in [1.6, 4.5] and beta in
    [-3, 0]."""
    if large:
        return (1.0 + torch.rand(c, device="cuda", generator=g) - 0.5,
                -3.0 * torch.rand(c, device="cuda", generator=g))
    return (torch.randn(c, device="cuda", generator=g) * 0.3,
            torch.randn(c, device="cuda", generator=g) * 0.3)


def snake_inputs(shape, dtype, seed: int, large: bool = False, n_buf: int | None = None):
    """(rotating inputs over >100 MB, alpha, beta) for one snake shape."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, c, t = shape
    alpha, beta = snake_params(c, g, large)
    n_buf = n_buf or max(1, -(-100_000_000 // (b * c * t * 4)))
    scale = 100.0 if large else 1.5
    xs = [(torch.randn(shape, device="cuda", generator=g) * scale).to(dtype)
          for _ in range(n_buf)]
    return xs, alpha, beta


def misalign(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose start lies 4 bytes past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    skip = 4 // x.element_size()
    out = flat[skip: skip + x.numel()].view(x.shape)
    out.copy_(x)
    check(out.data_ptr() % 16 == 4, "misalign: the copy is 16-byte aligned")
    return out


def prev_fir_matrices() -> np.ndarray:
    """The earlier mma kernel's [B_up hi, B_up lo, B_dn hi, B_dn lo]: B_up
    [24, 32] (a window of 16 phases from P reads x[P - 3 + i]; columns
    0..15 se, 16..31 so) and B_dn [48, 16] (16 outputs from q read E[q - 2 +
    i] and O[q - 3 + i])."""
    from whisper_vits_svc_tpu_torch.nn.snake import _polyphase_taps
    ae, ao, _, _, de, do_, _, _ = _polyphase_taps(12, 12)
    b_up = np.zeros((24, 32), np.float32)
    b_dn = np.zeros((48, 16), np.float32)
    for j in range(16):
        for m in range(6):
            b_up[j + m, j] = ae[m]
            b_up[j + m + 1, 16 + j] = ao[m]
            b_dn[j + m, j] = de[m]
            b_dn[24 + j + m, j] = do_[m]
    parts = []
    for mat in (b_up, b_dn):
        parts += [p.flatten() for p in snake_cuda.tf32_split(torch.from_numpy(mat))]
    return torch.cat(parts).numpy()


def prev_amp_tile(c: int, k: int, d: int) -> int:
    """The earlier fused AMP kernel's tile: at most 480 outputs, four
    [C, tile + 2 halo] buffers beside both kernels in a block's shared memory."""
    cp = 4 * -(-c // 4)
    halo = (k - 1) // 2 + 12 + d * (k - 1) // 2
    width = (232448 - 1024 - 4 * (2 * k * c * cp + 6 * cp)) // (16 * c)
    tile = min(480, width - 2 * halo)
    return tile - tile % 32


def load_prev() -> dict | None:
    """The earlier tensor-core snake and fused AMP kernels from
    build/prev_kernels/ (built with the others in the build phase; their C
    ABI: the mma kernel one block per 1024-output tile, the fused kernel
    with its own tile and no fragment scratch) behind wrappers, or None
    where the directory is absent (a checkout from git)."""
    if not all(p.exists() for p in (*PREV_SOURCES, PREV_DIR / "snake_alias.cuh")):
        return None
    ptr, num = ctypes.c_void_p, ctypes.c_int
    taps = ctypes.POINTER(ctypes.c_float)
    mma_lib = cuda_build.load_library(PREV_SOURCES[0], "snake_alias_mma_forward",
                                      [ptr] * 5 + [taps] + [num] * 4 + [ptr],
                                      "snake_alias_mma_error_string")
    amp_lib = cuda_build.load_library(PREV_SOURCES[1], "amp_iter_forward",
                                      [ptr] * 10 + [taps] + [num] * 7 + [ptr],
                                      "amp_iter_error_string")
    fir = torch.from_numpy(prev_fir_matrices()).cuda()

    def mma(x, alpha, beta):
        return snake_cuda._launch_forward("snake_alias_mma", lambda: mma_lib, x, alpha, beta,
                                          before_taps=(fir.data_ptr(),))

    def amp(x, *args):
        *params, k, d = args
        b, c, t = x.shape
        out = torch.empty_like(x)
        params = [cuda_build.param(p, x.device) for p in params]
        err = amp_lib.amp_iter_forward(
            x.data_ptr(), out.data_ptr(), *(p.data_ptr() for p in params), snake_cuda.fir_taps(),
            int(x.dtype == torch.bfloat16), b, c, t, k, d, prev_amp_tile(c, k, d),
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"earlier amp_iter kernel launch failed: {err}")
        return out

    return dict(mma=mma, amp=amp)


def timed_pair(row: dict, new, old, iters: int) -> None:
    """row["kernel_ms"] and, with `old`, row["prev_ms"]: timed in turns (new,
    old, old, new), each the mean of its two."""
    if old is None:
        row["kernel_ms"] = cuda_ms(new, iters)
        return
    k1, o1, o2, k2 = (cuda_ms(fn, iters) for fn in (new, old, old, new))
    row["kernel_ms"], row["prev_ms"] = (k1 + k2) / 2, (o1 + o2) / 2


def check_kernel(shape, dtype, seed: int, variant: str = "direct", prev: dict | None = None
                 ) -> dict:
    """A forward snake kernel vs plain on the same inputs; "strips" and "mma"
    also vs the direct kernel (strips bitwise), with its time on the same
    inputs; with `prev` (a dict holding an earlier kernel of the variant)
    also the earlier kernel's result and time on the same inputs.
    Returns errors and times."""
    fn = SNAKE_KERNELS[variant]
    xs, alpha, beta = snake_inputs(shape, dtype, seed)
    b, c, t = shape
    n_buf = len(xs)
    got = fn(xs[0], alpha, beta)
    want = snake_alias_fused_cm(xs[0].float(), alpha, beta).to(dtype)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    check(torch.allclose(got.float(), want.float(), **tol),
          f"snake {variant} kernel disagrees at {shape} {dtype}: max abs err {err}")
    iters = 50 if b * c * t < 2_000_000 else 20
    row = dict(shape=list(shape), dtype=str(dtype).removeprefix("torch."), max_abs_err=err)
    if variant != "direct":
        direct = snake_cuda.snake_alias_cuda(xs[0], alpha, beta)
        row["vs_direct"] = (got.float() - direct.float()).abs().max().item()
        same = (torch.equal(got, direct) if variant == "strips"
                else torch.allclose(got.float(), direct.float(), **tol))
        check(same, f"snake {variant} kernel against direct at {shape} {dtype}: max abs diff "
                    f"{row['vs_direct']}" + (", not bitwise equal" if variant == "strips" else ""))
        row["direct_ms"] = cuda_ms(
            lambda i=0: snake_cuda.snake_alias_cuda(xs[i % n_buf], alpha, beta), iters)
        if variant == "strips":
            row["fold"] = snake_cuda.strip_fold(c, t, b)
            # any fold: segments that end inside a tile
            odd = snake_cuda.snake_alias_strips_cuda(xs[0], alpha, beta, fold=min(7, t))
            check(torch.equal(odd, direct),
                  f"snake strips kernel with fold 7 is not bitwise equal to direct at {shape}")
    old = None
    if prev is not None:
        before = prev[variant](xs[0], alpha, beta)
        row["prev_err"] = (before.float() - got.float()).abs().max().item()
        check(torch.allclose(before.float(), got.float(), **tol),
              f"earlier {variant} kernel against the new one at {shape} {dtype}: "
              f"{row['prev_err']}")

        def old(i=0):
            return prev[variant](xs[i % n_buf], alpha, beta)
    timed_pair(row, lambda i=0: fn(xs[i % n_buf], alpha, beta), old, iters)
    row["plain_ms"] = cuda_ms(lambda i=0: snake_alias_fused_cm(xs[i % n_buf], alpha, beta), iters)
    n = b * c * t
    row["bound_ms"], row["bound_by"] = bound_ms(2 * n * xs[0].element_size(),
                                                n * SNAKE_OPS_PER_ELEM)
    return row


def amp_unfused(x, k1, b1, a1, be1, k2, b2, a2, be2, kernel_size: int, d: int):
    """One AMP iteration as the default path runs it on the card: two direct
    snake launches, two cuDNN convolutions (float32, TF32 off), the add."""
    xt = snake_cuda.snake_alias_cuda(x, a1, be1)
    xt = F.conv1d(xt, k1, b1, padding=(kernel_size * d - d) // 2, dilation=d)
    xt = snake_cuda.snake_alias_cuda(xt, a2, be2)
    return F.conv1d(xt, k2, b2, padding=(kernel_size - 1) // 2) + x


def amp_bounds(b: int, c: int, t: int, k: int, itemsize: int) -> tuple[float, str, float]:
    """(bound ms, what bounds it, tensor-core bound ms) of one fused
    iteration: x read once, out written once, both kernels, biases and
    snake parameters read; per element two k-tap C x C mixes (2 k C FMAs =
    4 k C operations) and two snakes (2 x 58). The first bound takes the
    mixes at the f32 rate of the CUDA cores, the second at a third of the
    dense TF32 tensor-core rate (3xTF32), both counting no padding; the
    snakes at the f32 rate."""
    n = b * c * t
    bnd, by = bound_ms(2 * n * itemsize + 4 * (2 * k * c * c + 6 * c),
                       n * (4 * k * c + 2 * SNAKE_OPS_PER_ELEM))
    tc = (3 * n * 4 * k * c / TF32_OPS_PER_S + n * 2 * SNAKE_OPS_PER_ELEM / F32_OPS_PER_S) * 1e3
    return bnd, by, max(tc, (2 * n * itemsize) / HBM_BYTES_PER_S * 1e3)


def check_amp(case, dtype, seed: int, timed: bool, prev: dict | None = None,
              large: bool = False, misaligned: bool = False) -> dict:
    """amp_iter vs amp_iter_ref on the same inputs; with `timed` also the
    kernel's, the plain version's and the unfused route's times, and with
    `prev` the earlier kernel's result and time (in turns with the new one).
    `large`: x * 100, so that the first snake sees |e^alpha x| ~ 1e3, with
    the mixes' weights at 1e-3 so that the second snake's argument stays ~10
    (with the main cases' weights c1 reaches ~1e3, where the second snake is
    so ill-conditioned that the plain version in f32 misses its own f64
    value by several times the tolerance; tests/test_torch_tensor_core_plan.py).
    `misaligned`: x starts 4 bytes past a 16-byte boundary."""
    b, c, t, k, d = case
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    w = 1e-3 if large else 0.1
    params = (r(c, c, k) * w, r(c) * 0.1, r(c) * 0.3, r(c) * 0.3,
              r(c, c, k) * w, r(c) * 0.1, r(c) * 0.3, r(c) * 0.3)
    n_buf = max(1, -(-100_000_000 // (b * c * t * 4))) if timed else 1
    xs = [(r(b, c, t) * (100.0 if large else 1.0)).to(dtype) for _ in range(n_buf)]
    if misaligned:
        xs = [misalign(x) for x in xs]
    got = amp_cuda.amp_iter_cuda(xs[0], *params, k, d)
    want = amp_cuda.amp_iter_ref(xs[0].float(), *params, k, d).to(dtype)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = AMP_F32_TOL if dtype == torch.float32 else BF16_TOL
    label = f"{case} {dtype}" + (" large arguments" if large else "") + (
        " misaligned" if misaligned else "")
    check(torch.allclose(got.float(), want.float(), **tol),
          f"amp_iter disagrees at {label}: max abs err {err}")
    bnd, by, tc = amp_bounds(b, c, t, k, xs[0].element_size())
    row = dict(case=list(case), dtype=str(dtype).removeprefix("torch."), max_abs_err=err,
               tile=amp_cuda.amp_tile(b, c, t, k, d), bound_ms=bnd, bound_by=by,
               tc_bound_ms=tc, large=large, misaligned=misaligned)
    old = None
    if prev is not None:
        before = prev["amp"](xs[0], *params, k, d)
        row["prev_err"] = (before.float() - got.float()).abs().max().item()

        def old(i=0):
            return prev["amp"](xs[i % n_buf], *params, k, d)
    if timed:
        timed_pair(row, lambda i=0: amp_cuda.amp_iter_cuda(xs[i % n_buf], *params, k, d), old,
                   20)
        row["unfused_ms"] = cuda_ms(lambda i=0: amp_unfused(xs[i % n_buf], *params, k, d), 20)
        row["plain_ms"] = cuda_ms(
            lambda i=0: amp_cuda.amp_iter_ref(xs[i % n_buf], *params, k, d), 10)
    return row


def check_mma_corner(shape, dtype, seed: int, large: bool, misaligned: bool) -> dict:
    """The mma kernel against its plain version and the direct kernel at a
    large-argument or misaligned input (untimed), at the same tolerances."""
    xs, alpha, beta = snake_inputs(shape, dtype, seed, large=large, n_buf=1)
    x = misalign(xs[0]) if misaligned else xs[0]
    got = snake_cuda.snake_alias_mma_cuda(x, alpha, beta)
    want = snake_alias_fused_cm(x.float(), alpha, beta).to(dtype)
    direct = snake_cuda.snake_alias_cuda(x, alpha, beta)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    label = f"{shape} {dtype}" + (" large arguments" if large else "") + (
        " misaligned" if misaligned else "")
    errs = {"plain": (got.float() - want.float()).abs().max().item(),
            "direct": (got.float() - direct.float()).abs().max().item()}
    check(torch.allclose(got.float(), want.float(), **tol),
          f"snake mma kernel disagrees at {label}: max abs err {errs['plain']}")
    check(torch.allclose(got.float(), direct.float(), **tol),
          f"snake mma kernel against direct at {label}: max abs diff {errs['direct']}")
    return dict(shape=list(shape), dtype=str(dtype).removeprefix("torch."), large=large,
                misaligned=misaligned, errs=errs,
                max_abs_x_alpha=(x.float().abs().amax(dim=(0, 2)) * alpha.exp()).max().item())


def check_bwd_kernel(shape, dtype, seed: int) -> dict:
    """Backward kernel vs plain backward (autograd through the plain forward,
    in float32 on the same rounded inputs); bitwise-equal dalpha/dbeta across
    two calls; returns errors and times."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, c, t = shape
    alpha = torch.randn(c, device="cuda", generator=g) * 0.3
    beta = torch.randn(c, device="cuda", generator=g) * 0.3
    n_buf = min(256, max(1, -(-100_000_000 // (2 * b * c * t * 4))))
    xs = [(torch.randn(shape, device="cuda", generator=g) * 1.5).to(dtype) for _ in range(n_buf)]
    dys = [torch.randn(shape, device="cuda", generator=g).to(dtype) for _ in range(n_buf)]
    got = snake_cuda.snake_alias_bwd_cuda(xs[0], alpha, beta, dys[0])
    again = snake_cuda.snake_alias_bwd_cuda(xs[0], alpha, beta, dys[0])
    want = snake_cuda.snake_alias_bwd_plain(xs[0].float(), alpha, beta, dys[0].float())
    want = (want[0].to(dtype), want[1], want[2])
    torch.cuda.synchronize()
    tol = BWD_F32_TOL if dtype == torch.float32 else BF16_TOL
    errs = {}
    for name, a, w in zip(("dx", "dalpha", "dbeta"), got, want):
        errs[name] = (a.float() - w.float()).abs().max().item()
        check(torch.allclose(a.float(), w.float(), **tol),
              f"snake backward kernel disagrees on {name} at {shape} {dtype}: "
              f"max abs err {errs[name]}")
    check(torch.equal(got[1], again[1]) and torch.equal(got[2], again[2]),
          f"dalpha/dbeta differ between two calls at {shape} {dtype}")
    iters = 50 if b * c * t < 2_000_000 else 20
    row = dict(shape=list(shape), dtype=str(dtype).removeprefix("torch."),
               max_abs_err=max(errs.values()), errs=errs)
    row["kernel_ms"] = cuda_ms(lambda i=0: snake_cuda.snake_alias_bwd_cuda(
        xs[i % n_buf], alpha, beta, dys[i % n_buf]), iters)
    row["plain_ms"] = cuda_ms(lambda i=0: snake_cuda.snake_alias_bwd_plain(
        xs[i % n_buf], alpha, beta, dys[i % n_buf]), iters)
    n = b * c * t
    # x and dy read once, dx written once; alpha, beta read, dalpha, dbeta written
    row["bound_ms"], row["bound_by"] = bound_ms(3 * n * xs[0].element_size() + 4 * c * 4,
                                                n * SNAKE_BWD_OPS_PER_ELEM)
    return row


def check_corner(shape, dtype, seed: int, large: bool = False, misaligned: bool = False) -> dict:
    """The forward and the backward kernel against their plain versions at one
    corner of the work plan (untimed): the same tolerances as the main
    shapes; dalpha/dbeta bitwise equal across two calls."""
    xs, alpha, beta = snake_inputs(shape, dtype, seed, large=large, n_buf=1)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x, dy = xs[0], torch.randn(shape, device="cuda", generator=g).to(dtype)
    if misaligned:
        x, dy = misalign(x), misalign(dy)
    f32 = dtype == torch.float32
    tol, btol = (F32_TOL, BWD_F32_TOL) if f32 else (BF16_TOL, BF16_TOL)
    got = snake_cuda.snake_alias_cuda(x, alpha, beta)
    want = snake_alias_fused_cm(x.float(), alpha, beta).to(dtype)
    got_b = snake_cuda.snake_alias_bwd_cuda(x, alpha, beta, dy)
    again = snake_cuda.snake_alias_bwd_cuda(x, alpha, beta, dy)
    want_b = snake_cuda.snake_alias_bwd_plain(x.float(), alpha, beta, dy.float())
    want_b = (want_b[0].to(dtype), want_b[1], want_b[2])
    torch.cuda.synchronize()
    label = f"{shape} {dtype}" + (" large arguments" if large else "") + (
        " misaligned" if misaligned else "")
    errs = {"y": (got.float() - want.float()).abs().max().item()}
    check(torch.allclose(got.float(), want.float(), **tol),
          f"snake kernel disagrees at {label}: max abs err {errs['y']}")
    for name, a, w in zip(("dx", "dalpha", "dbeta"), got_b, want_b):
        errs[name] = (a.float() - w.float()).abs().max().item()
        check(torch.allclose(a.float(), w.float(), **btol),
              f"snake backward kernel disagrees on {name} at {label}: max abs err {errs[name]}")
    check(torch.equal(got_b[1], again[1]) and torch.equal(got_b[2], again[2]),
          f"dalpha/dbeta differ between two calls at {label}")
    return dict(shape=list(shape), dtype=str(dtype).removeprefix("torch."), large=large,
                misaligned=misaligned, errs=errs,
                max_abs_x_alpha=(x.float().abs().amax(dim=(0, 2)) * alpha.exp()).max().item())


def per_call_sum(rows, stages, extra: tuple[str, ...] = (),
                 dtype: str = "float32") -> tuple[dict, str]:
    """Kernel, plain and bound ms (and any `extra` column) summed over the
    calls of `stages`, at `dtype`."""
    columns = {"ms": "kernel_ms", "plain_ms": "plain_ms", "bound_ms": "bound_ms"}
    columns |= {name: name for name in extra}
    total = dict.fromkeys(columns, 0.0)
    bound_by = set()
    for shape, calls in stages:
        r = next(r for r in rows if r["shape"] == list(shape) and r["dtype"] == dtype)
        for name, column in columns.items():
            total[name] += calls * r[column]
        bound_by.add(r["bound_by"])
    return total, "/".join(sorted(bound_by))


def alt_kernel_phase(hp, stages, prev: dict | None) -> dict:
    """The strips, mma and fused-iteration kernels against their plain
    versions; per-chunk sums over the calls each takes on its path; with
    `prev`, the earlier mma and fused kernels timed in turns with the new
    ones at the chunk's shapes."""
    out = {}
    both = (torch.float32, torch.bfloat16)
    stage_list = [shape for shape, _ in stages]
    shapes = stage_list + list(ODD_SHAPES) + list(STRIPS_ODD_SHAPES)
    for variant in ("strips", "mma"):
        rows = [check_kernel(shape, dtype, seed=400 + i, variant=variant,
                             prev=prev if variant == "mma" and shape in stage_list else None)
                for i, shape in enumerate(shapes) for dtype in both]
        for r in rows:
            print(f"[kernel-{variant}] " + json.dumps(r), flush=True)
        taken = [(shape, calls) for shape, calls in stages
                 if variant == "mma" or snake_cuda.use_strips(shape[1], shape[2], shape[0])]
        extra = ("direct_ms",) + (("prev_ms",) if prev and variant == "mma" else ())
        total, by = per_call_sum(rows, taken, extra=extra)
        n_calls = sum(calls for _, calls in taken)
        print(f"[kernel-{variant}] per {CHUNK_FRAMES}-frame chunk, f32, the {n_calls} calls "
              f"the variant takes: {json.dumps(total)}", flush=True)
        out |= {variant: total, f"{variant}_rows": rows, f"{variant}_bound_by": by,
                f"{variant}_calls": n_calls}
    corners = [(shape, True, False) for shape in LARGE_ARG_SHAPES]
    corners += [((2, 16, 1024), False, True), ((16, 160, 125), False, True)]
    for i, (shape, large, misaligned) in enumerate(corners):
        for dtype in both:
            r = check_mma_corner(shape, dtype, seed=450 + i, large=large, misaligned=misaligned)
            print("[kernel-mma-corner] " + json.dumps(r), flush=True)

    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on for the plain convolutions")
    cases = [(b, c, t, k, d) for (b, c, t), _ in stages if amp_cuda.use_fused_iter(c, t, b)
             for k, dil in zip(hp.gen.resblock_kernel_sizes, hp.gen.resblock_dilation_sizes)
             for d in dil]
    rows = []
    for i, case in enumerate(cases):
        rows.append(check_amp(case, torch.float32, seed=500 + i, timed=True, prev=prev))
        rows.append(check_amp(case, torch.bfloat16, seed=500 + i, timed=False))
    for i, case in enumerate(AMP_ODD_CASES):
        rows += [check_amp(case, dtype, seed=600 + i, timed=False) for dtype in both]
    for i, case in enumerate(AMP_CORNER_CASES):
        for dtype in both:
            rows.append(check_amp(case, dtype, seed=650 + i, timed=False, large=True))
            rows.append(check_amp(case, dtype, seed=660 + i, timed=False, misaligned=True))
    for r in rows:
        print("[kernel-amp] " + json.dumps(r), flush=True)
    timed = [r for r in rows if "kernel_ms" in r]
    columns = (("ms", "kernel_ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"),
               ("tc_bound_ms", "tc_bound_ms"), ("unfused_ms", "unfused_ms"))
    columns += (("prev_ms", "prev_ms"),) if prev else ()
    total = {name: sum(r[column] for r in timed) for name, column in columns}
    print(f"[kernel-amp] per {CHUNK_FRAMES}-frame chunk, f32, {len(timed)} calls: "
          f"{json.dumps(total)}", flush=True)
    if prev:
        print(f"[compare-prev] f32, CUDA events, cold L2, same inputs, in turns: mma "
              f"{out['mma']['ms']:.4f} ms per chunk (earlier {out['mma']['prev_ms']:.4f}, "
              f"direct {out['mma']['direct_ms']:.4f}); amp_iter {total['ms']:.4f} ms per chunk "
              f"(earlier {total['prev_ms']:.4f}, unfused {total['unfused_ms']:.4f})",
              flush=True)
    out |= {"amp": total, "amp_rows": rows, "amp_calls": len(timed),
            "amp_bound_by": "/".join(sorted({r["bound_by"] for r in timed}))}
    return out


def alt_config_phase(hp, model, cpu_model, short_req, cpu_audio) -> dict:
    """`svc_infer` with the default model's weights in each alternative
    configuration: launches per chunk, waveforms against the default
    configuration's, wall and device time beside the default's; the fused
    configuration also against the CPU on `short_req` (out_chunk=200)."""
    hop, sr = hp.data.hop_length, hp.data.sampling_rate
    reqs = [features(hp, frames, seed=10 + i) for i, frames in enumerate(ALT_REQUEST_FRAMES)]
    n_chunks = sum(len(pipeline._chunk_plan(f, 1000, 10)) for f in ALT_REQUEST_FRAMES)
    audio_s = sum(ALT_REQUEST_FRAMES) * hop / sr
    run = dict(hp=hp, device="cuda")

    def drive(m, label):
        pipeline.svc_infer(m, DummyRetrieval(), *reqs[1], **run)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        audios, walls = [], []
        for frames, req in zip(ALT_REQUEST_FRAMES, reqs):
            t0 = time.perf_counter()
            audio = pipeline.svc_infer(m, DummyRetrieval(), *req, **run)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            rms = float(np.sqrt(np.mean(np.square(audio))))
            check(audio.shape == (frames * hop,), f"{label}: output shape {audio.shape}")
            check(bool(np.isfinite(audio).all()), f"{label}: non-finite samples")
            check(rms > 1e-3, f"{label}: silent output (rms {rms})")
            audios.append(audio)
        counts = read_counts()
        prof = profile(lambda: pipeline.svc_infer(m, DummyRetrieval(), *reqs[1], **run))
        return dict(audios=audios, walls=walls, counts=counts, device_ms=prof["busy_ms"],
                    kinds=prof["kinds"])

    def report(label, r):
        wall = sum(r["walls"])
        print(f"[requests-{label}] {n_chunks} chunks ({audio_s:.2f} s audio): wall ms "
              f"{[round(w, 2) for w in r['walls']]}, realtime x{audio_s / (wall / 1e3):.2f}, "
              f"device {r['device_ms']:.2f} ms per chunk (200-frame request, profiler on), "
              f"launches {json.dumps(r['counts'])}, device ms by kind "
              + json.dumps({k: round(v, 3) for k, v in r["kinds"].items() if v}), flush=True)

    base = drive(model, "default")
    check(base["counts"] == dict(direct=91 * n_chunks, bwd=0, strips=0, mma=0, amp=0),
          f"default configuration launches {base['counts']}")
    report("default", base)
    out = {"default": base}
    for label, kwargs in ALT_CONFIGS.items():
        m = pipeline.build_infer_model(hp, device="cuda", seed=0, **kwargs)
        m.load_state_dict(model.state_dict())
        r = drive(m, label)
        want = dict(direct=0, bwd=0, strips=0, mma=0, amp=0) | {
            k: v * n_chunks for k, v in ALT_LAUNCHES_PER_CHUNK[label].items()}
        check(r["counts"] == want, f"{label} configuration launches {r['counts']}, "
                                   f"expected {want}")
        r["err"] = max(float(np.abs(a - b).max()) for a, b in zip(r["audios"], base["audios"]))
        check(r["err"] <= CARD_VS_CPU_ATOL,
              f"{label} configuration vs default on the card: max abs err {r['err']}")
        report(label, r)
        print(f"[requests-{label}] vs the default configuration on the card: max abs err "
              f"{r['err']:.3e} (tolerance {CARD_VS_CPU_ATOL})", flush=True)
        if label == "fused":
            short = dict(hp=hp, out_chunk=200)
            card = pipeline.svc_infer(m, DummyRetrieval(), *short_req, device="cuda", **short)
            cpu_m = pipeline.build_infer_model(hp, device="cpu", seed=0, **kwargs)
            cpu_m.load_state_dict(cpu_model.state_dict())
            cpu = pipeline.svc_infer(cpu_m, DummyRetrieval(), *short_req, device="cpu", **short)
            err = float(np.abs(card - cpu).max())
            same = float(np.abs(cpu - cpu_audio).max())
            print(f"[requests-fused] card vs CPU (amp_iter_ref), 200 frames: max abs err "
                  f"{err:.3e} (tolerance {CARD_VS_CPU_ATOL}); the CPU's fused and default "
                  f"configurations differ by {same:.3e}", flush=True)
            check(err <= CARD_VS_CPU_ATOL, f"fused configuration card vs CPU: {err}")
            del cpu_m
        del r["audios"], m
        out[label] = r
    del base["audios"]
    return out


def features(hp, frames: int, seed: int):
    """Seeded features: F0 110-440 Hz with vibrato and 40-frame unvoiced
    runs every 300 frames."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames)
    pit = (220.0 * 2 ** np.sin(2 * np.pi * t / 400.0) * (1 + 0.02 * np.sin(t / 3.0)))
    pit[(t % 300) >= 260] = 0.0
    spk = rng.standard_normal(hp.vits.spk_dim) / np.sqrt(hp.vits.spk_dim)
    ppg = rng.standard_normal((frames, hp.vits.ppg_dim)) * 0.5
    vec = rng.standard_normal((frames, hp.vits.vec_dim)) * 0.5
    return (spk.astype(np.float32), pit.astype(np.float32), ppg.astype(np.float32),
            vec.astype(np.float32))


def train_batch(hp, batch: int, frames: int, seed: int) -> dict:
    """A synthetic training batch, as bench_train.py:44-56 makes it."""
    r = np.random.default_rng(seed)
    hop = hp.data.hop_length
    return dict(
        ppg=r.standard_normal((batch, frames, hp.vits.ppg_dim)).astype(np.float32) * 0.1,
        vec=r.standard_normal((batch, frames, hp.vits.vec_dim)).astype(np.float32) * 0.1,
        pit=r.uniform(100, 400, (batch, frames)).astype(np.float32),
        spk=r.standard_normal((batch, hp.vits.spk_dim)).astype(np.float32),
        spec=np.abs(r.standard_normal(
            (batch, frames, hp.data.filter_length // 2 + 1))).astype(np.float32),
        audio=(r.standard_normal((batch, frames * hop, 1)) * 0.2).astype(np.float32),
        ppg_l=np.full((batch,), frames, np.int32),
        spec_l=np.full((batch,), frames, np.int32),
    )


# device kernels by kind, from their names (first match wins)
KERNEL_KINDS = (
    ("snake_bwd", ("snake_alias_bwd",)),
    ("snake_fwd", ("snake_alias_kernel",)),
    ("snake_strips", ("snake_alias_strips_kernel",)),
    ("snake_mma", ("snake_alias_mma_kernel",)),
    ("amp_iter", ("amp_iter_kernel",)),
    # cuDNN's convolution kernels: implicit GEMMs ("fprop", "dgrad", "wgrad"),
    # winograd, FFT; cuBLAS's sm80_xmma_gemm_* are matmuls
    ("conv", ("cudnn", "fprop", "implicit", "wgrad", "dgrad", "conv", "winograd", "fft")),
    ("matmul", ("gemm", "cutlass", "sm90_")),
    ("optimizer", ("multi_tensor_apply",)),
    ("reduction", ("reduce_kernel",)),
    ("copy", ("Memcpy", "Memset", "copy")),
    ("elementwise", ("elementwise", "unrolled", "vectorized")),
)


def profile(fn) -> dict:
    """torch.profiler over fn(): the table by device time, wall ms, device
    busy ms (kernels, copies; no user-annotation ranges), device ms and
    kernel count by kernel kind."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds = {kind: 0.0 for kind, _ in KERNEL_KINDS} | {"other": 0.0}
    counts = dict.fromkeys(kinds, 0)
    names: dict = {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        kind = kernel_kind(e.name)
        kinds[kind] += e.time_range.elapsed_us() / 1e3
        counts[kind] += 1
        names[e.name] = names.get(e.name, 0) + 1
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=15,
                                      max_name_column_width=48)
    return dict(table=table, wall_ms=wall_us / 1e3, busy_ms=sum(kinds.values()),
                kinds=kinds, counts=counts, names=names)


def snake_param_indices(model) -> list[int]:
    return [i for i, (n, _) in enumerate(model.named_parameters())
            if n.endswith(".act.alpha") or n.endswith(".act.beta")]


def train_phase(hp) -> dict:
    """The training entry points at hp's width: one warm-up step, then
    TIMED_STEPS timed steps, then one profiled step. Returns the states and
    the numbers to report."""
    g_state, d_state = tstep.init_train_states(hp, seed=0, device="cuda")
    step = tstep.make_train_step(hp, g_state, d_state)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch_size, accum = hp.train.batch_size, hp.train.accum_step
    batches = [train_batch(hp, batch_size, TRAIN_FRAMES, seed=i)
               for i in range(TIMED_STEPS + 2)]

    n_snakes = sum(calls for _, calls in stage_shapes(hp, 1, 1))  # 91 at base width
    # every snake alpha/beta gradient that reaches G's optimizer, flattened
    snake_idx = snake_param_indices(g_state.model)
    check(len(snake_idx) == 2 * n_snakes,
          f"{len(snake_idx)} snake parameters in G, expected {2 * n_snakes}")
    snake_grads = []
    apply_g = g_state.apply_gradients

    def spy(grads):
        snake_grads.append(torch.cat([grads[i].flatten() for i in snake_idx]))
        return apply_g(grads)

    g_state.apply_gradients = spy

    def snapshot():
        return ([p.detach().clone() for p in g_state.model.parameters()],
                [p.detach().clone() for p in d_state.model.parameters()])

    def moved(before, model):
        return [not torch.equal(b, p.detach()) for b, p in zip(before, model.parameters())]

    step_ms = []
    for i, batch in enumerate(batches[: TIMED_STEPS + 1]):
        g_before, d_before = snapshot()
        fwd0, bwd0 = snake_cuda.launches, snake_cuda.launches_bwd
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = snake_cuda.launches - fwd0, snake_cuda.launches_bwd - bwd0
        check(fwd == n_snakes and bwd == n_snakes,
              f"step {i}: {fwd} forward and {bwd} backward snake launches, "
              f"expected {n_snakes} each")
        metrics = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in metrics.values()), f"step {i}: non-finite {metrics}")
        g_moved, d_moved = moved(g_before, g_state.model), moved(d_before, d_state.model)
        check(all(d_moved), f"step {i}: {d_moved.count(False)} D parameters did not move")
        if (i + 1) % accum == 0:
            check(all(g_moved), f"step {i}: {g_moved.count(False)} G parameters did not move")
        else:
            check(not any(g_moved), f"step {i}: {sum(g_moved)} G parameters moved "
                                    f"between accumulation steps")
        grads = snake_grads[-1]
        check(bool(torch.isfinite(grads).all()) and bool((grads != 0).all()),
              f"step {i}: {int((~torch.isfinite(grads)).sum())} non-finite and "
              f"{int((grads == 0).sum())} zero snake alpha/beta gradients")
        print(f"[train] step {i}{' (warm-up)' if i == 0 else ''}: {wall * 1e3:.2f} ms, "
              f"G stepped {all(g_moved)}, snake launches fwd {fwd} bwd {bwd}, "
              + json.dumps({k: round(v, 5) for k, v in metrics.items()}), flush=True)
        if i:
            step_ms.append(wall * 1e3)
        del g_before, d_before
    g_state.apply_gradients = apply_g

    torch.cuda.reset_peak_memory_stats()
    prof = profile(lambda: step(batches[TIMED_STEPS + 1], gen))
    return dict(g_state=g_state, d_state=d_state, step_ms=step_ms, profile=prof,
                peak_bytes=torch.cuda.max_memory_allocated())


@contextlib.contextmanager
def branch_pattern(replay: list | None = None):
    """Record, in call order, the branch that every ReLU, leaky-ReLU and abs
    input takes (x > 0, or sign(x) for abs); or, given such a recording,
    make each call take the recorded branch, counting the inputs whose own
    branch differs. Yields {"taken": [...], "flips": n}."""
    state = {"taken": [], "flips": 0}
    calls = None if replay is None else iter(replay)
    # F.relu and nn.ReLU go through torch.relu
    orig = {"leaky_relu": F.leaky_relu, "relu": torch.relu, "abs": torch.abs}

    def wrap(name, fn):
        def wrapped(x, *args, **kwargs):
            own = torch.sign(x) if name == "abs" else x > 0
            if calls is None:
                state["taken"].append(own.cpu())
                return fn(x, *args, **kwargs)
            taken = next(calls).to(x.device)
            state["flips"] += int((taken != own).sum())
            if name == "abs":
                return x * taken
            slope = 0.0
            if name == "leaky_relu":
                slope = args[0] if args else kwargs.get("negative_slope", 0.01)
            return torch.where(taken, x, x * slope)
        return wrapped

    F.leaky_relu = wrap("leaky_relu", F.leaky_relu)
    torch.relu, torch.abs = wrap("relu", torch.relu), wrap("abs", torch.abs)
    try:
        yield state
    finally:
        F.leaky_relu, torch.relu, torch.abs = orig["leaky_relu"], orig["relu"], orig["abs"]


def train_card_vs_cpu(hp, g_model, d_model, device="cuda",
                      cpu_dtype: torch.dtype = torch.float32,
                      cpu_threads: int | None = CHECK_CPU_THREADS) -> dict:
    """loss_and_grads on the card and on the CPU, same batch, every
    stochastic node frozen, and every ReLU, leaky-ReLU and abs on the CPU
    taking the branch it took on the card. Both sides start from the seeded
    initial weights, loaded into the card's models, so that the reading does
    not depend on the card's non-deterministic weight-gradient sums in the
    steps before. The CPU side computes in `cpu_dtype` (its inputs are the
    card's float32 values, exact in float64) on `cpu_threads` threads (the
    process's count is restored after; None keeps it). `device` is the
    card's side (the CPU to rehearse the check)."""
    g_state, d_state = tstep.init_train_states(hp, seed=0, device="cpu")
    g_cpu, d_cpu = g_state.model, d_state.model
    g_model.load_state_dict(g_cpu.state_dict())
    d_model.load_state_dict(d_cpu.state_dict())
    g_cpu.to(cpu_dtype)
    d_cpu.to(cpu_dtype)
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[cpu_dtype]
    batch = train_batch(hp, CHECK_BATCH, CHECK_FRAMES, seed=99)
    batch_cpu = {k: v.astype(np_dtype) if v.dtype == np.float32 else v for k, v in batch.items()}
    frozen = dict(train=False, perturb=False, noise_scale=0.0)
    ids = torch.tensor(CHECK_SLICE_IDS)
    threads = torch.get_num_threads()
    if cpu_threads:
        torch.set_num_threads(cpu_threads)
    try:
        return _train_card_vs_cpu(hp, g_model, d_model, g_cpu, d_cpu, batch, batch_cpu, ids,
                                  frozen, device)
    finally:
        torch.set_num_threads(threads)


def _train_card_vs_cpu(hp, g_model, d_model, g_cpu, d_cpu, batch, batch_cpu, ids, frozen,
                       device) -> dict:
    with branch_pattern() as card_branches:
        card = tstep.loss_and_grads(hp, g_model, d_model, batch, slice_ids=ids.to(device),
                                    **frozen)
    sync(device)
    t0 = time.perf_counter()
    with branch_pattern(replay=card_branches["taken"]) as cpu_branches:
        cpu = tstep.loss_and_grads(hp, g_cpu, d_cpu, batch_cpu, slice_ids=ids, **frozen)
    cpu_s = time.perf_counter() - t0
    loss_err = {k: abs(float(card[2][k]) - float(cpu[2][k])) / abs(float(cpu[2][k]))
                for k in cpu[2]}
    rel, zero = [], []
    for which, model, gc, gp in (("G", g_cpu, card[0], cpu[0]), ("D", d_cpu, card[1], cpu[1])):
        norms = {name: torch.linalg.vector_norm(b).item()
                 for (name, _), b in zip(model.named_parameters(), gp)}
        for (name, _), a, b in zip(model.named_parameters(), gc, gp):
            d = torch.linalg.vector_norm(a.cpu().double() - b).item()
            if name.endswith(ZERO_GRAD_SUFFIX):
                scale = norms[name.replace(".conv_k.", ".conv_q.")]
                size = max(torch.linalg.vector_norm(a).item(), norms[name])
                zero.append((size / scale, f"{which}:{name}"))
                continue
            n = norms[name]
            rel.append((d / n if n else (0.0 if d == 0 else float("inf")), f"{which}:{name}"))
    rel.sort(reverse=True)
    zero.sort(reverse=True)

    # where a difference enters: for the CPU's generated audio, each audio
    # loss term's gradient with respect to it on both sides, then G's VJP
    # of one fixed d loss / d audio on both sides
    def rel_l2(a, ref):
        return (torch.linalg.vector_norm(a.cpu().double() - ref)
                / torch.linalg.vector_norm(ref)).item()

    def to_card(t):
        return t.to(device, torch.float32) if t.is_floating_point() else t.to(device)

    def same_values(t):
        """t rounded to float32 values, in the CPU side's dtype: both sides
        then start from the same numbers."""
        return t.float().to(g_cpu.emb_g.weight.dtype)

    inputs = {k: torch.as_tensor(v) for k, v in batch_cpu.items()}
    args = [inputs[k] for k in ("ppg", "vec", "pit", "spec", "spk", "ppg_l", "spec_l")]
    out_cpu = g_cpu(*args, slice_ids=ids, **frozen)
    real = slice_segments(inputs["audio"], out_cpu.ids_slice * hp.data.hop_length,
                          hp.data.segment_size)
    fake = same_values(out_cpu.fake_audio.detach())
    audio_grads, taken = [], None
    for move, disc in ((to_card, d_model), (lambda t: t, d_cpu)):
        audio = move(fake).requires_grad_(True)
        with branch_pattern(replay=taken) as branches:
            terms = tstep.audio_losses(hp, disc, audio, move(real))
        taken = branches["taken"]
        audio_grads.append({k: torch.autograd.grad(terms[k], audio, retain_graph=True)[0]
                            for k in ("loss_m", "loss_s", "score_loss", "feat_loss")})
    term_rel = {k: rel_l2(audio_grads[0][k], v) for k, v in audio_grads[1].items()}
    d_audio = same_values(sum(audio_grads[1].values()))
    out_card = g_model(*(to_card(a) for a in args), slice_ids=ids.to(device), **frozen)
    vjp_card = torch.autograd.grad(out_card.fake_audio, list(g_model.parameters()),
                                   to_card(d_audio), allow_unused=True)
    vjp_cpu = torch.autograd.grad(out_cpu.fake_audio, list(g_cpu.parameters()), d_audio,
                                  allow_unused=True)
    vjp_rel = sorted(((rel_l2(a, c), name) for (name, _), a, c
                      in zip(g_cpu.named_parameters(), vjp_card, vjp_cpu) if c is not None),
                     reverse=True)
    return dict(loss_rel=loss_err, grad_rel=rel, zero_rel=zero, flips=cpu_branches["flips"],
                kinks=sum(t.numel() for t in card_branches["taken"]), cpu_s=cpu_s,
                term_rel=term_rel, vjp_rel=vjp_rel)


def write_dataset(hp, root: Path, seed: int) -> tuple[str, str, int]:
    """A synthetic data_svc cache in the reference's layout, drawn from
    `seed`: per utterance a 32 kHz int16 wav (a sine at its F0 plus noise),
    a [frames, bins] spec .npy, frames + 1 F0 values, the PPG and vec at the
    320-hop rate (half the frames, plus 2) and a speaker vector; LOOP_UTTERANCES
    utterances per bucket. Returns (train filelist, validation filelist of
    the first LOOP_VAL_UTTERANCES, bytes written)."""
    rng = np.random.default_rng(seed)
    hop, sr = hp.data.hop_length, hp.data.sampling_rate
    seg = hp.data.segment_size // hop
    lengths = np.concatenate([rng.integers(6 * seg + 10, 12 * seg + 1, LOOP_UTTERANCES[0]),
                              rng.integers(12 * seg + 1, 16 * seg + 1, LOOP_UTTERANCES[1])])
    root.mkdir(parents=True)
    rows = []
    for i, frames in enumerate(rng.permutation(lengths)):
        base = root / f"utt{i:03d}"
        f0 = rng.uniform(110.0, 440.0) * (1 + 0.02 * np.sin(np.arange(frames + 1) / 7.0))
        phase = 2 * np.pi * np.cumsum(np.repeat(f0[:frames], hop)) / sr
        save_wav(f"{base}.wav", 0.3 * np.sin(phase) + 0.01 * rng.standard_normal(phase.size), sr)
        np.save(f"{base}.spec.npy", np.abs(rng.standard_normal(
            (frames, hp.data.filter_length // 2 + 1))).astype(np.float32))
        np.save(f"{base}.pit.npy", f0.astype(np.float32))
        half = frames // 2 + 2
        np.save(f"{base}.vec.npy", rng.standard_normal((half, hp.vits.vec_dim)).astype(np.float32))
        np.save(f"{base}.ppg.npy", rng.standard_normal((half, hp.vits.ppg_dim)).astype(np.float32))
        np.save(f"{base}.spk.npy", rng.standard_normal(hp.vits.spk_dim).astype(np.float32))
        rows.append("|".join(f"{base}.{ext}" for ext in
                             ("wav", "spec.npy", "pit.npy", "vec.npy", "ppg.npy", "spk.npy")))
    train, valid = root / "train.txt", root / "valid.txt"
    train.write_text("\n".join(rows))
    valid.write_text("\n".join(rows[:LOOP_VAL_UTTERANCES]))
    return str(train), str(valid), sum(f.stat().st_size for f in root.iterdir())


EXTRAS_SONG_SECONDS = 30.5  # [audio-in]'s song
# F0 on the card against the port's CPU on the same song (the engines whose
# device part differs: the FFTs, STFT products and Viterbi trellises in
# float32): the share of frames whose voicing may differ, and the largest
# difference, in cents, of a frame voiced on both sides
F0_VOICING_SHARE = 0.01
F0_CENTS = 50.0
# silero speech probabilities, card vs CPU, float32 both: with silero_random's
# weights the CPU's float32 is 7.9e-5 from float64 on the CPU; the card was
# 2.14e-4 from the CPU (measured on one H100 80GB HBM3, 700 W)
VAD_ATOL = 1e-3
MERGE_RATIO = 0.3


def silero_random(seed: int) -> dict:
    """A SileroVAD state_dict at the v3 widths: the blob's hann DFT basis,
    a normalised 7-tap filter and seeded random weights elsewhere, the
    matrices 3x random_state_dict's so that the probabilities spread
    (0.13-0.50 over a sung line, where 1x keeps them within 0.49-0.50)."""
    from whisper_vits_svc_tpu_torch.models import silero_vad

    with torch.device("meta"):
        shapes = silero_vad.SileroVAD()
    sd = {k: 3.0 * v if v.dim() >= 2 else v
          for k, v in random_state_dict(shapes, seed, "cpu").items()}
    n = torch.arange(silero_vad.N_FFT, dtype=torch.float64)
    k = torch.arange(silero_vad.N_FFT // 2 + 1, dtype=torch.float64)[:, None]
    window = 0.5 - 0.5 * torch.cos(2 * torch.pi * n / silero_vad.N_FFT)
    phase = 2 * torch.pi * k * n / silero_vad.N_FFT
    sd["stft_basis"] = (torch.cat([torch.cos(phase), -torch.sin(phase)]) * window).float()
    sd["an_filter"] = torch.softmax(sd["an_filter"], 0)
    for name in sd:
        if name.endswith("bn_scale"):
            sd[name] = sd[name].abs() + 0.5
    return sd


@contextlib.contextmanager
def snake_dtypes(key=lambda x: str(x.dtype).removeprefix("torch.")):
    """Count the direct snake kernel's launches by the dtype of their input,
    or by another `key` of it (wrapping the wrapper, whose count it leaves
    as it is)."""
    orig = snake_cuda.snake_alias_cuda
    seen: dict = {}

    def wrapped(x, alpha, beta):
        k = key(x)
        seen[k] = seen.get(k, 0) + 1
        return orig(x, alpha, beta)

    snake_cuda.snake_alias_cuda = wrapped
    try:
        yield seen
    finally:
        snake_cuda.snake_alias_cuda = orig


@contextlib.contextmanager
def captured_snakes(key):
    """Count the direct snake kernel's launches by `key` (as snake_dtypes)
    in each CUDA graph capture of a push forward, where they are recorded
    once for every replay, which makes no call to count. Yields the list of
    the captures' counts."""
    orig = stream_mod._capture
    seen: list = []

    def capture(fn, dev):
        with snake_dtypes(key) as calls:
            out = orig(fn, dev)
        seen.append(dict(calls))
        return out

    stream_mod._capture = capture
    try:
        yield seen
    finally:
        stream_mod._capture = orig


def tile_key(x) -> str:
    """The direct snake's input as the JAX package's kernels split it: T
    no multiple of 128 (its `_kernel_padded`) or whole 128-wide tiles."""
    return "padded" if x.shape[-1] % 128 else "tiled"


def extras_request(workdir: Path, argv: list, device, n_snakes: int, hop: int) -> dict:
    """One request through the CLI's `main` with features in, in a fresh
    working directory, every count set to 0 just before it and read just
    after; records the wall, svc_infer's wall and waveform, the snake
    launches by dtype and the peak device memory."""
    workdir.mkdir()
    cwd, rec = os.getcwd(), dict(load=0.0)
    orig = {name: getattr(pipeline, name)
            for name in ("svc_infer", "build_infer_model", "load_svc_model")}

    def timed(name):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig[name](*args, **kwargs)
            sync(device)
            if name == "svc_infer":
                rec["synthesis"], rec["audio"] = time.perf_counter() - t0, out[0]
            else:
                rec["load"] += time.perf_counter() - t0
            return out
        return wrapper

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    os.chdir(workdir)
    for name in orig:
        setattr(pipeline, name, timed(name))
    try:
        with snake_dtypes() as dtypes:
            sync(device)
            t0 = time.perf_counter()
            cli_inference.main(argv)
            sync(device)
            rec["wall"] = time.perf_counter() - t0
        counts = read_counts()
        wav_sr, wav = wavfile.read("svc_out.wav")
    finally:
        for name, fn in orig.items():
            setattr(pipeline, name, fn)
        os.chdir(cwd)
    frames = len(rec["audio"]) // hop
    chunks = len(pipeline._chunk_plan(frames, 1000, 10))
    audio = rec["audio"]
    check(wav.shape == audio.shape and bool(np.isfinite(audio).all())
          and float(np.sqrt(np.mean(np.square(audio)))) > 1e-3,
          f"request {workdir.name}: {wav.shape} samples, finite {np.isfinite(audio).all()}")
    check(counts["direct"] == n_snakes * chunks and counts["bwd"] == counts["strips"]
          == counts["mma"] == counts["amp"] == 0,
          f"request {workdir.name}: {counts} launches for {chunks} chunks, expected "
          f"{n_snakes} direct per chunk")
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    return rec | dict(counts=counts, dtypes=dict(dtypes), chunks=chunks, frames=frames,
                      peak=peak, sr=wav_sr)


def f0_agreement(card: np.ndarray, cpu: np.ndarray) -> dict:
    """Voicing flips (share of frames) and the largest cents difference of
    the frames voiced on both sides."""
    n = min(len(card), len(cpu))
    card, cpu = card[:n], cpu[:n]
    both = (card > 0) & (cpu > 0)
    cents = np.abs(1200.0 * np.log2(card[both] / cpu[both])) if both.any() else np.zeros(1)
    return dict(frames=n, voiced=float((card > 0).mean()),
                flips=float(((card > 0) != (cpu > 0)).mean()), max_cents=float(cents.max()),
                p99_cents=float(np.percentile(cents, 99)), same_len=len(card) == len(cpu))


def infer_extras_phase(base_hp, smi: str, device="cuda", n_snakes: int = 91,
                       song_seconds: float = EXTRAS_SONG_SECONDS,
                       crepe_capacity: str = "full") -> dict:
    """The rest of inference through the port's entry points: the CLI's
    `main` with features in, float32 and --bf16 (snake launches by dtype,
    the waveforms held to each other within the JAX package's bf16 bound),
    device ms per chunk of both from torch.profiler; a fast_edges request on
    the card and on the CPU (no snake kernel); every --f0-engine on the song
    (card against CPU where the engine has a device part); the silero VAD
    (card against CPU) and the post filter's mask; merge and eva through
    cli.misc, the merged model through one chunk. Prints each part's lines,
    with `smi` (the card's name and power limit), as it goes."""
    from whisper_vits_svc_tpu_torch.cli import misc as cli_misc
    from whisper_vits_svc_tpu_torch.infer import post as post_mod
    from whisper_vits_svc_tpu_torch.models import silero_vad

    root = Path(tempfile.mkdtemp(prefix="svc_infer_extras_"))
    phase_t0 = time.perf_counter()
    dev = torch.device(device)
    try:
        hp = config_from_dict(base_hp)
        hop = hp.data.hop_length
        model = pipeline.build_infer_model(hp, device=dev, seed=0)
        torch.save({"model_g": model.state_dict()}, root / "model.pth")
        (root / "config.json").write_text(json.dumps(base_hp))
        song = synthetic_voice(song_seconds, SONG_SR, seed=22)
        save_wav(str(root / "song.wav"), song, SONG_SR)
        song16, _ = audio_io.load_wav(str(root / "song.wav"), target_sr=16000)
        n = len(song16) // 320  # feature frames at the extractors' 320-sample hop
        spk, pit, _, _ = features(hp, 2 * n, seed=40)
        _, _, ppg, vec = features(hp, n, seed=41)
        for name, arr in (("spk", spk), ("ppg", ppg), ("vec", vec)):
            np.save(root / f"{name}.npy", arr, allow_pickle=False)
        pipeline.save_csv_pitch(pit, str(root / "pit.csv"))
        argv = ["--config", str(root / "config.json"), "--model", str(root / "model.pth"),
                "--spk", str(root / "spk.npy"), "--ppg", str(root / "ppg.npy"),
                "--vec", str(root / "vec.npy"), "--pit", str(root / "pit.csv"),
                "--device", str(dev)]
        out = dict(song_s=len(song) / SONG_SR)

        # float32 and bf16 requests; the first bf16 one warms bf16 up
        reqs = {}
        for label, extra in (("bf16_first", ["--bf16"]), ("f32", []), ("bf16", ["--bf16"])):
            reqs[label] = extras_request(root / label, argv + extra, dev, n_snakes, hop)
        for label in ("bf16_first", "bf16"):
            r = reqs[label]
            check(r["dtypes"] == ({"bfloat16": n_snakes * r["chunks"]} if n_snakes else {}),
                  f"{label} request: snake launches by dtype {r['dtypes']}, expected "
                  f"{n_snakes} bfloat16 per chunk")
        check(reqs["f32"]["dtypes"] == ({"float32": n_snakes * reqs["f32"]["chunks"]}
                                        if n_snakes else {}),
              f"f32 request: snake launches by dtype {reqs['f32']['dtypes']}")
        a32, a16 = reqs["f32"]["audio"], reqs["bf16"]["audio"]
        out["bf16_median"] = float(np.median(np.abs(a16 - a32)))
        out["bf16_max"] = float(np.abs(a16 - a32).max())
        out["bf16_corr"] = float(np.corrcoef(a16, a32)[0, 1])
        check(out["bf16_median"] < 0.05 and out["bf16_corr"] > 0.9,
              f"bf16 against f32 waveform: median abs {out['bf16_median']:.3e}, "
              f"correlation {out['bf16_corr']:.5f} (JAX's bound: < 0.05, > 0.9)")
        out["bf16_repeat"] = float(np.abs(reqs["bf16_first"]["audio"] - a16).max())
        out["reqs"] = {k: {key: v[key] for key in ("wall", "synthesis", "load", "counts",
                                                 "dtypes", "chunks", "frames", "peak")}
                       for k, v in reqs.items()}
        for label in ("f32", "bf16"):
            r = reqs[label]
            print(f"[infer-extras] {label} request, features in: {out['song_s']:.2f} s song, "
                  f"{r['frames']} frames, {r['chunks']} chunks; CLI main wall "
                  f"{1e3 * r['wall']:.2f} ms (realtime x{out['song_s'] / r['wall']:.2f}), "
                  f"the synthesizer's build and load {1e3 * r['load']:.2f} ms, svc_infer "
                  f"{1e3 * r['synthesis']:.2f} ms (x{out['song_s'] / r['synthesis']:.2f}); "
                  f"snake launches "
                  f"{r['counts']['direct']} by dtype {json.dumps(r['dtypes'])}; peak device "
                  f"memory {r['peak'] / 2**30:.2f} GiB | {smi}", flush=True)
        r = reqs["bf16_first"]
        print(f"[infer-extras] the first bf16 request (warm-up): wall {1e3 * r['wall']:.2f} ms, "
              f"build and load {1e3 * r['load']:.2f} ms, svc_infer "
              f"{1e3 * r['synthesis']:.2f} ms; its waveform against the second's max abs "
              f"{out['bf16_repeat']:.3e} | {smi}", flush=True)
        print(f"[infer-extras] bf16 against f32 waveform: median abs {out['bf16_median']:.3e}, "
              f"max {out['bf16_max']:.3e}, correlation {out['bf16_corr']:.6f} (JAX's bound: "
              f"median < 0.05, correlation > 0.9) | {smi}", flush=True)

        # device time of one 1020-frame chunk in each dtype
        one = features(hp, 1000, seed=42)
        run = dict(hp=hp, device=dev)
        out["chunk_prof"] = {}
        if dev.type == "cuda":
            for label, dt in (("f32", None), ("bf16", torch.bfloat16)):
                pipeline.svc_infer(model, DummyRetrieval(), *one, compute_dtype=dt, **run)
                prof = profile(lambda dt=dt: pipeline.svc_infer(
                    model, DummyRetrieval(), *one, compute_dtype=dt, **run))
                out["chunk_prof"][label] = {k: prof[k] for k in ("wall_ms", "busy_ms", "kinds",
                                                                 "counts")}
                print(f"[infer-extras] one 1020-frame chunk, {label}, torch.profiler on: wall "
                      f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms "
                      f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%); device ms by kind "
                      + json.dumps({k: round(v, 3) for k, v in prof["kinds"].items()})
                      + f"; kernels by kind {json.dumps(prof['counts'])} | {smi}", flush=True)

        # fast_edges: the plain zero-padded snake chain, no kernel
        fast = pipeline.build_infer_model(hp, device=dev, seed=0, fast_edges=True)
        fast_cpu = pipeline.build_infer_model(hp, device="cpu", seed=0, fast_edges=True)
        fast_cpu.load_state_dict({k: v.cpu() for k, v in fast.state_dict().items()})
        short = features(hp, 200, seed=2)
        reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        card = pipeline.svc_infer(fast, DummyRetrieval(), *short, hp=hp, out_chunk=200,
                                  device=dev)
        sync(dev)
        out["fast_ms"] = 1e3 * (time.perf_counter() - t0)
        out["fast_counts"] = read_counts()
        cpu = pipeline.svc_infer(fast_cpu, DummyRetrieval(), *short, hp=hp, out_chunk=200,
                                 device="cpu")
        out["fast_err"] = max_err(card, cpu)
        check(sum(out["fast_counts"].values()) == 0,
              f"fast_edges launched snake kernels: {out['fast_counts']}")
        print(f"[infer-extras] fast_edges, 200 frames: {out['fast_ms']:.2f} ms on the card, "
              f"{sum(out['fast_counts'].values())} snake kernel launches; card vs CPU max abs "
              f"err {out['fast_err']:.3e} (tolerance {CARD_VS_CPU_ATOL}) | {smi}", flush=True)
        check(out["fast_err"] <= CARD_VS_CPU_ATOL,
              f"fast_edges card vs CPU max abs err {out['fast_err']:.3e}")
        del fast, fast_cpu

        # every F0 engine on the song; warmed up on a second of it first
        with torch.device("meta"):
            shapes = crepe_mod.Crepe(crepe_capacity)
        crepe_path = str(root / "crepe.pth")
        torch.save(random_state_dict(shapes, 13, dev), crepe_path)
        out["f0"] = {}
        for engine in cli_inference.F0_ENGINES:
            cli_inference.extract_f0(engine, song16[:16000], crepe_path, dev)
            sync(dev)
            t0 = time.perf_counter()
            f0 = cli_inference.extract_f0(engine, song16, crepe_path, dev)
            sync(dev)
            row = dict(ms=1e3 * (time.perf_counter() - t0), frames=len(f0),
                       voiced=float((f0 > 0).mean()))
            if engine not in ("crepe", "dio", "praat"):
                t0 = time.perf_counter()
                f0_cpu = cli_inference.extract_f0(engine, song16, crepe_path,
                                                  torch.device("cpu"))
                row["cpu_ms"] = 1e3 * (time.perf_counter() - t0)
                row |= f0_agreement(f0, f0_cpu)
            where = {"dio": "numpy on the host in both packages",
                     "praat": "numpy on the host in both packages",
                     "crepe": "card; card vs CPU held in [audio-in]"}.get(engine)
            if where is None:
                where = (f"card vs CPU ({row['cpu_ms']:.0f} ms on the CPU): voicing differs on "
                         f"{100 * row['flips']:.3f}% of frames (bound "
                         f"{100 * F0_VOICING_SHARE}%), voiced on both within "
                         f"{row['max_cents']:.4f} cents (p99 {row['p99_cents']:.4f}; bound "
                         f"{F0_CENTS})")
            print(f"[infer-extras] --f0-engine {engine}: {row['ms']:.2f} ms for the song, "
                  f"{row['frames']} frames, {100 * row['voiced']:.1f}% voiced; {where} | {smi}",
                  flush=True)
            if "flips" in row:
                check(row["same_len"] and row["flips"] <= F0_VOICING_SHARE
                      and row["max_cents"] <= F0_CENTS, f"{engine} F0 card vs CPU: {row}")
            out["f0"][engine] = row

        # the silero VAD card against CPU, the post filter's mask on the song
        sd = silero_random(16)
        vads = {d: silero_vad.build_silero_vad(sd, d) for d in (dev, "cpu")}
        probs = {d: silero_vad.silero_speech_probs(m, song16) for d, m in vads.items()}
        out["vad_err"] = max_err(probs[dev], probs["cpu"])
        post_mod.apply_vad_mask(a32, song16, vad_model=vads[dev])
        sync(dev)
        t0 = time.perf_counter()
        masked = post_mod.apply_vad_mask(a32, song16, vad_model=vads[dev])
        sync(dev)
        out["vad_ms"] = 1e3 * (time.perf_counter() - t0)
        print(f"[infer-extras] silero VAD (seeded random weights), {len(probs['cpu'])} windows: "
              f"card vs CPU max abs err {out['vad_err']:.3e} (tolerance {VAD_ATOL}), "
              f"probabilities {probs['cpu'].min():.3f}-{probs['cpu'].max():.3f}; "
              f"apply_vad_mask on the song {out['vad_ms']:.2f} ms, "
              f"{100 * np.mean(masked != 0):.1f}% of samples kept | {smi}", flush=True)
        check(out["vad_err"] <= VAD_ATOL, f"silero probabilities card vs CPU: "
                                          f"{out['vad_err']:.3e}")

        # merge and eva through cli.misc; the merged model through one chunk
        cwd = os.getcwd()
        os.chdir(root)
        try:
            for seed in (1, 2):
                m = pipeline.build_infer_model(hp, device=dev, seed=seed)
                torch.save({"model_g": m.state_dict()}, f"m{seed}.pth")
                np.save(f"s{seed}.npy", features(hp, 1, seed=50 + seed)[0], allow_pickle=False)
            t0 = time.perf_counter()
            cli_misc.main(["merge", "--model1", "m1.pth", "--model2", "m2.pth", "--ratio",
                           str(MERGE_RATIO), "--out", "merged.pth"])
            out["merge_ms"] = 1e3 * (time.perf_counter() - t0)
            cli_misc.main(["eva", "--spk", "s1.npy", "s2.npy", "--weights", "0.5", "0.5",
                           "--out", "eva.npy"])
            merged = pipeline.build_infer_model(hp, device=dev, seed=0)
            pipeline.load_svc_model("merged.pth", merged)
            a, b = (torch.load(f"m{i}.pth", map_location="cpu", weights_only=True)["model_g"]
                    for i in (1, 2))
            for k, v in merged.state_dict().items():
                want = a[k].numpy() * MERGE_RATIO + b[k].numpy() * (1.0 - MERGE_RATIO)
                check(np.array_equal(v.cpu().numpy(), want),
                      f"merged {k} is not the lerp of the two models")
            eva = np.load("eva.npy")
            check(np.array_equal(eva, np.load("s1.npy") * 0.5 + np.load("s2.npy") * 0.5),
                  "eva.npy is not the weighted sum")
        finally:
            os.chdir(cwd)
        reset_counts()
        audio = pipeline.svc_infer(merged, DummyRetrieval(), eva, *one[1:], **run)
        out["merge_counts"] = read_counts()
        out["merge_rms"] = float(np.sqrt(np.mean(np.square(audio))))
        check(audio.shape == (1000 * hop,) and bool(np.isfinite(audio).all())
              and out["merge_rms"] > 1e-3, "the merged model's chunk")
        print(f"[infer-extras] merge (ratio {MERGE_RATIO}) via cli.misc {out['merge_ms']:.2f} ms, "
              f"every parameter the lerp; eva the weighted sum; the merged model through one "
              f"chunk: rms {out['merge_rms']:.4f}, snake launches "
              f"{out['merge_counts']['direct']} | {smi}", flush=True)
        check(out["merge_counts"]["direct"] == n_snakes,
              f"merged model: {out['merge_counts']} launches for one chunk")
        out["phase_s"] = time.perf_counter() - phase_t0
        print(f"[infer-extras] the phase took {out['phase_s']:.1f} s | {smi}", flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def loop_probes(device, poison_at: int | None = None):
    """Wrap the loop's prefetch iterator (the time each step waits for its
    batch; NaN into the ppg of the poison_at-th batch), its checkpoint writes
    and its validations (time, utterances, and the snake launches inside).
    Yields the record."""
    rec = dict(wait_s=[], save_s=[], validate_s=[], validate_utts=0, validate_fwd=0,
               validate_bwd=0, batches=0)
    orig = dict(prefetch=tloop.prefetch, save=tckpt.save, validate=tloop.validate)

    def prefetch(iterable, depth=2):
        it = orig["prefetch"](iterable, depth)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                rec["wait_s"].append(time.perf_counter() - t0)
                rec["batches"] += 1
                if rec["batches"] == poison_at:
                    batch = dict(batch, ppg=np.full_like(batch["ppg"], np.nan))
                yield batch
        finally:
            it.close()  # the producer thread ends with the consumer

    def save(*args, **kwargs):
        sync(device)
        t0 = time.perf_counter()
        orig["save"](*args, **kwargs)
        rec["save_s"].append(time.perf_counter() - t0)

    def validate(hp, g_model, val_ds, writer, step):
        sync(device)
        fwd, bwd, t0 = snake_cuda.launches, snake_cuda.launches_bwd, time.perf_counter()
        mel = orig["validate"](hp, g_model, val_ds, writer, step)
        sync(device)
        rec["validate_s"].append(time.perf_counter() - t0)
        rec["validate_utts"] += len(val_ds)
        rec["validate_fwd"] += snake_cuda.launches - fwd
        rec["validate_bwd"] += snake_cuda.launches_bwd - bwd
        return mel

    tloop.prefetch, tckpt.save, tloop.validate = prefetch, save, validate
    try:
        yield rec
    finally:
        tloop.prefetch, tckpt.save, tloop.validate = (orig["prefetch"], orig["save"],
                                                      orig["validate"])


@contextlib.contextmanager
def plain_snake():
    """The plain PyTorch version in place of the snake kernels, on any device."""
    orig = snake_cuda.snake_alias
    snake_cuda.snake_alias = lambda x, alpha, beta, variant="direct": snake_alias_fused_cm(
        x, alpha, beta)
    try:
        yield
    finally:
        snake_cuda.snake_alias = orig


def validate_vs_plain(hp, g_model, valid_fl: str) -> dict:
    """Validation's first utterance as `validate` feeds it (padded to the
    dataset's longest) through SynthesizerTrn.infer on the card, with the
    snake kernel and with the plain version in its place: same weights, same
    generator seed. Returns the waveforms' max abs difference and the snake
    launches of each run."""
    ds = SvcDataset(valid_fl, hp.data)
    ds.items = ds.items[:1]
    outs, launches = [], []
    infer = g_model.infer

    def capture(*args, **kwargs):
        outs.append(infer(*args, **kwargs))
        return outs[-1]

    g_model.infer = capture
    try:
        for plain in (False, True):
            before = snake_cuda.launches
            with plain_snake() if plain else contextlib.nullcontext():
                tloop.validate(hp, g_model, ds, None, 0)
            launches.append(snake_cuda.launches - before)
    finally:
        del g_model.infer
    return dict(err=(outs[0] - outs[1]).abs().max().item(), launches=launches,
                samples=outs[0].shape[1])


def state_mismatches(a, b) -> list[str]:
    """What differs between two TrainStates: parameters, AdamW state (step,
    moments), learning rate, accumulator, mini_step; bitwise."""
    bad = []
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        if not torch.equal(p, q):
            bad.append(name)
        sa, sb = a.optimizer.state.get(p, {}), b.optimizer.state.get(q, {})
        if sorted(sa) != sorted(sb) or not all(torch.equal(sa[k], sb[k]) for k in sa):
            bad.append(f"{name} (AdamW state)")
    if a.optimizer.param_groups[0]["lr"] != b.optimizer.param_groups[0]["lr"]:
        bad.append("lr")
    if a.mini_step != b.mini_step:
        bad.append("mini_step")
    if a.acc is not None and not all(torch.equal(x, y) for x, y in zip(a.acc, b.acc)):
        bad.append("acc")
    return bad


def kernel_kind(name: str) -> str:
    return next((k for k, keys in KERNEL_KINDS if any(key in name for key in keys)), "other")


def trace_kinds(path: Path) -> dict:
    """Device ms and kernel count by kind, device busy ms (kernels, copies,
    memsets) and the window's span (first event to last end, host and
    device), from a torch.profiler Chrome trace."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kinds = {kind: 0.0 for kind, _ in KERNEL_KINDS} | {"other": 0.0}
    counts = dict.fromkeys(kinds, 0)
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            kind = kernel_kind(e["name"])
            kinds[kind] += e["dur"] / 1e3
            counts[kind] += 1
    span_us = (max(e["ts"] + e.get("dur", 0) for e in events) - min(e["ts"] for e in events)
               if events else 0.0)
    return dict(busy_ms=sum(kinds.values()), span_ms=span_us / 1e3, kinds=kinds, counts=counts)


def loop_records(hp, name: str) -> list[dict]:
    with open(os.path.join(hp.log.log_dir, name, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def train_loop_phase(base_hp, device="cuda", n_snakes: int = 91) -> dict:
    """The training loop through its entry point `train` on a synthetic
    dataset written to a temporary directory: one epoch (validation of
    LOOP_VAL_UTTERANCES utterances, the steps, a checkpoint), a resume from
    that checkpoint for LOOP_RESUME_STEPS more steps (a validation and a
    checkpoint every epoch), and a NaN-poisoned second batch with auto-resume
    off. Checks the counters, finite metrics, n_snakes forward and backward
    snake launches per step and forward per validation utterance, a
    validation utterance through the kernel against the plain version, the
    resumed run's checkpoint against its states to the bit, and
    TrainDivergence with no checkpoint after it."""
    root = Path(tempfile.mkdtemp(prefix="svc_train_loop_"))
    phase_t0 = time.perf_counter()
    try:
        train_fl, valid_fl, data_bytes = write_dataset(base_hp, root / "data", seed=5)
        write_s = time.perf_counter() - phase_t0
        hp = config_from_dict(base_hp)
        hp.data.update(training_files=train_fl, validation_files=valid_fl)
        hp["log"] = config_from_dict(dict(
            info_interval=1, eval_interval=1, save_interval=1, num_audio=LOOP_VAL_UTTERANCES,
            pth_dir=str(root / "chkpt"), log_dir=str(root / "logs"), keep_ckpts=2))
        dataset = SvcDataset(train_fl, hp.data)
        n_batches = BucketBatcher(dataset, hp.train.batch_size, boundaries_for(hp.data),
                                  seed=hp.train.seed).batches_per_epoch()
        check(len(dataset) == sum(LOOP_UTTERANCES) and n_batches == 3,
              f"{len(dataset)} utterances in {n_batches} batches, expected "
              f"{sum(LOOP_UTTERANCES)} in 3")
        check(LOOP_RESUME_STEPS % n_batches == 0,
              f"{LOOP_RESUME_STEPS} resume steps are not whole epochs of {n_batches}")
        # the resume repeats the checkpoint's epoch 1, as the reference does
        resume_epochs = LOOP_RESUME_STEPS // n_batches
        path = os.path.join(hp.log.pth_dir, "loop", "loop_0001.pth")

        runs = {}
        for run in ("epoch", "resume"):
            resume = run == "resume"
            epochs = resume_epochs if resume else 1
            reset_counts()
            if torch.device(device).type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            with loop_probes(device) as rec:
                t0 = time.perf_counter()
                g, d, step = tloop.train(
                    hp, "loop", chkpt_path=path if resume else None, max_epochs=epochs,
                    max_steps=n_batches + LOOP_RESUME_STEPS if resume else None,
                    profile_dir=None if resume else str(root / "profile"), profile_steps=1,
                    device=device)
                sync(device)
                rec["wall_s"] = time.perf_counter() - t0
            counts = read_counts()
            steps = step - (n_batches if resume else 0)
            check(step == (n_batches + LOOP_RESUME_STEPS if resume else n_batches)
                  and steps == rec["batches"], f"{run}: step counter {step} after "
                                               f"{rec['batches']} batches")
            path = os.path.join(hp.log.pth_dir, "loop", f"loop_{epochs:04d}.pth")
            payload = tckpt.load(path)
            check((payload["step"], payload["epoch"]) == (step, epochs),
                  f"{run}: checkpoint at step {payload['step']}, epoch {payload['epoch']}")
            check(len(rec["save_s"]) == epochs
                  and len(os.listdir(os.path.join(hp.log.pth_dir, "loop"))) == min(epochs, 2),
                  f"{run}: {len(rec['save_s'])} saves in {epochs} epochs, checkpoints kept "
                  f"{sorted(os.listdir(os.path.join(hp.log.pth_dir, 'loop')))}")
            train_fwd = counts["direct"] - rec["validate_fwd"]
            check(rec["validate_utts"] == LOOP_VAL_UTTERANCES * epochs
                  and rec["validate_fwd"] == n_snakes * LOOP_VAL_UTTERANCES * epochs
                  and rec["validate_bwd"] == 0,
                  f"{run}: validation of {rec['validate_utts']} utterances launched "
                  f"{rec['validate_fwd']} forward / {rec['validate_bwd']} backward snakes")
            check(train_fwd == n_snakes * steps and counts["bwd"] == n_snakes * steps,
                  f"{run}: {train_fwd} forward / {counts['bwd']} backward snake launches "
                  f"in {steps} loop steps, expected {n_snakes} each per step")
            check(counts["strips"] == counts["mma"] == counts["amp"] == 0,
                  f"{run}: the loop launched an alternative kernel: {counts}")
            rec.update(g=g, d=d, steps=steps, counts=counts, train_fwd=train_fwd,
                       peak_bytes=torch.cuda.max_memory_allocated())
            runs[run] = rec
        records = loop_records(hp, "loop")
        trace = trace_kinds(root / "profile" / "train_steps.json")
        check(trace["counts"]["snake_fwd"] == n_snakes and trace["counts"]["snake_bwd"] == n_snakes,
              f"the loop's profile window (step 3): {trace['counts']['snake_fwd']} forward and "
              f"{trace['counts']['snake_bwd']} backward snake kernels, expected {n_snakes} each")
        train_recs = [r for r in records if "loss_g" in r]
        val_recs = [r for r in records if "validation_mel_loss" in r]
        check([r["step"] for r in train_recs] == list(range(1, n_batches + LOOP_RESUME_STEPS + 1))
              and [r["step"] for r in val_recs]
              == [0] + list(range(n_batches, n_batches + LOOP_RESUME_STEPS, n_batches)),
              f"metrics.jsonl steps {[r['step'] for r in records]}")
        check(all(np.isfinite(v) for r in records for v in r.values()),
              "non-finite values in metrics.jsonl")

        # the resumed run's checkpoint restored into fresh states on the card
        fresh_g, fresh_d = tstep.init_train_states(hp, seed=1, device=device)
        sync(device)
        t0 = time.perf_counter()
        tckpt.restore_states(fresh_g, fresh_d, tckpt.load(path))
        sync(device)
        load_s = time.perf_counter() - t0
        res = runs["resume"]
        bad = state_mismatches(res["g"], fresh_g) + state_mismatches(res["d"], fresh_d)
        check(not bad, f"checkpoint round trip on the card differs at {bad[:5]}")
        check(fresh_g.mini_step == 1 and any(bool(a.any()) for a in fresh_g.acc),
              f"G's checkpoint holds mini_step {fresh_g.mini_step} and an empty accumulator")

        # B1 at validation's shapes, inside the path: the kernel against the
        # plain version on one utterance, the resumed run's weights
        val_cmp = validate_vs_plain(hp, res["g"].model, valid_fl)
        check(val_cmp["launches"] == [n_snakes, 0],
              f"validation kernel / plain runs launched {val_cmp['launches']} snakes")
        check(val_cmp["err"] <= CARD_VS_CPU_ATOL,
              f"validation utterance, snake kernel against the plain version: max abs err "
              f"{val_cmp['err']} (tolerance {CARD_VS_CPU_ATOL})")
        del fresh_g, fresh_d, res["g"], res["d"], runs["epoch"]["g"], runs["epoch"]["d"]

        # the NaN guard: a poisoned second batch, auto-resume off
        nan_hp = config_from_dict(hp)
        nan_hp.log["eval_interval"] = 10**9
        check(not nan_hp.train.get("nan_autoresume", False), "auto-resume is on in the config")
        with loop_probes(device, poison_at=2) as rec:
            try:
                tloop.train(nan_hp, "nan", max_epochs=1, device=device)
                div = None
            except tloop.TrainDivergence as e:
                div = e
        check(div is not None and (div.step, div.last_healthy_step) == (2, 1),
              f"NaN batch: {div!r}")
        left = os.listdir(os.path.join(hp.log.pth_dir, "nan"))
        check(left == [], f"checkpoints written past the divergence: {left}")
        return dict(runs=runs, train_recs=train_recs, val_recs=val_recs, n_batches=n_batches,
                    trace=trace, data_bytes=data_bytes, write_s=write_s, val_cmp=val_cmp,
                    ckpt_bytes=os.path.getsize(path),
                    load_s=load_s, route=native_loader.route(), divergence=str(div),
                    phase_s=time.perf_counter() - phase_t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def spread(xs) -> str:
    return f"median {np.median(xs):.2f} ms ({min(xs):.2f}-{max(xs):.2f}, n {len(xs)})"


def report_train_loop(hp, lp: dict, bare_step_ms: list, smi: str) -> None:
    """The [train-loop] lines, each with the card's name and power limit."""
    ep, rs = lp["runs"]["epoch"], lp["runs"]["resume"]
    step_ms = [1e3 / r["steps_per_s"] for r in lp["train_recs"]]
    # each epoch's first step waits for the first batch of a new prefetch
    # thread; step 3 also writes the profiler's trace
    steady = [ms for r, ms in zip(lp["train_recs"], step_ms)
              if (r["step"] - 1) % lp["n_batches"] and r["step"] != PROFILED_LOOP_STEP]
    waits = [1e3 * w for w in ep["wait_s"] + rs["wait_s"]]
    val_ms = [1e3 * t / LOOP_VAL_UTTERANCES for t in ep["validate_s"] + rs["validate_s"]]

    def fmt(xs):
        return [round(x, 2) for x in xs]

    print(f"[train-loop] dataset: {sum(LOOP_UTTERANCES)} utterances, "
          f"{lp['data_bytes'] / 1e6:.1f} MB written in {lp['write_s']:.2f} s; loader route "
          f"{lp['route']}; {lp['n_batches']} batches of {hp.train.batch_size} an epoch | {smi}",
          flush=True)
    print(f"[train-loop] wall ms per loop step (loader, prefetch, logging inside; the "
          f"writer's 1 / steps_per_s), steps 1-{len(step_ms)}: {fmt(step_ms)}; without each "
          f"epoch's first step and the profiled step: {spread(steady)}; [train]'s bare "
          f"step in this call: {spread(bare_step_ms)} | {smi}", flush=True)
    print(f"[train-loop] writer steps_per_s {fmt(r['steps_per_s'] for r in lp['train_recs'])}, "
          f"audio_seconds_per_s {fmt(r['audio_seconds_per_s'] for r in lp['train_recs'])} "
          f"| {smi}", flush=True)
    print(f"[train-loop] prefetch queue wait ms per step {fmt(waits)}, mean "
          f"{np.mean(waits):.2f} | {smi}", flush=True)
    print(f"[train-loop] checkpoint {lp['ckpt_bytes'] / 1e6:.1f} MB, save ms "
          f"{fmt(1e3 * t for t in ep['save_s'] + rs['save_s'])}, load + restore ms "
          f"{1e3 * lp['load_s']:.2f} | {smi}", flush=True)
    print(f"[train-loop] validation ms per utterance {fmt(val_ms)}; validation mel "
          f"{fmt(r['validation_mel_loss'] for r in lp['val_recs'])} | {smi}", flush=True)
    vc = lp["val_cmp"]
    print(f"[train-loop] validation utterance ({vc['samples']} samples) through the snake "
          f"kernel against the plain version: max abs err {vc['err']:.3e} (tolerance "
          f"{CARD_VS_CPU_ATOL}); snake launches {vc['launches'][0]} / {vc['launches'][1]} | "
          f"{smi}", flush=True)
    tr = lp["trace"]
    print(f"[train-loop] profiled loop step {PROFILED_LOOP_STEP} (train's profile_dir, "
          f"torch.profiler on): window {tr['span_ms']:.2f} ms, device busy "
          f"{tr['busy_ms']:.2f} ms ({100 * tr['busy_ms'] / tr['span_ms']:.1f}%); device ms by kind "
          + json.dumps({k: round(v, 3) for k, v in tr["kinds"].items()})
          + "; kernels by kind " + json.dumps(tr["counts"]) + f" | {smi}", flush=True)
    print(f"[train-loop] peak device memory {ep['peak_bytes'] / 2**30:.2f} GiB (epoch run), "
          f"{rs['peak_bytes'] / 2**30:.2f} GiB (resume run); run walls "
          f"{ep['wall_s']:.2f} / {rs['wall_s']:.2f} s | {smi}", flush=True)
    print(f"[train-loop] launches: epoch run {ep['steps']} steps, snake fwd {ep['train_fwd']} "
          f"bwd {ep['counts']['bwd']}, validation fwd {ep['validate_fwd']} for "
          f"{LOOP_VAL_UTTERANCES} utterances; resume run {rs['steps']} steps, fwd "
          f"{rs['train_fwd']} bwd {rs['counts']['bwd']}, validation fwd {rs['validate_fwd']} "
          f"for {rs['validate_utts']} utterances; "
          f"the resumed run's checkpoint equals its states on the card to the bit "
          f"(parameters, AdamW moments and steps, lr, acc, mini_step); NaN batch: "
          f"{lp['divergence']}; the phase took {lp['phase_s']:.1f} s", flush=True)


# ---------------------------------------------------------------- audio in

# the published extractor widths: whisper large-v2 (the loader keeps 24 of
# its 32 blocks), hubert-soft, CREPE "full", the LSTM speaker encoder
AUDIO_IN_FULL = dict(
    whisper=dict(n_mels=80, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=20,
                 n_audio_layer=32),
    hubert_layers=12, crepe="full", speaker=dict(lstm_dim=768, proj_dim=256, num_layers=3),
    song_seconds=30.5, bank_clips=8, bank_seconds=25.0)
SONG_SR = 44100  # the song is resampled to 16 kHz by the CLI's wave load
VOICE_SECONDS = 4.0  # the speaker clip, and the CREPE clip held card against CPU
# card against CPU, max abs err, each extractor at full width
AUDIO_IN_ATOL = dict(ppg=1e-3, vec=1e-3, crepe_probs=1e-4, dvector=1e-5, retrieval=1e-4)
LOAD_STAGES = ("load_whisper", "load_hubert", "load_crepe", "load_synthesizer", "load_banks")


def synthetic_voice(seconds: float, sr: int, seed: int, f0: float = 220.0) -> np.ndarray:
    """A sung line: notes of 0.5-1.5 s on a scale around f0 with vibrato,
    10 harmonics, breath noise, and short rests between phrases."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    hz = np.empty(n)
    start = 0
    while start < n:
        length = int(rng.uniform(0.5, 1.5) * sr)
        hz[start : start + length] = f0 * 2 ** (rng.choice([0, 2, 4, 5, 7, 9, 12]) / 12)
        start += length
    hz *= 1 + 0.01 * np.sin(2 * np.pi * 5.5 * t)
    phase = 2 * np.pi * np.cumsum(hz) / sr
    voice = sum(np.sin(k * phase) / k for k in range(1, 11))
    voice *= (np.sin(2 * np.pi * t / 3.1) > -0.8)  # rests
    voice = voice / np.abs(voice).max() * 0.5 + 0.003 * rng.standard_normal(n)
    return voice.astype(np.float32)


def random_state_dict(module: torch.nn.Module, seed: int, device,
                      dtype: torch.dtype = torch.float32) -> dict:
    """Seeded random weights in `module`'s state_dict layout (a module on the
    meta device gives the shapes), drawn on `device` and kept on the CPU in
    `dtype`: matrices and convolutions N(0, 1 / fan_in), norm scales
    1 + N(0, 0.01), biases N(0, 4e-4), BatchNorm means N(0, 0.01) and
    variances 0.5 + |N(0, 1)|, weight-norm gains 2."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, t in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64)
            continue
        z = torch.randn(t.shape, generator=g, device=device)
        if k.endswith("running_var"):
            v = z.abs() + 0.5
        elif k.endswith("running_mean"):
            v = 0.1 * z
        elif k.endswith("weight_g"):
            v = torch.full(t.shape, 2.0, device=device)
        elif t.dim() >= 2:
            v = z * t[0].numel() ** -0.5
        elif k.endswith("weight"):
            v = 1.0 + 0.1 * z
        else:
            v = 0.02 * z
        out[k] = v.to(dtype).cpu()
    return out


def state_bytes(sd: dict) -> int:
    return sum(v.numel() * v.element_size() for v in sd.values())


def write_extractor_checkpoints(root: Path, widths: dict, device) -> dict:
    """Seeded random checkpoints in the reference layouts: whisper
    {dims, model_state_dict} with every encoder block in float16 as
    large-v2.pt stores them, a hubert-soft state_dict (with its
    pre-training-only keys), a torchcrepe state_dict, the speaker encoder's
    {"model": state_dict}. Returns paths and the bytes reckoned from the
    shapes."""
    wd, out = widths["whisper"], {}
    with torch.device("meta"):
        enc = whisper_mod.WhisperEncoder(n_mels=wd["n_mels"], n_ctx=wd["n_audio_ctx"],
                                         n_state=wd["n_audio_state"],
                                         n_head=wd["n_audio_head"], n_layer=wd["n_audio_layer"])
        hub = hubert_mod.HubertSoft(n_layers=widths["hubert_layers"])
        cre = crepe_mod.Crepe(widths["crepe"])
        spk = spk_mod.LSTMSpeakerEncoder(**widths["speaker"])
    msd = {f"encoder.{k}": v for k, v in
           random_state_dict(enc, 11, device, torch.float16).items()}
    msd["encoder.positional_embedding"] = torch.from_numpy(
        whisper_mod.sinusoids(wd["n_audio_ctx"], wd["n_audio_state"])).half()
    hsd = random_state_dict(hub, 12, device)
    g = torch.Generator().manual_seed(15)
    hsd["masked_spec_embed"] = torch.rand(768, generator=g)
    hsd["label_embedding.weight"] = torch.randn(100, 256, generator=g)
    payloads = {"whisper": {"dims": dict(wd), "model_state_dict": msd},
                "hubert": hsd, "crepe": random_state_dict(cre, 13, device),
                "speaker": {"model": random_state_dict(spk, 14, device)}}
    for name, payload in payloads.items():
        path = root / f"{name}.pt"
        torch.save(payload, path)
        sd = payload.get("model_state_dict", payload.get("model", payload))
        out[name] = dict(path=str(path), bytes=state_bytes(sd),
                         params=sum(v.numel() for v in sd.values()), file=path.stat().st_size)
    return out


@contextlib.contextmanager
def audio_in_probes(device):
    """Wrap the CLI's stages from outside and time each call (the card
    synchronised after it): the wave load and resample, each checkpoint
    load (the synthesizer's build and load, the retrieval banks' load),
    whisper, HuBERT, CREPE and its Viterbi decode, the retrieval blends and
    synthesis. Yields the record, which also keeps synthesis's float
    waveform."""
    targets = [(audio_io, "load_wav", "load_resample"),
               (whisper_mod, "load_whisper_encoder", "load_whisper"),
               (hubert_mod, "load_hubert_soft", "load_hubert"),
               (crepe_mod, "load_crepe", "load_crepe"),
               (pipeline, "build_infer_model", "load_synthesizer"),
               (pipeline, "load_svc_model", "load_synthesizer"),
               (cli_inference, "create_retrieval", "load_banks"),
               (whisper_mod, "pred_ppg", "whisper"), (hubert_mod, "pred_vec", "hubert"),
               (crepe_mod, "compute_f0_sing", "crepe"), (crepe_mod, "viterbi_decode", "viterbi"),
               (retrieval_mod.ArrayIndexRetrieval, "_blend", "retrieval"),
               (pipeline, "svc_infer", "synthesis")]
    orig = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]
    rec = dict.fromkeys((key for _, _, key in targets), 0.0) | {"audio": None}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(device)
            rec[key] += time.perf_counter() - t0
            if key == "synthesis":
                rec["audio"] = out[0]
            return out
        return wrapper

    for (owner, name, key), (_, _, fn) in zip(targets, orig):
        setattr(owner, name, timed(fn, key))
    try:
        yield rec
    finally:
        for owner, name, fn in orig:
            setattr(owner, name, fn)


def cli_request(workdir: Path, argv: list, device, n_snakes: int, hop: int, sr: int) -> dict:
    """One wave-to-wave request through the port's CLI `main` in a fresh
    working directory, every snake count set to 0 just before it and read
    just after; checks the features it wrote, the waveform (finite, not
    silent, the chunk plan's length at sr) and n_snakes launches per chunk."""
    workdir.mkdir()
    cwd = os.getcwd()
    reset_counts()
    os.chdir(workdir)
    try:
        with audio_in_probes(device) as rec:
            sync(device)
            t0 = time.perf_counter()
            cli_inference.main(argv)
            sync(device)
            rec["wall"] = time.perf_counter() - t0
        counts = read_counts()
        ppg, vec = np.load("svc_tmp.ppg.npy"), np.load("svc_tmp.vec.npy")
        pit = pipeline.load_csv_pitch("svc_tmp.pit.csv")
        wav_sr, wav = wavfile.read("svc_out.wav")
    finally:
        os.chdir(cwd)
    len_min = min(len(pit), 2 * len(ppg), 2 * len(vec))
    chunks = len(pipeline._chunk_plan(len_min, 1000, 10))
    audio = rec["audio"]
    rms = float(np.sqrt(np.mean(np.square(wav / 32768.0))))
    check(wav_sr == sr and wav.shape == audio.shape == (len_min * hop,),
          f"svc_out.wav: {wav.shape} at {wav_sr} Hz, expected {len_min * hop} at {sr}")
    check(bool(np.isfinite(audio).all()), "non-finite samples in the CLI's waveform")
    check(rms > 1e-3, f"silent CLI output (rms {rms})")
    check(counts["direct"] == n_snakes * chunks and counts["bwd"] == counts["strips"]
          == counts["mma"] == counts["amp"] == 0,
          f"{counts} launches for {chunks} chunks, expected {n_snakes} direct per chunk")
    return rec | dict(counts=counts, chunks=chunks, frames=len_min, rms=rms, wav=wav,
                      ppg_frames=len(ppg), vec_frames=len(vec), pit_frames=len(pit))


def max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def audio_in_phase(base_hp, widths: dict = AUDIO_IN_FULL, device="cuda",
                   n_snakes: int = 91) -> dict:
    """Audio in, through the port's CLI: seeded random extractor checkpoints
    at `widths` in the reference layouts, a speaker vector from the port's
    compute_embedding on one synthetic voice, a synthetic song at 44.1 kHz,
    then `main` from the wave alone (every feature extracted) in a fresh
    directory; retrieval banks written by the port's build_index from the
    extractors' features of a synthetic corpus; `main` again with
    --enable-retrieval. Then each extractor and the blend on the card
    against the CPU, the Viterbi path decoded on both sides from the card's
    probabilities, and a profile of one extraction."""
    root = Path(tempfile.mkdtemp(prefix="svc_audio_in_"))
    phase_t0 = time.perf_counter()
    try:
        t0 = time.perf_counter()
        ckpts = write_extractor_checkpoints(root, widths, device)
        hp = config_from_dict(base_hp)
        model = pipeline.build_infer_model(hp, device=device, seed=0)
        torch.save({"model_g": model.state_dict()}, root / "model.pth")
        del model
        (root / "config.json").write_text(json.dumps(base_hp))
        write_s = time.perf_counter() - t0

        voice = synthetic_voice(VOICE_SECONDS, 16000, seed=21, f0=180.0)
        spk_card = spk_mod.load_speaker_encoder(ckpts["speaker"]["path"], device)
        spk_cpu = spk_mod.load_speaker_encoder(ckpts["speaker"]["path"], "cpu")
        dvec = spk_mod.compute_embedding(spk_card, voice)
        dvec_err = max_err(dvec, spk_mod.compute_embedding(spk_cpu, voice))
        np.save(root / "singer.spk.npy", dvec, allow_pickle=False)
        song = synthetic_voice(widths["song_seconds"], SONG_SR, seed=22)
        save_wav(str(root / "song.wav"), song, SONG_SR)

        argv = ["--config", str(root / "config.json"), "--model", str(root / "model.pth"),
                "--spk", str(root / "singer.spk.npy"), "--wave", str(root / "song.wav"),
                "--whisper-ckpt", ckpts["whisper"]["path"],
                "--hubert-ckpt", ckpts["hubert"]["path"],
                "--crepe-ckpt", ckpts["crepe"]["path"], "--device", str(device)]
        out = dict(hop=hp.data.hop_length, sr=hp.data.sampling_rate)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        plain = cli_request(root / "request", argv, device, n_snakes, **out)
        peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0

        # the banks: the extractors' features of a synthetic corpus of the singer
        models = dict(whisper=whisper_mod.load_whisper_encoder(ckpts["whisper"]["path"], device),
                      hubert=hubert_mod.load_hubert_soft(ckpts["hubert"]["path"], device),
                      crepe=crepe_mod.load_crepe(ckpts["crepe"]["path"], device=device))
        t0 = time.perf_counter()
        files = dict(whisper=[], hubert=[])
        for i in range(widths["bank_clips"]):
            clip = synthetic_voice(widths["bank_seconds"], 16000, seed=30 + i, f0=180.0)
            for name, feats in (("whisper", whisper_mod.pred_ppg(models["whisper"], clip)),
                                ("hubert", hubert_mod.pred_vec(models["hubert"], clip))):
                files[name].append(str(root / f"clip{i}.{name}.npy"))
                np.save(files[name][-1], feats, allow_pickle=False)
        banks = {name: retrieval_mod.build_index(f, str(root / f"singer_{name}.npz"))
                 for name, f in files.items()}
        bank_s = time.perf_counter() - t0
        blended = cli_request(root / "request_retrieval",
                              argv + ["--enable-retrieval", "--retrieval-index-prefix",
                                      str(root / "singer_")], device, n_snakes, **out)
        check(blended["wav"].shape == plain["wav"].shape
              and np.abs(blended["wav"].astype(np.int32) - plain["wav"]).max() > 0,
              "--enable-retrieval left the waveform as it was")

        # the features' frame counts: whisper's windows cut to len // 320
        # frames, HuBERT's to its conv arithmetic, CREPE at hop 320 repeated x2
        song16 = audio_io.resample(song, SONG_SR, 16000)
        n16, win16 = len(song16), 20 * 16000
        want = dict(ppg_frames=n16 // whisper_mod.PPG_HOP,  # 15 s windows are whole frames
                    vec_frames=sum(hubert_mod.hubert_num_frames(min(win16, n16 - s0))
                                   for s0 in range(0, n16, win16)),
                    pit_frames=2 * (1 + n16 // 320))
        for r in (plain, blended):
            check(all(r[k] == v for k, v in want.items()),
                  f"feature frames { {k: r[k] for k in want} }, expected {want}")

        # each extractor on the card against the CPU, at full width
        errs = dict(dvector=dvec_err)
        win = np.zeros((1, whisper_mod.WINDOW_SAMPLES), np.float32)
        win[0] = song16[: whisper_mod.WINDOW_SAMPLES]
        lens = np.array([whisper_mod.WINDOW_SAMPLES])
        cpu = whisper_mod.load_whisper_encoder(ckpts["whisper"]["path"], "cpu")
        errs["ppg"] = max_err(whisper_mod.ppg_window_batch(models["whisper"], win, lens),
                              whisper_mod.ppg_window_batch(cpu, win, lens))
        vwin = np.zeros((1, 20 * 16000), np.float32)
        vwin[0, : min(len(song16), vwin.shape[1])] = song16[: vwin.shape[1]]
        vlens = np.array([min(len(song16), vwin.shape[1])])
        cpu = hubert_mod.load_hubert_soft(ckpts["hubert"]["path"], "cpu")
        errs["vec"] = max_err(hubert_mod.vec_window_batch(models["hubert"], vwin, vlens),
                              hubert_mod.vec_window_batch(cpu, vwin, vlens))
        frames = crepe_mod.frame_audio(song16[: int(VOICE_SECONDS * 16000)], 320)
        cpu = crepe_mod.load_crepe(ckpts["crepe"]["path"], device="cpu")
        errs["crepe_probs"] = max_err(
            crepe_mod.crepe_probabilities(models["crepe"], frames, batch_size=len(frames)),
            crepe_mod.crepe_probabilities(cpu, frames, batch_size=len(frames)))
        del cpu
        ret = {d: retrieval_mod.ArrayIndexRetrieval(banks["whisper"], banks["hubert"], 0.5, 3,
                                                    device=d) for d in (device, "cpu")}
        ppg_req = np.repeat(np.load(root / "request" / "svc_tmp.ppg.npy"), 2, 0)[:CHUNK_FRAMES]
        vec_req = np.repeat(np.load(root / "request" / "svc_tmp.vec.npy"), 2, 0)[:CHUNK_FRAMES]
        errs["retrieval"] = max(
            max_err(ret[device].retriv_whisper(ppg_req), ret["cpu"].retriv_whisper(ppg_req)),
            max_err(ret[device].retriv_hubert(vec_req), ret["cpu"].retriv_hubert(vec_req)))
        for key, tol in AUDIO_IN_ATOL.items():
            check(errs[key] <= tol, f"audio in, card vs CPU: {key} max abs err {errs[key]:.3e} "
                                    f"above {tol}")

        # the Viterbi path from the card's probabilities of the whole song,
        # decoded on the card and on the CPU
        probs = crepe_mod.crepe_probabilities(models["crepe"], crepe_mod.frame_audio(song16, 320))
        obs = crepe_mod.viterbi_observations(probs)
        paths, vit_ms = {}, {}
        for d in (device, "cpu"):
            sync(device)
            t0 = time.perf_counter()
            paths[d] = crepe_mod.viterbi_decode(obs, device=d)
            vit_ms[d] = 1e3 * (time.perf_counter() - t0)
        check(np.array_equal(paths[device], paths["cpu"]),
              f"Viterbi paths differ between {device} and the CPU at "
              f"{np.flatnonzero(paths[device] != paths['cpu'])[:10]}")

        prof = None
        if torch.device(device).type == "cuda":
            prof = profile(lambda: (
                whisper_mod.pred_ppg(models["whisper"], song16,
                                     rng=torch.Generator().manual_seed(0)),
                hubert_mod.pred_vec(models["hubert"], song16),
                crepe_mod.compute_f0_sing(models["crepe"], song16, np.random.default_rng(0))))
        del models
        return dict(ckpts=ckpts, write_s=write_s, plain=plain, blended=blended, peak=peak,
                    bank_rows={k: len(v) for k, v in banks.items()}, bank_s=bank_s,
                    errs=errs, viterbi_frames=len(obs), viterbi_ms=vit_ms, prof=prof,
                    song_s=len(song) / SONG_SR, song_samples=len(song),
                    phase_s=time.perf_counter() - phase_t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def report_audio_in(ai: dict, smi: str) -> None:
    """The [audio-in] lines, each with the card's name and power limit."""
    ck = ai["ckpts"]
    print("[audio-in] checkpoints (seeded random, reference layouts; bytes reckoned from "
          "the shapes, file bytes beside): " + "; ".join(
              f"{k} {v['params'] / 1e6:.2f} M params, {v['bytes'] / 1e9:.3f} GB "
              f"(file {v['file'] / 1e9:.3f} GB)" for k, v in ck.items())
          + f"; written with the synthesizer's .pth in {ai['write_s']:.2f} s | {smi}", flush=True)
    for label, r in (("request", ai["plain"]), ("request+retrieval", ai["blended"])):
        loads = {k: r[k] for k in LOAD_STAGES}
        stages = loads | dict(
            load_resample=r["load_resample"], whisper=r["whisper"], hubert=r["hubert"],
            crepe_without_viterbi=r["crepe"] - r["viterbi"], viterbi=r["viterbi"],
            retrieval=r["retrieval"], synthesis=r["synthesis"] - r["retrieval"])
        stages["other"] = r["wall"] - sum(stages.values())
        compute = r["wall"] - sum(loads.values())
        print(f"[audio-in] {label}: {ai['song_s']:.2f} s song at {SONG_SR} Hz -> "
              f"{r['frames']} frames, {r['chunks']} chunks, {r['wav'].shape[0]} samples (rms "
              f"{r['rms']:.4f}); CLI main wall {1e3 * r['wall']:.2f} ms, realtime "
              f"x{ai['song_s'] / r['wall']:.2f} wave to wave (x{ai['song_s'] / compute:.2f} "
              f"without the checkpoint loads); ms by stage "
              + json.dumps({k: round(1e3 * v, 2) for k, v in stages.items()})
              + f"; features ppg {r['ppg_frames']} vec {r['vec_frames']} pit {r['pit_frames']} "
              f"frames; snake launches {r['counts']['direct']} "
              f"({r['counts']['direct'] // r['chunks']} per chunk) | {smi}", flush=True)
    print(f"[audio-in] peak device memory over the first request {ai['peak'] / 2**30:.2f} GiB; "
          f"banks {ai['bank_rows']} rows written in {ai['bank_s']:.2f} s | {smi}", flush=True)
    print("[audio-in] card vs CPU max abs err (tolerance): " + ", ".join(
        f"{k} {v:.3e} ({AUDIO_IN_ATOL[k]})" for k, v in ai["errs"].items())
          + f"; Viterbi over {ai['viterbi_frames']} frames from the card's probabilities: "
          f"the card's path equals the CPU's; trellis + backtrace ms "
          + json.dumps({str(k): round(v, 2) for k, v in ai["viterbi_ms"].items()})
          + f" | {smi}", flush=True)
    prof = ai["prof"]
    if prof is not None:
        print(prof["table"], flush=True)
        print(f"[audio-in] profiled extraction (whisper, HuBERT, CREPE with its Viterbi; "
              f"torch.profiler on): wall {prof['wall_ms']:.2f} ms, device busy "
              f"{prof['busy_ms']:.2f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%); "
              f"device ms by kind " + json.dumps({k: round(v, 3) for k, v in prof["kinds"].items()})
              + f" | {smi}", flush=True)
    print(f"[audio-in] the phase took {ai['phase_s']:.1f} s | {smi}", flush=True)


# streaming: 100-frame blocks (1 s) after 50 frames (0.5 s) of context
STREAM_BLOCK, STREAM_CONTEXT = 100, 50
STREAM_BLOCKS = 30
STREAM_CPU_BLOCKS = 4          # blocks held card against CPU
STREAM_WINDOW_BLOCKS = (1, 2, 3)  # blocks held to one forward on their window
STREAM_AUDIO_SECONDS = 10.0
STREAM_AUDIO_BLOCK = 16000     # 1 s of 16 kHz audio a push
STREAM_LAG = 4
# JAX's snake sends T that is no multiple of its 128-lane tile to
# _kernel_padded (ops/pallas_snake.py:217, :708): 750, 3000, 12000 and 24000
# of the streaming window's stages
PADDED_REPLACES = "whisper_vits_svc_tpu/ops/pallas_snake.py:708"


def _percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def stream_phase(base_hp, device="cuda", n_snakes: int = 91,
                 blocks: int = STREAM_BLOCKS) -> dict:
    """StreamingSvc at hp's width on seeded features, noise_scale=0: two
    warm-up blocks (the first captures the forward's CUDA graph), then
    `blocks` blocks with every count set to 0 before them and read after
    (a graph replay a block; n_snakes launches a block, counted as the
    capture's launches once a replay, split by tile_key the same way; no
    other kernel), the wall of each push; one more block profiled, its
    n_snakes snake kernels counted on the device; the first STREAM_CPU_BLOCKS
    blocks on the CPU with the same weights; STREAM_WINDOW_BLOCKS held to
    one SynthesizerInfer forward on their [context | block] window with the
    whole utterance's excitation sliced at it."""
    hp = config_from_dict(base_hp)
    hop, sr = hp.data.hop_length, hp.data.sampling_rate
    model = pipeline.build_infer_model(hp, device=device, seed=0)
    spk, pit, ppg, vec = features(hp, blocks * STREAM_BLOCK, seed=40)

    def run(m, dev, n_blocks):
        svc = StreamingSvc(m, spk, hp, STREAM_BLOCK, STREAM_CONTEXT, noise_scale=0.0,
                           device=dev)
        outs, walls = [], []
        for k in range(n_blocks):
            sl = slice(k * STREAM_BLOCK, (k + 1) * STREAM_BLOCK)
            sync(dev)
            t0 = time.perf_counter()
            outs.append(svc.push(ppg[sl], vec[sl], pit[sl]))
            sync(dev)
            walls.append(time.perf_counter() - t0)
        return outs, walls, svc

    on_card = torch.device(device).type == "cuda"
    with captured_snakes(tile_key) as captured:
        run(model, device, 2)
    check(len(captured) == int(on_card), f"stream: {len(captured)} graph captures on {device}")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    replays0, eager0 = stream_mod.graph_replays, stream_mod.eager_forwards
    with snake_dtypes(key=tile_key) as by_tile:  # the forwards run op by op
        outs, walls, svc = run(model, device, blocks)
    counts = read_counts()
    replays = stream_mod.graph_replays - replays0
    for key, n in (captured[0] if captured else {}).items():
        by_tile[key] = by_tile.get(key, 0) + n * replays
    check(counts["direct"] == sum(by_tile.values()) == n_snakes * blocks
          and counts["bwd"] == counts["strips"] == counts["mma"] == counts["amp"] == 0,
          f"stream: {counts} launches ({dict(by_tile)} by tile) in {blocks} blocks, expected "
          f"{n_snakes} direct a block")
    want = blocks if on_card else 0
    check(replays == want and stream_mod.eager_forwards - eager0 == blocks - want,
          f"stream: {replays} graph replays and {stream_mod.eager_forwards - eager0} eager "
          f"forwards in {blocks} blocks on {device}, expected a replay a block on the card")
    audio = np.concatenate(outs)
    rms = float(np.sqrt(np.mean(np.square(audio))))
    check(audio.shape == (blocks * STREAM_BLOCK * hop,) and bool(np.isfinite(audio).all())
          and rms > 1e-3, f"stream output {audio.shape}, rms {rms}")
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    prof = None
    if on_card:
        sl = slice(0, STREAM_BLOCK)
        replays0 = stream_mod.graph_replays
        prof = profile(lambda: svc.push(ppg[sl], vec[sl], pit[sl]))
        check(stream_mod.graph_replays - replays0 == 1
              and prof["counts"]["snake_fwd"] == n_snakes,
              f"stream: the profiled push ran {prof['counts']['snake_fwd']} snake kernels in "
              f"{stream_mod.graph_replays - replays0} replays, expected {n_snakes} in one")

    # the tight check: block k against one forward on its window, with the
    # whole utterance's excitation (its cumulative phase stays below ~400
    # cycles over these blocks, where float32 keeps it within 5e-5)
    whole = source_hn_nsf(torch.from_numpy(pit)[None].to(device), hop, sr)
    window_err = 0.0
    for k in STREAM_WINDOW_BLOCKS:
        s0, e0 = k * STREAM_BLOCK - STREAM_CONTEXT, (k + 1) * STREAM_BLOCK
        with torch.inference_mode():
            out = model(*(torch.from_numpy(a[s0:e0])[None].to(device) for a in (ppg, vec, pit)),
                        torch.from_numpy(spk)[None].to(device), torch.tensor([e0 - s0],
                                                                             device=device),
                        whole[:, s0 * hop : e0 * hop], 0.0)
        window_err = max(window_err, max_err(outs[k], out[0, STREAM_CONTEXT * hop :, 0].cpu()))
    check(window_err <= CARD_VS_CPU_ATOL,
          f"stream block against its window's forward: max abs err {window_err}")

    cpu_model = pipeline.build_infer_model(hp, device="cpu", seed=0)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_outs, cpu_walls, _ = run(cpu_model, "cpu", STREAM_CPU_BLOCKS)
    cpu_err = max(max_err(a, b) for a, b in zip(outs, cpu_outs))
    check(cpu_err <= CARD_VS_CPU_ATOL, f"stream card vs CPU: max abs err {cpu_err}")
    block_s = STREAM_BLOCK * hop / sr
    return dict(walls=walls, prof=prof, counts=counts, blocks=blocks, block_s=block_s,
                window_err=window_err, cpu_err=cpu_err, cpu_walls=cpu_walls, peak=peak,
                rms=rms, by_tile=dict(by_tile))


TRELLIS_FRAMES = (1, 50, 64, 2000)  # frame counts of the kernel-vs-plain checks
TRELLIS_PUSH = 50                   # the frames a 1 s push advances
TRELLIS_LEVELS = 9                  # ceil(log2 360): a first-index maximum's depth
TRELLIS_CHAIN = 10_000              # dependent steps in each latency chain
# latency chains for the trellis's floor (a copy kept out of git, built at run time)
TRELLIS_PROBE = Path(__file__).resolve().parent / "build" / "latency_probe" / "trellis_latency.cu"
TRELLIS_PROBE_SOURCE = r"""// Latencies behind the floor of the Viterbi trellis
// (csrc/viterbi_trellis.cu), each in one block of 384 threads, the kernel's
// 12 warps: which = 0, an empty kernel (the launch); 1, `count` dependent
// shuffle levels of a first-index maximum over (value, index) pairs, as the
// kernel's scans make them; 2, `count` dependent exchanges across the warps:
// a store to shared memory, a barrier, a load of another warp's cell.
#include <cuda_runtime.h>

namespace {

struct Best {
  float v;
  int i;
};

__device__ __forceinline__ Best pick(Best lo, Best hi) { return hi.v > lo.v ? hi : lo; }

__global__ void empty_kernel() {}

__global__ void shuffle_chain(float* out, int count) {
  const int lane = threadIdx.x & 31;
  Best p{static_cast<float>(threadIdx.x * 37 % 101), static_cast<int>(threadIdx.x)};
  for (int l = 0; l < count; l += 5) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Best up{__shfl_up_sync(0xffffffffu, p.v, d), __shfl_up_sync(0xffffffffu, p.i, d)};
      if (lane >= d) p = pick(up, p);
    }
  }
  out[threadIdx.x] = p.v + static_cast<float>(p.i);
}

__global__ void exchange_chain(float* out, int count) {
  __shared__ float cell[2][384];
  const int j = threadIdx.x;
  float v = static_cast<float>(j);
  for (int r = 0; r < count; ++r) {
    cell[r & 1][j] = v;
    __syncthreads();
    v = cell[r & 1][(j + 32) % 384];
  }
  out[j] = v;
}

}  // namespace

extern "C" int trellis_latency_probe(int which, int count, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (which == 0) empty_kernel<<<1, 384, 0, s>>>();
  else if (which == 1) shuffle_chain<<<1, 384, 0, s>>>(static_cast<float*>(out), count);
  else exchange_chain<<<1, 384, 0, s>>>(static_cast<float*>(out), count);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trellis_latency_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def trellis_latencies() -> dict:
    """The latencies of the trellis's floor on this card, CUDA events over
    the chains of TRELLIS_PROBE_SOURCE: the launch (an empty kernel, timed
    as the kernel is), a shuffle level and an exchange across the warps
    (each chain's time less the launch, over its steps), in ms."""
    TRELLIS_PROBE.parent.mkdir(parents=True, exist_ok=True)
    TRELLIS_PROBE.write_text(TRELLIS_PROBE_SOURCE)
    lib = cuda_build.load_library(TRELLIS_PROBE, "trellis_latency_probe",
                                  [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
                                  "trellis_latency_error_string")
    out = torch.empty(384, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(which, count=0):
        err = lib.trellis_latency_probe(which, count, out.data_ptr(), stream)
        check(err == 0, f"trellis latency probe {which}: "
                        f"{lib.trellis_latency_error_string(err).decode()}")

    launch_ms = cuda_ms(lambda i=0: launch(0), 200)
    level_ms = (cuda_ms(lambda i=0: launch(1, TRELLIS_CHAIN), 10) - launch_ms) / TRELLIS_CHAIN
    exchange_ms = (cuda_ms(lambda i=0: launch(2, TRELLIS_CHAIN), 10) - launch_ms) / TRELLIS_CHAIN
    return dict(launch_ms=launch_ms, level_ms=level_ms, exchange_ms=exchange_ms)


def trellis_bound_ms(steps: int, lat: dict) -> float:
    """The trellis's floor over `steps` dependent frames: the launch, then
    a frame's first-index maximum over 360 scores (TRELLIS_LEVELS shuffle
    levels) and one exchange of the values across the warps, each at this
    card's latency (`trellis_latencies`); or its bytes (the observations,
    pointers, band and value) at HBM's rate, where larger."""
    frame_ms = TRELLIS_LEVELS * lat["level_ms"] + lat["exchange_ms"]
    n_bytes = steps * viterbi_cuda.BINS * (4 + 2) + 33_120 + 2 * 1_440
    return max(lat["launch_ms"] + steps * frame_ms, 1e3 * n_bytes / HBM_BYTES_PER_S)


def trellis_observations(n: int, seed: int, ties: bool) -> np.ndarray:
    """[n, 360] log observations as the decode makes them (bins outside
    [50 Hz, 1 kHz] masked, a softmax, a log); `ties`: probabilities on a
    grid of quarters and every third row the first, so that scores tie."""
    rng = np.random.default_rng(seed)
    probs = (rng.integers(0, 4, (n, 360)) / 4 if ties else rng.random((n, 360)) ** 8)
    probs = probs.astype(np.float32)
    if ties:
        probs[::3] = probs[0]
    return np.log(np.maximum(crepe_mod.viterbi_observations(probs), 1e-30)).astype(np.float32)


def host_ms(fn, iters: int) -> float:
    """Median host ms of `fn()` after one warm call, the card synchronised
    after each call."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(walls))


def trellis_phase(device="cuda") -> dict:
    """The trellis kernel against its plain version (on the card and on the
    CPU) at TRELLIS_FRAMES: the largest |value difference| and the pointer
    rows that differ, over every case; the times of a push's 50 frames by
    route, and the floor from this card's latencies."""
    dev, cpu = torch.device(device), torch.device("cpu")
    trans = crepe_mod.banded_transition()
    cases, value_err, value_bins, ptr_rows = 0, 0.0, 0, 0
    for n in TRELLIS_FRAMES:
        for ties in (False, True):
            obs = trellis_observations(n, seed=900 + n + ties, ties=ties)
            rng = np.random.default_rng(n)
            starts = {"first": None,
                      "carried": (obs[0] + viterbi_cuda.INIT
                                  + rng.standard_normal(360)).astype(np.float32),
                      "large": (-8000.0 + rng.standard_normal(360) * 0.01).astype(np.float32)}
            for start, value0 in starts.items():
                args = {d: (torch.from_numpy(obs).to(d),
                            None if value0 is None else torch.from_numpy(value0).to(d))
                        for d in (dev, cpu)}
                launches = viterbi_cuda.launches_trellis
                value, ptrs = (a.cpu().numpy() for a in viterbi_cuda.viterbi_trellis(*args[dev],
                                                                                     trans))
                check(viterbi_cuda.launches_trellis == launches + 1,
                      "the trellis on the card ran no kernel launch, or more than one")
                for where in (dev, cpu):
                    want_value, want_ptrs = (a.cpu().numpy() for a in
                                             viterbi_cuda.viterbi_trellis_plain(*args[where],
                                                                                trans))
                    check(ptrs.shape == want_ptrs.shape,
                          f"trellis kernel vs plain: pointers {ptrs.shape}, {want_ptrs.shape}")
                    # bins whose bits differ (-inf against -inf does not), and by how much
                    diff = value.view(np.int32) != want_value.view(np.int32)
                    err = np.nan_to_num(np.abs(value[diff] - want_value[diff]), nan=np.inf)
                    value_bins += int(diff.sum())
                    value_err = max(value_err, float(np.max(err, initial=0.0)))
                    ptr_rows += int((ptrs != want_ptrs).any(axis=1).sum())
                cases += 1
    check(value_bins == 0 and ptr_rows == 0,
          f"trellis kernel vs plain: {value_bins} value bins differ, by up to {value_err}; "
          f"{ptr_rows} pointer rows differ")

    # a push: 50 frames from the value after 100
    obs = trellis_observations(100 + TRELLIS_PUSH, seed=950, ties=False)
    prev, _ = viterbi_cuda.viterbi_trellis_plain(torch.from_numpy(obs[:100]), None, trans)
    push = obs[100:]
    push_dev, prev_dev = torch.from_numpy(push).to(dev), prev.to(dev)
    long_dev = torch.from_numpy(trellis_observations(2000, seed=951, ties=False)).to(dev)
    kernel_ms = cuda_ms(lambda i=0: viterbi_cuda.viterbi_trellis_cuda(push_dev, prev_dev, trans),
                        200)
    kernel_2000_ms = cuda_ms(lambda i=0: viterbi_cuda.viterbi_trellis_cuda(long_dev, None, trans),
                             20)

    sc = stream_extract.StreamingCrepe(crepe_mod.Crepe("tiny").eval().to(dev), device=dev)

    def card_push():  # StreamingCrepe._step: obs up, the launch, the pointers and argmax back
        sc.head, sc.value, sc.ptrs = 100, prev_dev, {}
        sc._step(push)

    lat = trellis_latencies()
    return dict(
        cases=cases, value_err=value_err, value_bins=value_bins, ptr_rows=ptr_rows, lat=lat,
        kernel_ms=kernel_ms, kernel_2000_ms=kernel_2000_ms,
        bound_ms=trellis_bound_ms(TRELLIS_PUSH, lat), bound_2000_ms=trellis_bound_ms(1999, lat),
        card_push_ms=host_ms(card_push, 100),
        plain_card_ms=host_ms(lambda: viterbi_cuda.viterbi_trellis_plain(push_dev, prev_dev,
                                                                         trans), 20),
        plain_cpu_ms=host_ms(lambda: viterbi_cuda.viterbi_trellis_plain(
            torch.from_numpy(push), prev, trans), 10))


def report_trellis(tr: dict, smi: str) -> None:
    lat = tr["lat"]
    print(f"[trellis] kernel against its plain version (card and CPU) in {tr['cases']} cases: "
          f"{', '.join(map(str, TRELLIS_FRAMES))} frames, masked bins with and without planted "
          f"ties, from the first frame, a carried value and a large one: {tr['value_bins']} "
          f"value bins differ in their bits (largest |difference| {tr['value_err']}), "
          f"{tr['ptr_rows']} pointer rows differ; one launch a call | {smi}", flush=True)
    print(f"[trellis] latencies (one block of 12 warps): launch {1e3 * lat['launch_ms']:.2f} us, "
          f"shuffle level {1e6 * lat['level_ms']:.1f} ns, exchange across the warps "
          f"{1e6 * lat['exchange_ms']:.1f} ns; floor a frame {TRELLIS_LEVELS} levels + 1 "
          f"exchange = {1e6 * (TRELLIS_LEVELS * lat['level_ms'] + lat['exchange_ms']):.1f} ns "
          f"| {smi}", flush=True)
    print(f"[trellis] a push's {TRELLIS_PUSH} frames: kernel {1e3 * tr['kernel_ms']:.1f} us "
          f"(CUDA events, {1e3 * tr['kernel_ms'] / TRELLIS_PUSH:.3f} us a frame; bound "
          f"{1e3 * tr['bound_ms']:.1f} us, {100 * tr['bound_ms'] / tr['kernel_ms']:.0f}% "
          f"reached); the stream's card path (upload, launch, pointers and value back) "
          f"{tr['card_push_ms']:.3f} ms; plain version on the "
          f"card {tr['plain_card_ms']:.2f} ms, on the CPU {tr['plain_cpu_ms']:.2f} ms; kernel "
          f"at 2000 frames {tr['kernel_2000_ms']:.3f} ms "
          f"({1e3 * tr['kernel_2000_ms'] / 2000:.3f} us a frame; bound "
          f"{tr['bound_2000_ms']:.3f} ms, {100 * tr['bound_2000_ms'] / tr['kernel_2000_ms']:.0f}% "
          f"reached) | {smi}", flush=True)


def crepe_conv_phase(device="cuda") -> dict:
    """The CREPE convolution kernel against its plain version on the card:
    the forward's probabilities at CREPE_CONV_ROWS rows of both capacities
    (seeded weights, BatchNorm statistics away from their defaults), six
    launches a forward, two calls bitwise equal; then the per-layer lines
    of "full" at 64 and 512 rows (`crepe_conv_probe.layer_lines`)."""
    dev = torch.device(device)
    cases, prob_err = 0, 0.0
    for capacity in ("full", "tiny"):
        torch.manual_seed(7)
        model = crepe_mod.Crepe(capacity).eval().to(dev)
        with torch.no_grad():
            for i in range(1, 7):
                bn = getattr(model, f"conv{i}_BN")
                bn.running_mean.uniform_(-0.2, 0.2)
                bn.running_var.uniform_(0.5, 1.5)
        for rows in CREPE_CONV_ROWS:
            voice = synthetic_voice(rows * 0.01 + 0.2, 16000, seed=rows)
            frames = crepe_mod.normalize_frames(torch.from_numpy(
                crepe_mod.frame_audio(voice, 160)[:rows]).to(dev))
            with torch.inference_mode():
                launches = crepe_conv_cuda.launches_crepe_conv
                got, again = model(frames), model(frames)
                sync(device)
                check(crepe_conv_cuda.launches_crepe_conv == launches + 12,
                      f"crepe_conv: {crepe_conv_cuda.launches_crepe_conv - launches} launches "
                      f"in two forwards of {capacity} at {rows} rows, expected 12")
                check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                      f"crepe_conv: two forwards of {capacity} at {rows} rows differ")
                want = crepe_conv_probe.forward(model, frames, "conv1d")
            prob_err = max(prob_err, float((got - want).abs().max()))
            cases += 1
    check(prob_err <= 1e-6, f"crepe_conv: probabilities differ from the plain version by "
                            f"{prob_err:.3e}, above 1e-6")
    torch.manual_seed(0)
    model = crepe_mod.Crepe("full").eval().to(dev)
    voice = synthetic_voice(6.0, 16000, seed=3)
    # the stream's call (64 rows through crepe_probabilities) runs the
    # kernel and no cuDNN convolution
    ran = crepe_conv_probe.device_kernels(lambda: crepe_mod.crepe_probabilities(
        model, crepe_mod.frame_audio(voice, 320)[:50], batch_size=64))
    cudnn = [k for k in ran if any(w in k for w in ("convolve", "fprop", "cudnn", "conv2d"))]
    check(any("crepe_conv_kernel" in k for k in ran) and not cudnn,
          f"crepe_conv: a 64-row batch ran {sorted(ran)}")
    lines = {}
    for rows in (64, 512):
        frames = crepe_mod.normalize_frames(torch.from_numpy(
            crepe_mod.frame_audio(voice, 160)[:rows]).to(dev))
        with torch.inference_mode():
            lines[rows] = crepe_conv_probe.layer_lines(model, frames[:, None, :])
    return dict(cases=cases, prob_err=prob_err, lines=lines, ran=ran,
                **{f"{key}_{rows}": sum(ln[key] for ln in lines[rows])
                   for key in ("kernel_ms", "plain_ms", "bound_ms") for rows in (64, 512)},
                **{f"library_ms_{rows}": sum(ln["library_ms"]["heuristic"] for ln in lines[rows])
                   for rows in (64, 512)})


def report_crepe_conv(cc: dict, smi: str) -> None:
    print(f"[crepe-conv] kernel against its plain version in {cc['cases']} forwards (full and "
          f"tiny at {', '.join(map(str, CREPE_CONV_ROWS))} rows): probabilities within "
          f"{cc['prob_err']:.3e}, six launches a forward, two calls bitwise equal; a 64-row "
          f"batch's device kernels (ms): {json.dumps(cc['ran'])} | {smi}", flush=True)
    for rows, lines in cc["lines"].items():
        for ln in lines:
            print(f"[crepe-conv] {json.dumps(ln)}", flush=True)
        print(f"[crepe-conv] {rows} rows, six layers: kernel {cc[f'kernel_ms_{rows}']:.3f} ms "
              f"(bound {cc[f'bound_ms_{rows}']:.3f} ms, "
              f"{100 * cc[f'bound_ms_{rows}'] / cc[f'kernel_ms_{rows}']:.0f}% reached), plain "
              f"{cc[f'plain_ms_{rows}']:.3f} ms, cuDNN's convolutions alone "
              f"{cc[f'library_ms_{rows}']:.3f} ms | {smi}", flush=True)


@contextlib.contextmanager
def stream_probes(device):
    """Wrap the streaming stages from outside and time each call (the card
    synchronised after it): whisper's window, HuBERT's window, CREPE's
    probabilities and its whole advance (probabilities and the host
    trellis), and synthesis (StreamingSvc.push, whose snake launches it
    counts). Yields the record of totals and per-call lists."""
    targets = [(stream_extract.StreamingWhisper, "push", "whisper"),
               (stream_extract.StreamingHubert, "push", "hubert"),
               (stream_extract, "crepe_probabilities", "crepe_probs"),
               (stream_extract.StreamingCrepe, "_advance", "crepe"),
               (StreamingSvc, "push", "synthesis")]
    orig = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]
    rec = {key: [] for _, _, key in targets} | {"synthesis_snakes": []}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            n0 = snake_cuda.launches
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(device)
            rec[key].append(time.perf_counter() - t0)
            if key == "synthesis":
                rec["synthesis_snakes"].append(snake_cuda.launches - n0)
            return out
        return wrapper

    for (owner, name, key), (_, _, fn) in zip(targets, orig):
        setattr(owner, name, timed(fn, key))
    try:
        yield rec
    finally:
        for owner, name, fn in orig:
            setattr(owner, name, fn)


def stream_audio_phase(base_hp, widths: dict = AUDIO_IN_FULL, device="cuda",
                       n_snakes: int = 91, seconds: float = STREAM_AUDIO_SECONDS) -> dict:
    """Audio in, audio out, block by block: the streaming extractors at
    `widths` (seeded random checkpoints in the reference layouts, through
    the port's loaders) and StreamingSvc.push_audio on a synthetic voice in
    STREAM_AUDIO_BLOCK blocks, then the flush. Checks the output length
    (2x the 16 kHz samples), n_snakes launches per synthesis push (and,
    on the card, n_snakes snake kernels a replay in one profiled block), a
    StreamingCrepe's flush path against the offline decode of the same
    audio, and the first block's features on the card against the CPU."""
    root = Path(tempfile.mkdtemp(prefix="svc_stream_audio_"))
    phase_t0 = time.perf_counter()
    try:
        ckpts = write_extractor_checkpoints(root, widths, device)
        hp = config_from_dict(base_hp)

        def extractors(dev):
            return (whisper_mod.load_whisper_encoder(ckpts["whisper"]["path"], dev),
                    hubert_mod.load_hubert_soft(ckpts["hubert"]["path"], dev),
                    crepe_mod.load_crepe(ckpts["crepe"]["path"], device=dev))

        models = extractors(device)
        model = pipeline.build_infer_model(hp, device=device, seed=0)
        spk = features(hp, 1, seed=42)[0]
        voice = synthetic_voice(seconds, 16000, seed=43, f0=180.0)
        blocks = [voice[s : s + STREAM_AUDIO_BLOCK]
                  for s in range(0, len(voice), STREAM_AUDIO_BLOCK)]
        check(all(len(b) == STREAM_AUDIO_BLOCK for b in blocks),
              "the voice is no whole number of blocks")

        def stream(n_blocks):
            svc = StreamingSvc(model, spk, hp, STREAM_BLOCK, STREAM_CONTEXT, device=device)
            svc.attach_extractor(stream_extract.StreamingExtractor(
                *models, block_samples=STREAM_AUDIO_BLOCK, lag_frames=STREAM_LAG,
                device=device))
            outs, walls = [], []
            for b in blocks[:n_blocks]:
                sync(device)
                t0 = time.perf_counter()
                outs.append(svc.push_audio(b))
                sync(device)
                walls.append(time.perf_counter() - t0)
            return svc, outs, walls

        stream(1)  # warm-up: cuDNN plans, first launches, the forward's CUDA graph
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        replays0 = stream_mod.graph_replays
        trellis0, frames0 = viterbi_cuda.launches_trellis, stream_extract.counts()
        conv0 = crepe_conv_cuda.launches_crepe_conv
        with stream_probes(device) as rec:
            svc, outs, walls = stream(len(blocks))
            blocks_rec = {k: list(v) for k, v in rec.items()}  # the blocks, not the flush
            sync(device)
            t0 = time.perf_counter()
            outs.append(svc.flush_audio())
            sync(device)
            flush_s = time.perf_counter() - t0
        counts = read_counts()
        trellis = viterbi_cuda.launches_trellis - trellis0
        crepe_convs = crepe_conv_cuda.launches_crepe_conv - conv0
        frames = {k: v - frames0[k] for k, v in stream_extract.counts().items()}
        on_card = torch.device(device).type == "cuda"
        crepe_batches = frames["crepe_rows"] // stream_extract._CREPE_BATCH
        check(crepe_convs == (6 * crepe_batches if on_card else 0),
              f"stream audio: {crepe_convs} CREPE convolution launches for {crepe_batches} "
              f"CREPE batches on {device}; expected six a batch on the card")
        check(trellis == (len(blocks) + 1 if on_card else 0),
              f"stream audio: {trellis} trellis launches for {len(blocks)} blocks and the "
              f"flush ({frames['crepe_frames']} CREPE frames) on {device}; expected a launch "
              f"a call on the card")
        peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
        audio = np.concatenate(outs)
        rms = float(np.sqrt(np.mean(np.square(audio))))
        check(audio.shape == (2 * len(voice),) and bool(np.isfinite(audio).all()) and rms > 1e-3,
              f"stream audio out {audio.shape} for {len(voice)} samples in, rms {rms}")
        pushes = len(rec["synthesis"])
        check(all(n == n_snakes for n in rec["synthesis_snakes"])
              and counts["direct"] == n_snakes * pushes and counts["bwd"] == counts["strips"]
              == counts["mma"] == counts["amp"] == 0,
              f"stream audio: {counts} launches in {pushes} synthesis pushes "
              f"({rec['synthesis_snakes']}), expected {n_snakes} direct a push")
        replays = stream_mod.graph_replays - replays0
        check(replays == (pushes if torch.device(device).type == "cuda" else 0),
              f"stream audio: {replays} graph replays in {pushes} synthesis pushes on "
              f"{device}, expected a replay a push on the card")
        prof_snakes = None
        if torch.device(device).type == "cuda":
            replays0 = stream_mod.graph_replays
            prof = profile(lambda: stream(1))
            replays = stream_mod.graph_replays - replays0
            prof_snakes = prof["counts"]["snake_fwd"]
            check(replays >= 1 and prof_snakes == n_snakes * replays,
                  f"stream audio: one profiled block ran {prof_snakes} snake kernels in "
                  f"{replays} replays, expected {n_snakes} a replay")

        # a StreamingCrepe over the same blocks, finished: its path against
        # the offline decode (the same 64-frame batches, the trellis on the
        # device), and against the offline default of 512-frame batches
        sc = stream_extract.StreamingCrepe(models[2], device=device)
        for b in blocks:
            sc.push(b)
        sc.finish()
        path = sc.decode(0, sc.head + 1)
        crepe_frames = crepe_mod.frame_audio(voice, stream_extract.HOP)
        offline = {bs: crepe_mod.viterbi_decode(crepe_mod.viterbi_observations(
            crepe_mod.crepe_probabilities(models[2], crepe_frames, batch_size=bs)),
            device=device) for bs in (stream_extract._CREPE_BATCH, 512)}
        check(len(path) == len(crepe_frames) and np.array_equal(path, offline[64]),
              f"the streaming CREPE's flush path differs from the offline path at "
              f"{np.flatnonzero(path != offline[64])[:10]} of {len(crepe_frames)} frames")
        path_diff_512 = int(np.sum(path != offline[512]))

        # the first block's features on the card against the CPU
        cpu_ex = stream_extract.StreamingExtractor(*extractors("cpu"),
                                                   block_samples=STREAM_AUDIO_BLOCK,
                                                   lag_frames=STREAM_LAG, device="cpu")
        card_ex = stream_extract.StreamingExtractor(*models, block_samples=STREAM_AUDIO_BLOCK,
                                                    lag_frames=STREAM_LAG, device=device)
        got, ref = card_ex.push(blocks[0]), cpu_ex.push(blocks[0])
        rows = card_ex.crepe._frame_rows(list(range(card_ex.crepe.head + 1)))
        errs = dict(ppg=max_err(got[0], ref[0]), vec=max_err(got[1], ref[1]),
                    crepe_probs=max_err(crepe_mod.crepe_probabilities(models[2], rows, 64),
                                        crepe_mod.crepe_probabilities(cpu_ex.crepe.model, rows,
                                                                      64)))
        for key, err in errs.items():
            check(err <= AUDIO_IN_ATOL[key], f"stream audio card vs CPU: {key} max abs err "
                                             f"{err:.3e} above {AUDIO_IN_ATOL[key]}")
        pit_equal = float(np.mean(got[2] == ref[2]))
        return dict(walls=walls, flush_s=flush_s, rec=blocks_rec, counts=counts, pushes=pushes,
                    prof_snakes=prof_snakes, peak=peak, rms=rms, errs=errs, pit_equal=pit_equal,
                    crepe_frames=len(crepe_frames), path_diff_512=path_diff_512,
                    trellis_launches=trellis, stream_crepe_frames=frames["crepe_frames"],
                    crepe_conv_launches=crepe_convs, crepe_batches=crepe_batches,
                    block_s=STREAM_AUDIO_BLOCK / 16000, seconds=seconds,
                    phase_s=time.perf_counter() - phase_t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def train_bf16d_phase(base_hp, device="cuda", n_snakes: int = 91) -> dict:
    """One base-width step with train.bf16_discriminator: a warm-up step and
    TIMED_STEPS timed steps (n_snakes forward and backward launches each,
    finite metrics), peak memory, one profiled step's convolution kernels by
    dtype; the D scores on one batch's real segments against a float32 D
    with the same parameters; every gradient finite, every parameter and
    AdamW state float32."""
    hp = config_from_dict(base_hp)
    hp.train["bf16_discriminator"] = True
    g_state, d_state = tstep.init_train_states(hp, seed=0, device=device)
    check(d_state.model.compute_dtype == torch.bfloat16, "bf16_discriminator not applied")
    step = tstep.make_train_step(hp, g_state, d_state)
    gen = torch.Generator(device=device).manual_seed(0)
    batches = [train_batch(hp, hp.train.batch_size, TRAIN_FRAMES, seed=60 + i)
               for i in range(TIMED_STEPS + 2)]
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms = []
    for i, batch in enumerate(batches[: TIMED_STEPS + 1]):
        sync(device)
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        sync(device)
        if i:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        metrics = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in metrics.values()), f"bf16 D step {i}: {metrics}")
    counts = read_counts()
    n_steps = TIMED_STEPS + 1
    check(counts["direct"] == counts["bwd"] == n_snakes * n_steps,
          f"bf16 D: {counts} launches in {n_steps} steps, expected {n_snakes} each a step")
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0

    g_grads, d_grads, _ = tstep.loss_and_grads(hp, g_state.model, d_state.model, batches[-1],
                                               gen)
    for grads, state in ((g_grads, g_state), (d_grads, d_state)):
        for grad, p in zip(grads, state.params):
            check(grad.dtype == p.dtype == torch.float32 and bool(torch.isfinite(grad).all()),
                  f"bf16 D: a gradient of {tuple(p.shape)} is {grad.dtype} or not finite")
            st = state.optimizer.state[p]
            check(st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32,
                  "bf16 D: an AdamW state is not float32")
    del g_grads, d_grads

    d32 = tstep.build_models(config_from_dict(base_hp))[1].to(device)
    d32.load_state_dict(d_state.model.state_dict())
    x = torch.from_numpy(batches[-1]["audio"][:, : hp.data.segment_size]).to(device)
    with torch.no_grad():
        rel = [float((s32 - s16).abs().mean() / (s32.abs().mean() + 1e-8))
               for (_, s32), (_, s16) in zip(d32(x), d_state.model(x))]
    check(max(rel) < 0.05, f"bf16 D scores against float32: mean relative errors {rel}")
    del d32
    prof = None
    if torch.device(device).type == "cuda":
        prof = profile(lambda: step(batches[-1], gen))
        conv = {n: c for n, c in prof["names"].items() if kernel_kind(n) == "conv"}
        prof["conv_by_dtype"] = {
            "bf16": sum(c for n, c in conv.items() if "bf16" in n.lower()),
            "other": sum(c for n, c in conv.items() if "bf16" not in n.lower())}
    return dict(step_ms=step_ms, peak=peak, rel=rel, counts=counts, prof=prof,
                n_steps=n_steps, batch=hp.train.batch_size)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_ddp_phase(base_hp, device="cuda", n_snakes: int = 91, steps: int = 2) -> dict:
    """`train` for `steps` loop steps on a synthetic dataset, twice without
    a process group and once through hp.dist as a one-rank group (NCCL on
    the card, gloo on the CPU), from the same seed, with PyTorch's
    deterministic algorithms (cuDNN's default convolution algorithms sum
    their gradients in an order that changes from run to run): n_snakes
    forward and backward launches a step in each, the checkpoint written by
    rank 0, and the runs' parameters, AdamW states and accumulators equal to
    the bit (the second run without a group shows that the loop repeats
    itself, so that a difference would be the group's)."""
    root = Path(tempfile.mkdtemp(prefix="svc_train_ddp_"))
    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        train_fl, valid_fl, _ = write_dataset(config_from_dict(base_hp), root / "data", seed=7)
        runs = {}
        for name, dist in (("single", None), ("again", None),
                           ("ddp", dict(coordinator_address=f"localhost:{_free_port()}",
                                        num_processes=1, process_id=0))):
            hp = config_from_dict(base_hp)
            hp.data.update(training_files=train_fl, validation_files=valid_fl)
            hp["log"] = config_from_dict(dict(
                info_interval=1, eval_interval=10**6, save_interval=1, num_audio=0,
                pth_dir=str(root / "chkpt"), log_dir=str(root / "logs"), keep_ckpts=0))
            if dist is not None:
                hp["dist"] = config_from_dict(dist)
            reset_counts()
            sync(device)
            t0 = time.perf_counter()
            g, d, step = tloop.train(hp, name, max_epochs=1, max_steps=steps, device=device)
            sync(device)
            wall = time.perf_counter() - t0
            counts = read_counts()
            check(step == steps and counts["direct"] == counts["bwd"] == n_snakes * steps,
                  f"{name}: step {step}, {counts} launches, expected {n_snakes} each a step")
            check(os.listdir(root / "chkpt" / name) == [f"{name}_0001.pth"],
                  f"{name}: checkpoints {os.listdir(root / 'chkpt' / name)}")
            runs[name] = dict(g=g, d=d, wall=wall, counts=counts,
                              device=str(next(g.model.parameters()).device),
                              world=tddp.world_size(), backend=(
                                  torch.distributed.get_backend() if tddp.is_initialized()
                                  else None))
        tddp.shutdown()
        check(runs["ddp"]["world"] == 1 and runs["ddp"]["backend"] == (
            "nccl" if torch.device(device).type == "cuda" else "gloo"),
            f"the one-rank group: {runs['ddp']['world']} ranks, {runs['ddp']['backend']}")
        for other in ("again", "ddp"):
            bad = (state_mismatches(runs["single"]["g"], runs[other]["g"])
                   + state_mismatches(runs["single"]["d"], runs[other]["d"]))
            check(not bad, f"{other}: states differ from the first run without a group: "
                           f"{bad[:8]} ({len(bad)})")
        return dict(runs={k: dict(wall=v["wall"], counts=v["counts"], backend=v["backend"],
                                  device=v["device"]) for k, v in runs.items()}, steps=steps)
    finally:
        tddp.shutdown()
        torch.use_deterministic_algorithms(deterministic[0], warn_only=True)
        torch.backends.cudnn.deterministic = deterministic[1]
        shutil.rmtree(root, ignore_errors=True)


def report_stream(st: dict, kst: dict, smi: str) -> None:
    walls = [1e3 * w for w in st["walls"]]
    print(f"[stream] {st['blocks']} blocks of {STREAM_BLOCK} frames ({st['block_s']:.2f} s) "
          f"after {STREAM_CONTEXT} frames of context at base width, noise_scale 0: wall per "
          f"push median {np.median(walls):.2f} ms, p90 {_percentile(walls, 90):.2f} ms, "
          f"min {min(walls):.2f}, max {max(walls):.2f} (realtime x"
          f"{st['block_s'] / (np.median(walls) / 1e3):.2f} at the median); snake launches "
          f"{st['counts']['direct']} ({st['counts']['direct'] // st['blocks']} a block); "
          f"peak device memory {st['peak'] / 2**30:.2f} GiB | {smi}", flush=True)
    print(f"[stream] card vs CPU over {STREAM_CPU_BLOCKS} blocks: max abs err "
          f"{st['cpu_err']:.3e} (tolerance {CARD_VS_CPU_ATOL}; CPU "
          f"{1e3 * np.median(st['cpu_walls']):.1f} ms a block); blocks {STREAM_WINDOW_BLOCKS} "
          f"against one forward on their window with the whole utterance's excitation: max "
          f"abs err {st['window_err']:.3e} (tolerance {CARD_VS_CPU_ATOL}) | {smi}", flush=True)
    print(f"[stream] B1 at the window's stage shapes ([kernel-stream]): "
          f"{kst['ms']:.3f} ms a block, bound {kst['bound_ms']:.3f} ms, plain "
          f"{kst['plain_ms']:.2f} ms | {smi}", flush=True)
    prof = st["prof"]
    if prof is not None:
        print(prof["table"], flush=True)
        print(f"[stream] one profiled block: wall {prof['wall_ms']:.2f} ms, device busy "
              f"{prof['busy_ms']:.2f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), "
              f"profiler on; device ms by kind "
              + json.dumps({k: round(v, 3) for k, v in prof["kinds"].items()})
              + "; kernels by kind " + json.dumps(prof["counts"]) + f" | {smi}", flush=True)


def report_stream_audio(sa: dict, smi: str) -> None:
    walls = [1e3 * w for w in sa["walls"]]
    rec = sa["rec"]
    share = {k: 1e3 * sum(rec[k]) / len(walls) for k in ("whisper", "hubert", "synthesis")}
    share["crepe_probs"] = 1e3 * sum(rec["crepe_probs"]) / len(walls)
    share["crepe_trellis"] = 1e3 * (sum(rec["crepe"]) - sum(rec["crepe_probs"])) / len(walls)
    share["other"] = float(np.mean(walls)) - sum(share.values())
    print(f"[stream-audio] {sa['seconds']:.1f} s voice in {len(walls)} blocks of "
          f"{sa['block_s']:.2f} s (lag {STREAM_LAG} frames) at the published widths: wall per "
          f"block median {np.median(walls):.2f} ms, p90 {_percentile(walls, 90):.2f} ms, first "
          f"{walls[0]:.2f} ms; latency per block {1e3 * sa['block_s']:.0f} ms of buffering + "
          f"the wall = {1e3 * sa['block_s'] + np.median(walls):.2f} ms at the median; flush "
          f"{1e3 * sa['flush_s']:.2f} ms; mean ms a block by stage "
          + json.dumps({k: round(v, 2) for k, v in share.items()})
          + f"; {sa['pushes']} synthesis pushes, trellis launches {sa['trellis_launches']} "
          f"(for {sa['stream_crepe_frames']} CREPE frames), CREPE convolution launches "
          f"{sa['crepe_conv_launches']} (for {sa['crepe_batches']} CREPE batches), snake launches "
          f"{sa['counts']['direct']} "
          f"(one profiled block: {sa['prof_snakes']} snake kernels on the device); "
          f"peak device memory {sa['peak'] / 2**30:.2f} GiB | {smi}", flush=True)
    print(f"[stream-audio] the streaming CREPE's flush path equals the offline decode on all "
          f"{sa['crepe_frames']} frames (64-frame batches; {sa['path_diff_512']} frames differ "
          f"from 512-frame batches); first block card vs CPU max abs err "
          + ", ".join(f"{k} {v:.3e} ({AUDIO_IN_ATOL[k]})" for k, v in sa["errs"].items())
          + f", emitted pitch equal on {100 * sa['pit_equal']:.1f}% of frames; the phase took "
          f"{sa['phase_s']:.1f} s | {smi}", flush=True)


def report_train_bf16d(bd: dict, f32_step_ms: list, smi: str) -> None:
    prof = bd["prof"]
    print(f"[train-bf16d] bf16_discriminator, batch {bd['batch']} x {TRAIN_FRAMES} frames: "
          f"{np.mean(bd['step_ms']):.2f} ms per step (steps "
          f"{[round(t, 2) for t in bd['step_ms']]}) against the float32 D's "
          f"{np.mean(f32_step_ms):.2f} ms ([train], this call); peak device memory "
          f"{bd['peak'] / 2**30:.2f} GiB; D scores against float32 with the same parameters, "
          f"mean relative error {max(bd['rel']):.4f} worst of {len(bd['rel'])} (bound 0.05); "
          f"every gradient finite, parameters and AdamW states float32; snake launches fwd "
          f"{bd['counts']['direct']} bwd {bd['counts']['bwd']} in {bd['n_steps']} steps | {smi}",
          flush=True)
    if prof is not None:
        print(prof["table"], flush=True)
        print(f"[train-bf16d] one profiled step: wall {prof['wall_ms']:.2f} ms, device busy "
              f"{prof['busy_ms']:.2f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%); "
              f"device ms by kind " + json.dumps({k: round(v, 3) for k, v in prof["kinds"].items()})
              + "; convolution kernels by dtype " + json.dumps(prof["conv_by_dtype"])
              + f" | {smi}", flush=True)


def report_train_ddp(dd: dict, smi: str) -> None:
    r = dd["runs"]
    print(f"[train-ddp] train() for {dd['steps']} loop steps at base width, deterministic "
          f"algorithms: without a process group {1e3 * r['single']['wall']:.2f} / "
          f"{1e3 * r['again']['wall']:.2f} ms, as a one-rank {r['ddp']['backend']} group "
          f"on {r['ddp']['device']} through hp.dist {1e3 * r['ddp']['wall']:.2f} ms (set-up, "
          f"the steps and a checkpoint each); parameters, AdamW states and accumulators equal "
          f"to the bit; "
          f"snake launches fwd {r['ddp']['counts']['direct']} bwd {r['ddp']['counts']['bwd']} "
          f"| {smi}", flush=True)



# ------------------------------------------------------------------ the make-a-voice flow

PREP_SPEAKERS = {"spk0": (2.5, 4.0, 9.0, 17.0), "spk1": (3.0, 6.5, 12.0, 21.0)}
PREP_SR = 44100
PREP_ATOL = 1e-4       # staged against serial: features and specs, max abs
PREP_SPEC_ATOL = 1e-5  # a staged spec against linear_spectrogram of its wave
PREP_STAGES = ("resample", "pitch", "whisper", "hubert", "speaker", "specs")
PREP_LOGS = {"resample": "resample:", "pitch": "pitch:", "whisper": "whisper ppg:",
             "hubert": "hubert vec:", "speaker": "speaker embed:", "specs": "specs:"}
PREP_BATCH = 2         # the flow's training batch (8 utterances, 4 of them validation)
PREP_FLOW_STEPS = 2
SERVE_WHISPER_LAYERS = 4  # a 32-layer float32 whisper artifact is about 2.5 GB
SERVE_CREPE_BATCH = 512
SERVE_ATOL = dict(whisper=1e-3, hubert=1e-3, crepe=1e-4)  # as [audio-in]
WEBUI_WAVE_SECONDS = 6.0
WEBUI_POLL_S = 600.0
RESNET_ATOL = 1e-5


def longest_utterance() -> tuple[str, str]:
    """(speaker, name) of PREP_SPEAKERS' longest utterance."""
    spk, lengths = max(PREP_SPEAKERS.items(), key=lambda kv: max(kv[1]))
    return spk, f"u{int(np.argmax(lengths))}"


def prep_config(base_hp, root: Path) -> dict:
    """The base config as a plain dict with the flow's batch size and its
    files and logs under `root`."""
    hp = json.loads(json.dumps(base_hp))
    hp["train"]["batch_size"] = PREP_BATCH
    hp["data"].update(training_files=str(root / "files_staged" / "train.txt"),
                      validation_files=str(root / "files_staged" / "valid.txt"))
    hp["log"].update(info_interval=1, eval_interval=10**6, save_interval=1, num_audio=0,
                     pth_dir=str(root / "chkpt"), log_dir=str(root / "logs"), keep_ckpts=0)
    return hp


class _StampedLines(io.TextIOBase):
    """stdout that keeps each line with the time it was written."""

    def __init__(self):
        self.lines, self._buf = [], ""

    def write(self, s: str) -> int:
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(s)


def prep_request(argv: list, device) -> dict:
    """The preprocessing CLI's `main` with its output kept line by line; the
    driver's span is marked by wrapping `preprocess` from outside, and each
    stage's wall runs from the previous stage's log line to its own (every
    stage reads its last batch back before it logs)."""
    orig, mark = cli_prep.preprocess, {}

    def timed(*args, **kwargs):
        sync(device)
        mark["t0"] = time.perf_counter()
        out = orig(*args, **kwargs)
        sync(device)
        mark["t1"] = time.perf_counter()
        return out

    out = _StampedLines()
    cli_prep.preprocess = timed
    try:
        sync(device)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            stats = cli_prep.main(argv)
        wall = time.perf_counter() - t0
    finally:
        cli_prep.preprocess = orig
    stage_ms, prev = {}, mark["t0"]
    for t, line in out.lines:
        for stage, head in PREP_LOGS.items():
            if line.startswith(head) and mark["t0"] <= t <= mark["t1"]:
                stage_ms[stage], prev = 1e3 * (t - prev), t
    text = "\n".join(line for _, line in out.lines)
    return dict(stats=stats, wall=wall, prep_s=mark["t1"] - mark["t0"], stage_ms=stage_ms,
                text=text)


def npy_tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*.npy"))}


def prep_phase(base_hp, root: Path, widths: dict = AUDIO_IN_FULL, device="cuda") -> dict:
    """The preprocessing CLI on the card on a synthetic dataset_raw/ of two
    speakers at 44.1 kHz, with seeded random extractor checkpoints at
    `widths`: once staged and once --serial into separate trees (every file
    held: pitch equal, features and specs within PREP_ATOL, the waves
    byte-equal), the specs against linear_spectrogram of the same 32 kHz
    wave (PREP_SPEC_ATOL), a rerun that skips every stage, the filelists
    and the dry run; the staged driver once more under torch.profiler with
    the extractors loaded; CREPE's peak memory at the drivers' 512-frame
    batches and at 2048; then
    --stage cdc and --stage trim on two of the waves against the port's
    functions. No kernel launches in any of it."""
    phase_t0 = time.perf_counter()
    (root / "ckpt").mkdir(parents=True)
    ckpts = write_extractor_checkpoints(root / "ckpt", widths, device)
    raw, audio_s, n_items = root / "dataset_raw", 0.0, 0
    for si, (spk, lengths) in enumerate(PREP_SPEAKERS.items()):
        (raw / spk).mkdir(parents=True)
        for i, secs in enumerate(lengths):
            save_wav(str(raw / spk / f"u{i}.wav"),
                     synthetic_voice(secs, PREP_SR, seed=40 + 10 * si + i, f0=150.0 + 60 * si),
                     PREP_SR)
            audio_s += secs
            n_items += 1
    cfg = root / "base.json"
    cfg.write_text(json.dumps(prep_config(base_hp, root)))
    common = ["-c", str(cfg), "--dataset-raw", str(raw), "--whisper-ckpt",
              ckpts["whisper"]["path"], "--hubert-ckpt", ckpts["hubert"]["path"],
              "--crepe-ckpt", ckpts["crepe"]["path"], "--speaker-ckpt",
              ckpts["speaker"]["path"], "--device", str(device)]

    def tree(name):
        return ["--out", str(root / f"data_{name}"), "--files", str(root / f"files_{name}")]

    runs = {}
    reset_counts()
    # in ABBA order: the first run pays the process's warm-up (cuDNN's
    # algorithm choices, the first loads of each kernel), so each driver runs
    # once first and once last
    for name, extra in (("staged", []), ("serial", ["--serial"]), ("serial_2", ["--serial"]),
                        ("staged_2", [])):
        base = 0
        if torch.device(device).type == "cuda":
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        runs[name] = prep_request(common + tree(name) + extra, device)
        runs[name]["peak"] = (torch.cuda.max_memory_allocated() - base
                              if torch.device(device).type == "cuda" else 0)
    rerun = prep_request(common + tree("staged"), device)
    counts = read_counts()
    check(not any(counts.values()), f"preprocessing launched kernels: {counts}")
    for name, r in runs.items():
        st = r["stats"]
        check(st["items"] == st["rows"] == n_items and not any(st["skipped"].values()),
              f"{name}: {st}, expected {n_items} items and rows, nothing skipped")
        check("[skip]" not in r["text"], f"{name} skipped a stage:\n{r['text']}")
        batches = [int(line.split(",")[1].split()[0]) for line in r["text"].splitlines()
                   if line.startswith("dataset dry-run ok")]
        check(batches and batches[0] > 0, f"{name}: dry run {batches}:\n{r['text'][-2000:]}")
        r["dry_run_batches"] = batches[0]
    check(rerun["stats"]["skipped"] == dict.fromkeys(PREP_STAGES, n_items),
          f"rerun: skipped {rerun['stats']['skipped']}, expected {n_items} each")
    check(set(runs["staged"]["stage_ms"]) == set(PREP_STAGES),
          f"stage lines {runs['staged']['stage_ms']}")

    # the two trees, file by file
    a, b = npy_tree(root / "data_staged"), npy_tree(root / "data_serial")
    check(list(a) == list(b) and len(a) == 5 * n_items + len(PREP_SPEAKERS),
          f"trees differ: {sorted(set(a) ^ set(b))[:8]}, {len(a)} files")
    errs = {}
    for rel, pa in a.items():
        sub = rel.split("/")[0]
        x, y = np.load(pa), np.load(b[rel])
        check(x.shape == y.shape, f"{rel}: {x.shape} against serial {y.shape}")
        if sub == "pitch":
            bad = np.flatnonzero(x != y)
            check(bad.size == 0, f"{rel}: pitch differs from serial at frames {bad[:10]} "
                                 f"({bad.size} of {x.size})")
        else:
            errs[sub] = max(errs.get(sub, 0.0), max_err(x, y))
    check(max(errs.values()) <= PREP_ATOL,
          f"staged against serial max abs err {errs}, above {PREP_ATOL}")
    for sub in ("waves-16k", "waves-32k"):
        for p in sorted((root / "data_staged" / sub).rglob("*.wav")):
            rel = p.relative_to(root / "data_staged")
            check(p.read_bytes() == (root / "data_serial" / rel).read_bytes(), f"{rel} differs")
    spec_err, data = 0.0, base_hp["data"]
    for p in sorted((root / "data_staged" / "waves-32k").rglob("*.wav")):
        rel = p.relative_to(root / "data_staged" / "waves-32k")
        a32 = audio_io.load_wav(str(p))[0]
        with torch.inference_mode():
            want = stft_mod.linear_spectrogram(
                torch.from_numpy(a32)[None].to(device), data["filter_length"],
                data["hop_length"], data["win_length"])[0].cpu().numpy()
        got = np.load(root / "data_staged" / "specs" / rel.with_suffix(".spec.npy"))
        check(got.shape == want.shape, f"{rel}: spec {got.shape}, expected {want.shape}")
        spec_err = max(spec_err, max_err(got, want))
    check(spec_err <= PREP_SPEC_ATOL, f"staged specs against linear_spectrogram: max abs err "
                                      f"{spec_err:.3e} above {PREP_SPEC_ATOL}")
    rows = {n: len((root / "files_staged" / n).read_text().splitlines())
            for n in ("train.txt", "valid.txt")}
    check(sum(rows.values()) == n_items, f"filelists {rows}, expected {n_items} rows")
    pitch = np.concatenate([np.load(p) for rel, p in a.items() if rel.startswith("pitch")])

    # the staged driver under the profiler, the extractors loaded
    ex = prep_mod.Extractors(
        crepe=crepe_mod.load_crepe(ckpts["crepe"]["path"], device=device),
        whisper=whisper_mod.load_whisper_encoder(ckpts["whisper"]["path"], device),
        hubert=hubert_mod.load_hubert_soft(ckpts["hubert"]["path"], device),
        speaker=spk_mod.load_speaker_encoder(ckpts["speaker"]["path"], device))
    hp_data = config_from_dict(prep_config(base_hp, root)).data
    prof = None
    if torch.device(device).type == "cuda":
        prof = profile(lambda: prep_mod.preprocess(
            str(raw), str(root / "data_prof"), str(root / "files_prof"), hp_data, ex,
            progress=False, device=device))
        # CREPE's peak memory on the longest utterance at the drivers' batch
        # (CREPE_BATCH frames) and at the JAX package's staged 2048
        spk, name = longest_utterance()
        a16 = audio_io.load_wav(str(root / "data_staged" / "waves-16k" / spk / f"{name}.wav"))[0]
        crepe_peak = {}
        for frames in (prep_mod.CREPE_BATCH, 2048):
            sync(device)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            crepe_mod.compute_f0(ex.crepe, a16, np.random.default_rng(0), batch_size=frames)
            crepe_peak[frames] = torch.cuda.max_memory_allocated() - base
    else:
        crepe_peak = {}
    del ex

    # the VCTK clean-up stages on two of the waves
    vctk = {}
    cdc_in = root / "vctk_in" / "spk0"
    cdc_in.mkdir(parents=True)
    for i in (0, 1):
        shutil.copy(raw / "spk0" / f"u{i}.wav", cdc_in / f"u{i}.wav")
    for stage, fn in (("cdc", lambda x, sr: prep_mod.cut_direct_content(x)),
                      ("trim", prep_mod.trim_silence_concat)):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli_prep.main(["--stage", stage, "-i", str(root / "vctk_in"),
                           "-o", str(root / f"vctk_{stage}")])
        vctk[stage] = 1e3 * (time.perf_counter() - t0)
        for src in sorted(cdc_in.glob("*.wav")):
            x, sr = audio_io.load_wav(str(src))
            got_sr, got = wavfile.read(root / f"vctk_{stage}" / "spk0" / src.name)
            want = prep_mod._quantize_int16_trunc(fn(x, sr))
            check(got_sr == sr and np.array_equal(got, want),
                  f"--stage {stage} {src.name}: not the port's function's int16 output")
    return dict(ckpts=ckpts, runs=runs, rerun=rerun, errs=errs, spec_err=spec_err, rows=rows,
                n_items=n_items, audio_s=audio_s, prof=prof, crepe_peak=crepe_peak,
                vctk_ms=vctk, voiced=float((pitch > 0).mean()), cfg=str(cfg),
                phase_s=time.perf_counter() - phase_t0)


def report_prep(pr: dict, smi: str) -> None:
    runs = pr["runs"]
    s, r = runs["staged"], runs["serial"]

    def run(name):
        x = runs[name]
        return (f"{name} CLI {1e3 * x['wall']:.2f} ms ({1e3 * x['prep_s']:.2f} ms in the "
                f"driver, {pr['audio_s'] / x['prep_s']:.2f} audio s per wall s)")

    staged_s = s["prep_s"] + runs["staged_2"]["prep_s"]
    serial_s = r["prep_s"] + runs["serial_2"]["prep_s"]
    print(f"[prep] {pr['n_items']} utterances, {pr['audio_s']:.1f} s of 44.1 kHz audio, two "
          f"speakers; in turns " + ", ".join(run(n) for n in runs) + f"; the staged driver "
          f"x{serial_s / staged_s:.2f} the serial over both turns; rerun "
          f"{1e3 * pr['rerun']['wall']:.2f} ms, skipped {pr['rerun']['stats']['skipped']} | "
          f"{smi}", flush=True)
    print("[prep] staged wall ms by stage, first / last turn " + json.dumps(
        {k: [round(v, 2), round(runs["staged_2"]["stage_ms"][k], 2)]
         for k, v in s["stage_ms"].items()}) + f"; peak device memory above the "
          f"phase's start, staged "
          f"{s['peak'] / 2**30:.2f} GiB, serial {r['peak'] / 2**30:.2f} GiB; CREPE above the "
          f"loaded models at " + ", ".join(f"{k}-frame batches {v / 2**30:.3f} GiB"
                                           for k, v in pr["crepe_peak"].items())
          + f" | {smi}", flush=True)
    print(f"[prep] staged against serial, max abs err " + json.dumps(
        {k: float(f"{v:.3e}") for k, v in pr["errs"].items()}) + f" (bound {PREP_ATOL}), pitch "
          f"equal ({100 * pr['voiced']:.1f}% of frames voiced); specs against "
          f"linear_spectrogram {pr['spec_err']:.3e} (bound {PREP_SPEC_ATOL}); filelists "
          f"{pr['rows']}, dry run {s['dry_run_batches']} batches of {PREP_BATCH}; "
          f"--stage cdc / trim {pr['vctk_ms']['cdc']:.2f} / {pr['vctk_ms']['trim']:.2f} ms, "
          f"equal to the port's functions", flush=True)
    if pr["prof"]:
        p = pr["prof"]
        print(f"[prep-profile] the staged driver, extractors loaded: wall {p['wall_ms']:.2f} "
              f"ms, device busy {p['busy_ms']:.2f} ms ({100 * p['busy_ms'] / p['wall_ms']:.1f}%), "
              f"profiler on; device ms by kind "
              + json.dumps({k: round(v, 3) for k, v in p["kinds"].items()}) + f" | {smi}",
              flush=True)
    print(f"[prep] phase {pr['phase_s']:.1f} s", flush=True)


def prep_flow_phase(base_hp, root: Path, pr: dict, widths: dict = AUDIO_IN_FULL,
                    device="cuda", n_snakes: int = 91,
                    chunk_frames: int = CHUNK_FRAMES, serve_widths: bool = True) -> dict:
    """[prep]'s dataset through the rest of the flow: the trainer CLI for
    PREP_FLOW_STEPS steps at base width from a .json config (n_snakes
    forward and backward launches a step); the export CLI with --artifact at
    chunk_frames; the artifact, loaded, against the port's model with its
    kernels on, on one chunk of [prep]'s features with the same noise
    (CARD_VS_CPU_ATOL), each call n_snakes forward launches (the artifact's
    through svc::snake_alias); the inference CLI from the exported checkpoint with
    [prep]'s .ppg/.vec/.pit (n_snakes a chunk); the three extractor
    artifacts against their modules (whisper at its published width, depth
    cut to SERVE_WHISPER_LAYERS; HuBERT and CREPE as [prep] loads them)."""
    phase_t0 = time.perf_counter()
    cfg = pr["cfg"]
    hp = config_from_dict(json.loads(Path(cfg).read_text()))
    reset_counts()
    sync(device)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        cli_trainer.main(["-c", cfg, "-n", "flow", "--max-steps", str(PREP_FLOW_STEPS),
                          "--device", str(device)])
    sync(device)
    train_s = time.perf_counter() - t0
    train_counts = read_counts()
    check(train_counts["direct"] == train_counts["bwd"] == n_snakes * PREP_FLOW_STEPS,
          f"trainer CLI: {train_counts} launches in {PREP_FLOW_STEPS} steps, expected "
          f"{n_snakes} forward and backward a step:\n{log.getvalue()[-2000:]}")
    trained = tckpt.latest_checkpoint(str(root / "chkpt" / "flow"), "flow")
    check(trained is not None and tckpt.load(trained)["step"] == PREP_FLOW_STEPS,
          f"trainer CLI: checkpoint {trained}")

    export, artifact = root / "export.pth", root / "svc_serving.pt2"
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli_export.main(["--checkpoint", trained, "--out", str(export), "--artifact",
                         str(artifact), "--config", cfg, "--chunk-frames", str(chunk_frames),
                         "--device", str(device)])
    export_s = time.perf_counter() - t0
    check(not any(read_counts().values()), f"export launched kernels: {read_counts()}")

    # one chunk of [prep]'s longest utterance
    stem, (who, name) = root / "data_staged", longest_utterance()
    files = dict(ppg=stem / "whisper" / who / f"{name}.ppg.npy",
                 vec=stem / "hubert" / who / f"{name}.vec.npy",
                 pit=stem / "pitch" / who / f"{name}.pit.npy",
                 spk=stem / "singer" / f"{who}.spk.npy")
    ppg = np.repeat(np.load(files["ppg"]), 2, 0)
    vec = np.repeat(np.load(files["vec"]), 2, 0)
    pit = np.load(files["pit"])
    spk = np.load(files["spk"])
    t = chunk_frames
    model = pipeline.load_svc_model(str(export), pipeline.build_infer_model(hp, device=device))
    dev = next(model.parameters()).device
    args = (torch.from_numpy(ppg[None, :t]).to(dev), torch.from_numpy(vec[None, :t]).to(dev),
            torch.from_numpy(pit[None, :t]).to(dev), torch.from_numpy(spk[None]).to(dev),
            torch.full((1,), t, device=dev),
            pipeline.pitch2source_bucketed(model, pit[:t], dev))
    noise = serving.draw_noise(7, (1, t, hp.vits.inter_channels), dev)
    program = serving.load_exported(str(artifact))
    reset_counts()
    with torch.inference_mode():
        want = model(*args, 1.0, noise=noise)
        sync(device)
        kernel_counts = read_counts()
        reset_counts()
        got = program(*args, noise)
        sync(device)
        artifact_counts = read_counts()
    check(kernel_counts["direct"] == n_snakes and artifact_counts == kernel_counts,
          f"the kernel model launched {kernel_counts}, the artifact {artifact_counts}: "
          f"expected {n_snakes} forward launches each (svc::snake_alias in the artifact)")
    art_err = max_err(got.cpu(), want.float().cpu())
    check(got.shape == want.shape and art_err <= CARD_VS_CPU_ATOL,
          f"artifact against the kernels: {tuple(got.shape)}, max abs err {art_err:.3e} "
          f"above {CARD_VS_CPU_ATOL}")
    fn = serving.load_synthesis(str(artifact))
    seed_err = max_err(fn(*args, 7).cpu(), got.cpu())
    other_err = max_err(fn(*args, 8).cpu(), got.cpu())
    check(seed_err <= CARD_VS_CPU_ATOL < other_err,
          f"load_synthesis: seed 7 is {seed_err:.3e} from the program on seed 7's noise, "
          f"seed 8 {other_err:.3e}")

    # ms per chunk: the artifact (noise drawn for the seed) against svc_infer
    # on one 1000-frame chunk of the same features, in turns
    req = (spk, pit[:1000], ppg[:1000], vec[:1000])
    art_ms, infer_ms = [], []
    for i in range(6):
        for fn_, ms in ((lambda: fn(*args, i), art_ms),
                        (lambda: pipeline.svc_infer(model, DummyRetrieval(), *req, hp=hp,
                                                    device=device), infer_ms)):
            sync(device)
            t0 = time.perf_counter()
            fn_()
            sync(device)
            ms.append(1e3 * (time.perf_counter() - t0))
    art_ms, infer_ms = art_ms[1:], infer_ms[1:]  # the first call warms up

    # cli.inference from the exported checkpoint with [prep]'s features
    csv = root / f"{name}.pit.csv"
    pipeline.save_csv_pitch(pit, str(csv))
    infer = extras_request(root / "flow_infer", [
        "--config", cfg, "--model", str(export), "--spk", str(files["spk"]),
        "--ppg", str(files["ppg"]), "--vec", str(files["vec"]), "--pit", str(csv),
        "--device", str(device)], device, n_snakes, hp.data.hop_length)

    # the extractor artifacts against their modules
    extractors = {}
    if serve_widths:
        wd = dict(widths["whisper"])
        with torch.device("meta"):
            shape = whisper_mod.WhisperEncoder(
                n_mels=wd["n_mels"], n_ctx=wd["n_audio_ctx"], n_state=wd["n_audio_state"],
                n_head=wd["n_audio_head"], n_layer=SERVE_WHISPER_LAYERS)
        whisper = whisper_mod.WhisperEncoder(
            n_mels=wd["n_mels"], n_ctx=wd["n_audio_ctx"], n_state=wd["n_audio_state"],
            n_head=wd["n_audio_head"], n_layer=SERVE_WHISPER_LAYERS)
        whisper.load_state_dict(random_state_dict(shape, 51, device), strict=True)
        mods = dict(whisper=whisper.to(device).eval(),
                    hubert=hubert_mod.load_hubert_soft(pr["ckpts"]["hubert"]["path"], device),
                    crepe=crepe_mod.load_crepe(pr["ckpts"]["crepe"]["path"], device=device))
        voice = synthetic_voice(20.0, 16000, seed=52, f0=200.0)
        inputs = dict(
            whisper=torch.from_numpy(voice[None, : whisper_mod.WINDOW_SAMPLES]).to(device),
            hubert=torch.from_numpy(voice[None, : 20 * 16000]).to(device),
            crepe=torch.from_numpy(crepe_mod.frame_audio(voice, 160)[:SERVE_CREPE_BATCH]
                                   ).to(device))
        with torch.inference_mode():
            direct = dict(
                whisper=mods["whisper"](whisper_mod.log_mel_spectrogram(inputs["whisper"])),
                hubert=mods["hubert"](inputs["hubert"]),
                crepe=mods["crepe"](crepe_mod.normalize_frames(inputs["crepe"])))
        for kind, module in mods.items():
            path = root / f"{kind}.pt2"
            t0 = time.perf_counter()
            n = serving.export_extractor(kind, module, str(path),
                                         batch=SERVE_CREPE_BATCH if kind == "crepe" else 1)
            secs = time.perf_counter() - t0
            conv0 = crepe_conv_cuda.launches_crepe_conv
            with torch.inference_mode():
                out = serving.load_exported(str(path))(inputs[kind])
            convs = crepe_conv_cuda.launches_crepe_conv - conv0
            err = max_err(out.cpu(), direct[kind].cpu())
            check(out.shape == direct[kind].shape and err <= SERVE_ATOL[kind],
                  f"{kind} artifact: {tuple(out.shape)}, max abs err {err:.3e} above "
                  f"{SERVE_ATOL[kind]}")
            want = 6 if kind == "crepe" and torch.device(device).type == "cuda" else 0
            check(convs == want, f"{kind} artifact: {convs} CREPE convolution launches a "
                                 f"call, expected {want}")
            extractors[kind] = dict(export_s=secs, bytes=n, err=err, shape=list(out.shape),
                                    crepe_convs=convs)
            path.unlink()
        del mods, direct
    return dict(train_s=train_s, train_counts=train_counts, trained=trained, export=str(export),
                export_s=export_s, artifact_bytes=artifact.stat().st_size, art_err=art_err,
                seed_err=seed_err, other_err=other_err, art_ms=art_ms, infer_ms=infer_ms,
                infer=infer, kernel_counts=kernel_counts, artifact_counts=artifact_counts,
                extractors=extractors,
                chunk_frames=chunk_frames,
                whisper_dims=f"{widths['whisper']['n_audio_state']} wide, "
                             f"{SERVE_WHISPER_LAYERS} layers",
                phase_s=time.perf_counter() - phase_t0)


def report_prep_flow(pf: dict, smi: str) -> None:
    c = pf["train_counts"]
    print(f"[prep-flow] trainer CLI on [prep]'s filelists, base width, batch {PREP_BATCH}: "
          f"{PREP_FLOW_STEPS} steps in {pf['train_s']:.2f} s (model build, data, checkpoint "
          f"included), snake launches {c['direct']} forward / {c['bwd']} backward | {smi}",
          flush=True)
    print(f"[prep-flow] export CLI with --artifact ({pf['chunk_frames']} frames, B1 through "
          f"svc::snake_alias): {pf['export_s']:.2f} s, {pf['artifact_bytes']} bytes; the "
          f"artifact ({pf['artifact_counts']['direct']} B1 launches a call) against the "
          f"kernel model on one chunk of [prep]'s features, same noise: max abs err "
          f"{pf['art_err']:.3e} (bound {CARD_VS_CPU_ATOL}); load_synthesis(seed 7) against the "
          f"program on seed 7's noise {pf['seed_err']:.3e}, seed 8 {pf['other_err']:.3e}; "
          f"per chunk, in turns: "
          f"artifact {spread(pf['art_ms'])}, svc_infer on a 1000-frame request "
          f"{spread(pf['infer_ms'])} | {smi}", flush=True)
    r = pf["infer"]
    print(f"[prep-flow] inference CLI from the exported checkpoint with [prep]'s features: "
          f"{r['frames']} frames, {r['chunks']} chunks, {1e3 * r['wall']:.2f} ms wall "
          f"(synthesis {1e3 * r['synthesis']:.2f}), snake launches {r['counts']['direct']} "
          f"({r['counts']['direct'] // r['chunks']} a chunk) | {smi}", flush=True)
    if pf["extractors"]:
        print(f"[prep-flow] extractor artifacts (whisper {pf['whisper_dims']}, a 32-layer "
              f"float32 artifact being about 2.5 GB; HuBERT and CREPE as [prep] loads them, "
              f"CREPE at {SERVE_CREPE_BATCH} frames) against their modules: " + "; ".join(
                  f"{k} export {v['export_s']:.2f} s, {v['bytes']} bytes, out {v['shape']}, "
                  f"max abs err {v['err']:.3e} (bound {SERVE_ATOL[k]}), CREPE convolution "
                  f"launches {v['crepe_convs']} a call"
                  for k, v in pf["extractors"].items()) + f" | {smi}", flush=True)
    print(f"[prep-flow] phase {pf['phase_s']:.1f} s", flush=True)


def _get(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def _post(url: str, form: dict) -> None:
    import urllib.parse
    import urllib.request

    data = urllib.parse.urlencode(form).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=30) as r:
        r.read()


def _await_job(url: str, name: str) -> tuple[str, float]:
    """Poll /log until job `name` reads done (returns the log and the wait);
    failed, or no end within WEBUI_POLL_S, fails the phase."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WEBUI_POLL_S:
        log = _get(url + "/log")
        if f"== {name} [done] ==" in log:
            return log, time.perf_counter() - t0
        check(f"== {name} [failed] ==" not in log, f"WebUI job {name} failed:\n{log[-3000:]}")
        time.sleep(0.2)
    check(False, f"WebUI job {name} did not end in {WEBUI_POLL_S} s")


def webui_phase(base_hp, root: Path, pr: dict, pf: dict, device="cuda",
                n_snakes: int = 91) -> dict:
    """The port's WebUI server on a free port, in a thread: GET / in both
    languages, then POST /export of [prep-flow]'s trainer checkpoint and
    POST /infer of a synthetic wave, from a work directory whose default
    checkpoint paths hold [prep]'s random-weight extractor checkpoints;
    each job polled on /log until it reads done."""
    import threading

    work = root / "webui"
    for default, kind in (("whisper_pretrain/large-v2.pt", "whisper"),
                          ("hubert_pretrain/hubert-soft-0d54a1f4.pt", "hubert"),
                          ("crepe/assets/full.pth", "crepe")):
        (work / default).parent.mkdir(parents=True, exist_ok=True)
        os.symlink(pr["ckpts"][kind]["path"], work / default)
    (work / "configs").mkdir()
    shutil.copy(pr["cfg"], work / "configs" / "base.json")
    save_wav(str(work / "test.wav"), synthetic_voice(WEBUI_WAVE_SECONDS, PREP_SR, seed=61),
             PREP_SR)
    server = cli_webui.make_server("127.0.0.1", 0, str(device))
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        pages = {lang: _get(f"{url}/?lang={lang}") for lang in ("en_US", "zh_CN")}
        check("Preprocessing-Training" in pages["en_US"] and "预处理-训练" in pages["zh_CN"]
              and "TPU" not in pages["en_US"], "WebUI pages lack their language's strings")
        reset_counts()
        _post(url + "/export", {"checkpoint": pf["trained"], "lang": "en_US"})
        _, export_s = _await_job(url, "export")
        check(Path("sovits5.0_export.pth").is_file(), "the export job wrote no checkpoint")
        _post(url + "/infer", {"config": "configs/base.json", "model": "sovits5.0_export.pth",
                               "wave": "test.wav", "spk": str(root / "data_staged" / "singer"
                                                              / "spk0.spk.npy"),
                               "shift": "2", "lang": "en_US"})
        log, infer_s = _await_job(url, "infer")
        counts = read_counts()
        sr, wav = wavfile.read("svc_out.wav")
        frames = min(2 * len(np.load("svc_tmp.ppg.npy")), 2 * len(np.load("svc_tmp.vec.npy")),
                     len(pipeline.load_csv_pitch("svc_tmp.pit.csv")))
        chunks = len(pipeline._chunk_plan(frames, 1000, 10))
        rms = float(np.sqrt(np.mean(np.square(wav / 32768.0))))
        check(sr == base_hp["data"]["sampling_rate"] and rms > 1e-3,
              f"the infer job's svc_out.wav: {sr} Hz, rms {rms}")
        check(counts["direct"] == n_snakes * chunks and counts["bwd"] == 0,
              f"the WebUI's jobs launched {counts} for {chunks} chunks")
    finally:
        os.chdir(cwd)
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return dict(export_s=export_s, infer_s=infer_s, counts=counts, chunks=chunks,
                samples=len(wav), rms=rms, page_bytes={k: len(v) for k, v in pages.items()})


def report_webui(wu: dict, smi: str) -> None:
    print(f"[webui] GET / en_US and zh_CN ({wu['page_bytes']} bytes); POST /export done in "
          f"{wu['export_s']:.2f} s, POST /infer of a {WEBUI_WAVE_SECONDS} s 44.1 kHz wave "
          f"(features extracted by the job, shift 2) done in {wu['infer_s']:.2f} s: "
          f"{wu['samples']} samples, rms {wu['rms']:.4f}, {wu['chunks']} chunks, snake "
          f"launches {wu['counts']['direct']} | {smi}", flush=True)


def tp_phase(widths: dict = AUDIO_IN_FULL, device="cuda", n_layer: int | None = None) -> dict:
    """sharded_ppg_fn in a one-rank process group (NCCL on the card, gloo on
    the CPU) against the plain WhisperEncoder on one 15 s window at the
    published width (the 24 layers the loader keeps of 32, seeded random
    weights), unmasked and with the key mask of a zero-padded window: equal
    to the bit, a one-rank all_reduce being a copy."""
    import torch.distributed as tdist

    check(not tdist.is_initialized(), "a process group is already up before [tp]")
    wd = widths["whisper"]
    n_layer = n_layer or wd["n_audio_layer"] - wd["n_audio_layer"] // 4
    dims = dict(n_mels=wd["n_mels"], n_ctx=wd["n_audio_ctx"], n_state=wd["n_audio_state"],
                n_head=wd["n_audio_head"], n_layer=n_layer)
    with torch.device("meta"):
        shape = whisper_mod.WhisperEncoder(**dims)
    model = whisper_mod.WhisperEncoder(**dims)
    model.load_state_dict(random_state_dict(shape, 71, device), strict=True)
    model = model.to(device).eval()
    voice = synthetic_voice(15.0, 16000, seed=72)
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    tdist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                             world_size=1, rank=0)
    try:
        with torch.inference_mode():
            mel = whisper_mod.log_mel_spectrogram(torch.from_numpy(voice[None]).to(device))
            plain_ms, plain = [], None
            for _ in range(3):
                sync(device)
                t0 = time.perf_counter()
                plain = model(mel)
                sync(device)
                plain_ms.append(1e3 * (time.perf_counter() - t0))
            # a zero-padded window, its padded keys masked
            n_frames = torch.tensor([2 * mel.shape[1] // 3], device=device)
            plain_masked = model(mel, n_frames)
        sharding.shard_whisper_params(model)
        run = sharding.sharded_ppg_fn(model)
        tp_ms, out = [], None
        for _ in range(3):
            sync(device)
            t0 = time.perf_counter()
            out = run(mel)
            sync(device)
            tp_ms.append(1e3 * (time.perf_counter() - t0))
        equal = torch.equal(out, plain)
        check(equal, f"one-rank sharded whisper against the plain encoder: max abs err "
                     f"{max_err(out.cpu(), plain.cpu()):.3e}, expected equal")
        masked = run(mel, n_frames)
        check(torch.equal(masked, plain_masked),
              f"one-rank sharded whisper with n_frames against the plain encoder: max abs "
              f"err {max_err(masked.cpu(), plain_masked.cpu()):.3e}, expected equal")
        backend_seen = tdist.get_backend()
    finally:
        tdist.destroy_process_group()
    return dict(dims=dims, shape=list(out.shape), plain_ms=plain_ms[1:], tp_ms=tp_ms[1:],
                backend=backend_seen, equal=equal)


def report_tp(tp: dict, smi: str) -> None:
    print(f"[tp] sharded_ppg_fn in a one-rank {tp['backend']} group against the plain "
          f"WhisperEncoder ({tp['dims']}), one 15 s window -> {tp['shape']}, unmasked and "
          f"with n_frames at 2/3 of the window: equal to the bit "
          f"{tp['equal']}; ms {[round(x, 2) for x in tp['tp_ms']]} against "
          f"{[round(x, 2) for x in tp['plain_ms']]} | {smi}", flush=True)


def resnet_phase(device="cuda", layers=(3, 4, 6, 3), frames: int = 250) -> dict:
    """ResNetSpeakerEncoder at the published widths (seeded random weights,
    BatchNorm statistics included), the card against the CPU on a [2,
    frames, 64] mel: the l2-normalised d-vector within RESNET_ATOL."""
    with torch.device("meta"):
        shape = spk_mod.ResNetSpeakerEncoder(layers=layers)
    sd = random_state_dict(shape, 81, device)
    mods = {}
    for d in (device, "cpu"):
        m = spk_mod.ResNetSpeakerEncoder(layers=layers)
        m.load_state_dict(sd, strict=True)
        mods[d] = m.to(d).eval()
    mel = torch.from_numpy(np.random.default_rng(82).standard_normal((2, frames, 64))
                           .astype(np.float32))
    out, ms = {}, {}
    with torch.inference_mode():
        for d, m in mods.items():
            for l2 in (True, False):
                sync(device)
                t0 = time.perf_counter()
                out[d, l2] = m(mel.to(d), l2_norm=l2).cpu()
                sync(device)
                ms[d, l2] = 1e3 * (time.perf_counter() - t0)
    err = max_err(out[device, True], out["cpu", True])
    raw = out["cpu", False]
    rel = float((out[device, False] - raw).abs().max() / raw.abs().max())
    norms = torch.linalg.vector_norm(out[device, True], dim=-1)
    check(out[device, True].shape == (2, 512) and err <= RESNET_ATOL,
          f"ResNetSpeakerEncoder card vs CPU: max abs err {err:.3e} above {RESNET_ATOL}")
    check(bool(torch.allclose(norms, torch.ones(2), atol=1e-5)), f"d-vector norms {norms}")
    return dict(err=err, rel=rel, ms={f"{d}{'' if l2 else '_raw'}": v for (d, l2), v in ms.items()},
                params=sum(v.numel() for v in sd.values()), layers=list(layers),
                shape=list(mel.shape))


def report_resnet(rs: dict, smi: str) -> None:
    print(f"[resnet-spk] ResNetSpeakerEncoder layers {rs['layers']}, 64 mels, "
          f"{rs['params']} values, card vs CPU on {rs['shape']}: d-vector max abs err "
          f"{rs['err']:.3e} (bound {RESNET_ATOL}), unnormalised output max rel err "
          f"{rs['rel']:.3e}; ms " + json.dumps({k: round(v, 2) for k, v in rs["ms"].items()})
          + f" | {smi}", flush=True)


FOLD_TURNS = 3     # ABBA turns of the three requests, weight norm against folded
MED_SHAPE = (16, 48000, 1)  # a batch of 1 s items at 48 kHz
MED_REL = 2e-5     # card vs CPU, each feature map and the scores, of its largest entry
MED_CALLS = 10
TRACE_RATIO = (0.5, 2.0)  # torch.profiler's B1 time over CUDA events', same launches


def chunks_of(reqs) -> int:
    return sum(len(pipeline._chunk_plan(len(r[1]), 1000, 10)) for r in reqs)


def fold_wn_phase(hp, model, reqs, wn_audio, device="cuda", n_snakes: int = 91) -> dict:
    """[fold-wn]: the seeded weight-norm checkpoint loaded into a model built
    with fold_wn=True (folded on the way in), svc_infer over the requests
    against the weight-norm model's waveforms, then both models' ms per chunk
    in ABBA turns and (on the card) one profiled chunk each."""
    with tempfile.TemporaryDirectory(prefix="svc_fold_") as d:
        path = os.path.join(d, "g.pth")
        torch.save({"model_g": model.state_dict()}, path)
        folded = pipeline.load_svc_model(
            path, pipeline.build_infer_model(hp, device=device, seed=1, fold_wn=True))
    left = [k for k in folded.state_dict() if k.endswith(("weight_g", "weight_v"))]
    check(not left, f"weight-norm parameters left after folding: {left[:3]}")
    run = dict(hp=hp, device=device)
    pipeline.svc_infer(folded, DummyRetrieval(), *reqs[-1], **run)  # warm-up
    sync(device)
    reset_counts()
    outs = [pipeline.svc_infer(folded, DummyRetrieval(), *r, **run) for r in reqs]
    sync(device)
    counts = read_counts()
    chunks = chunks_of(reqs)
    check(counts["direct"] == n_snakes * chunks and counts["bwd"] == 0,
          f"[fold-wn] {counts} snake launches for {chunks} chunks, expected {n_snakes} a chunk")
    err = max(float(np.abs(o - w).max()) for o, w in zip(outs, wn_audio))
    check(err <= CARD_VS_CPU_ATOL, f"folded against weight norm: max abs err {err}")

    def walk(m) -> float:
        t0 = time.perf_counter()
        for r in reqs:
            pipeline.svc_infer(m, DummyRetrieval(), *r, **run)
        sync(device)
        return 1e3 * (time.perf_counter() - t0) / chunks

    ms = {"weight_norm": [], "folded": []}
    for _ in range(FOLD_TURNS):
        for key, m in (("weight_norm", model), ("folded", folded), ("folded", folded),
                       ("weight_norm", model)):
            ms[key].append(walk(m))
    out = dict(counts=counts, err=err, ms=ms, chunks=chunks,
               pairs=sum(k.endswith("weight_g") for k in model.state_dict()))
    if torch.device(device).type == "cuda":
        out["profile"] = {key: profile(lambda m=m: pipeline.svc_infer(
            m, DummyRetrieval(), *reqs[-1], **run)) for key, m in
            (("weight_norm", model), ("folded", folded))}
    return out


def report_fold_wn(fw: dict, smi: str) -> None:
    med = {k: float(np.median(v)) for k, v in fw["ms"].items()}
    line = (f"[fold-wn] {fw['pairs']} weight-norm pairs folded once at load; "
            f"{fw['counts']['direct']} B1 launches in {fw['chunks']} chunks; waveform against "
            f"the weight-norm run max abs err {fw['err']:.3e} (tolerance {CARD_VS_CPU_ATOL}); "
            f"wall ms per chunk over {FOLD_TURNS} ABBA turns: weight norm "
            f"{spread(fw['ms']['weight_norm'])}, folded {spread(fw['ms']['folded'])}, "
            f"x{med['weight_norm'] / med['folded']:.3f}")
    for key, prof in fw.get("profile", {}).items():
        line += (f"; {key} one profiled chunk: wall {prof['wall_ms']:.2f} ms, device busy "
                 f"{prof['busy_ms']:.2f} ms, {sum(prof['counts'].values())} device ops "
                 f"(elementwise {prof['counts']['elementwise']}, reduction "
                 f"{prof['counts']['reduction']})")
    print(line + f" | {smi}", flush=True)


def device_trace_phase(hp, model, req, device="cuda") -> dict:
    """[device-trace]: utils/device_trace.py over one chunk of svc_infer: B1's
    device ms per launch (measure_device_ms), its launches and total in one
    trace, the chunk's kernels in all; then the chunk's B1 launches replayed
    on their captured inputs, timed by CUDA events and by the trace."""
    run = dict(hp=hp, device=device)

    def one_chunk():
        pipeline.svc_infer(model, DummyRetrieval(), *req, **run)

    captured = []
    orig = snake_cuda.snake_alias_cuda

    def capture(x, alpha, beta):
        captured.append((x.clone(), alpha.clone(), beta.clone()))
        return orig(x, alpha, beta)

    snake_cuda.snake_alias_cuda = capture
    try:
        one_chunk()
    finally:
        snake_cuda.snake_alias_cuda = orig
    sync(device)
    reset_counts()
    per_call = device_trace.measure_device_ms(one_chunk, "snake_alias")
    counts = read_counts()
    timer, on_card = StepTimer(window=1), torch.zeros(1, device=device)
    with tempfile.TemporaryDirectory(prefix="svc_trace_") as d:
        with trace(d):
            timer.start()
            one_chunk()
            timer.stop(on_card)  # waits for the card
        mean = device_trace.device_ms_per_call(d, "snake_alias")
        total = device_trace.device_total_ms(d, ("snake_alias",))
        chunk_total = device_trace.device_total_ms(d, ("",))
    check(per_call is not None and mean is not None and per_call > 0,
          f"no snake_alias kernel in the trace (per call {per_call}, mean {mean})")
    traced = round(total / mean)
    check(traced == counts["direct"] == len(captured),
          f"{traced} traced B1 kernels, {counts['direct']} launches, {len(captured)} captured")

    def replay(i=0):
        for x, a, b in captured:
            snake_cuda.snake_alias_cuda(x, a, b)

    events_ms = cuda_ms(replay, 5)
    traced_replay = device_trace.measure_device_total_ms(replay, ("snake_alias",))
    ratio = traced_replay / events_ms
    check(TRACE_RATIO[0] <= ratio <= TRACE_RATIO[1],
          f"the trace's B1 time {traced_replay:.4f} ms against CUDA events {events_ms:.4f} ms")
    return dict(counts=counts, per_call=per_call, mean=mean, total=total, traced=traced,
                chunk_total=chunk_total, wall_ms=1e3 * timer.mean, events_ms=events_ms,
                traced_replay=traced_replay, ratio=ratio)


def report_device_trace(dt: dict, smi: str) -> None:
    print(f"[device-trace] one {CHUNK_FRAMES}-frame chunk of svc_infer: measure_device_ms("
          f"'snake_alias') {1e3 * dt['per_call']:.2f} us per launch; in one trace "
          f"{dt['traced']} B1 kernels ({dt['counts']['direct']} launches counted), mean "
          f"{1e3 * dt['mean']:.2f} us, total {dt['total']:.4f} ms of the chunk's "
          f"{dt['chunk_total']:.3f} ms of kernels in {dt['wall_ms']:.2f} ms wall (StepTimer); "
          f"the same {dt['traced']} launches replayed on their captured inputs: CUDA events "
          f"{dt['events_ms']:.4f} ms, trace {dt['traced_replay']:.4f} ms (x{dt['ratio']:.3f}) "
          f"| {smi}", flush=True)


def med_phase(device="cuda", shape=MED_SHAPE) -> dict:
    """[med]: MelspecDiscriminator with seeded weights (BatchNorm statistics
    perturbed) in eval mode on `device` against the CPU on 0.2 x N(0, 1)
    audio: each feature map and the scores within MED_REL of their largest
    entry; ms per call and (on the card) its device time."""
    g = torch.Generator().manual_seed(91)
    cpu = MelspecDiscriminator()
    cpu.init_weights(g)
    with torch.no_grad():
        for block in cpu._convs:
            bn = block[1]
            for t, lo, hi in ((bn.weight, 0.5, 1.5), (bn.running_var, 0.5, 1.5),
                              (bn.bias, -0.1, 0.1), (bn.running_mean, -0.1, 0.1)):
                t.uniform_(lo, hi, generator=g)
    cpu.eval()
    card = MelspecDiscriminator().eval()
    card.load_state_dict(cpu.state_dict(), strict=True)
    card.to(device)
    x = 0.2 * torch.randn(shape, generator=g)
    x_dev = x.to(device)
    reset_counts()
    with torch.inference_mode():
        ((f_card, s_card),) = card(x_dev)
        sync(device)
        counts = read_counts()
        ((f_cpu, s_cpu),) = cpu(x)
        errs = [float((a.cpu() - b).abs().max() / b.abs().max())
                for a, b in zip(f_card + [s_card], f_cpu + [s_cpu])]
        check(s_card.shape == (shape[0],) and len(f_card) == 4
              and all(bool(torch.isfinite(f).all()) for f in f_card + [s_card]),
              f"[med] output shapes {[tuple(f.shape) for f in f_card]}, {tuple(s_card.shape)}")
        check(max(errs) <= MED_REL, f"[med] card vs CPU relative errors {errs}")
        sync(device)
        t0 = time.perf_counter()
        for _ in range(MED_CALLS):
            card(x_dev)
        sync(device)
        ms = 1e3 * (time.perf_counter() - t0) / MED_CALLS
        prof = profile(lambda: card(x_dev)) if torch.device(device).type == "cuda" else None
    return dict(errs=errs, ms=ms, counts=counts, shape=list(shape),
                fmap_shapes=[list(f.shape) for f in f_card], prof=prof)


def report_med(md: dict, smi: str) -> None:
    prof = md["prof"]
    print(f"[med] MelspecDiscriminator on {md['shape']}: feature maps {md['fmap_shapes']}, "
          f"card vs CPU max error over each map's largest entry "
          f"{[float(f'{e:.3e}') for e in md['errs']]} (bound {MED_REL}); "
          f"{md['ms']:.2f} ms per call over {MED_CALLS}"
          + (f", one profiled call: wall {prof['wall_ms']:.2f} ms, device busy "
             f"{prof['busy_ms']:.2f} ms, device ms by kind "
             + json.dumps({k: round(v, 3) for k, v in prof["kinds"].items() if v})
             if prof else "") + f" | {smi}", flush=True)


# ---------------------------------------------------------------- training health

# The 2100-step runs of tools/train_health.py at this workspace and config
# (an evaluation every 20 epochs; H100 80GB HBM3, 700 W) measured validation
# mel 0.7238 / 0.7134 / 0.6291 / 0.6161 at steps 133 / 273 / 413 / 553 with
# the float32 D (0.7201 / 0.7167 / 0.6325 / 0.6134 with the bf16 D): it has
# visibly fallen by step 413 (x0.869 of step 133's), barely by 273 (x0.986).
# Before step ~270 it is not monotone: this phase at 60 epochs, evaluated
# every 15, read 0.6901 / 0.7078 / 0.6879 / 0.6389 at steps 98 / 203 / 308 /
# 413 (x0.926). So the phase evaluates at the long runs' steps 133 / 273 /
# 413 / 553 (x0.851 and x0.852 there) and asks for x0.95 at most. Between
# consecutive evaluations the long runs' mel rose by 0.67% at most, and two
# runs (the f32 and the bf16 D, or one D in two runs) differ by 2.2% at
# most at one step: the resume's spread is 2.5%.
HEALTH_BATCH = 8          # the JAX package's 2100-step run (docs/TRAIN_RUN_r04.md)
HEALTH_EPOCHS = 80        # 560 steps at the default workspace's 7 batches an epoch
HEALTH_EVAL_EPOCHS = 20   # evaluations at epochs 20, 40, 60, 80
HEALTH_SAVE_EPOCHS = 20
HEALTH_MEL_RATIO = 0.95   # last validation mel over the first, at most
HEALTH_RESUME_SPREAD = 0.025  # validation after the resume over the one before it, at most 1 +


def train_health_phase(base_hp) -> dict:
    """The training-health run at `base_hp`'s widths on the card:
    make_synth_dataset's learnable workspace at its defaults, then the
    trainer CLI from that workspace at batch HEALTH_BATCH for HEALTH_EPOCHS
    epochs (a validation of the held-out utterances every
    HEALTH_EVAL_EPOCHS, one info line an epoch), then a resume from the
    newest checkpoint for one more epoch. Checks finite losses and no
    divergence, G's snake count of forward and backward launches a step and
    forward a validation utterance, the last validation mel at most
    HEALTH_MEL_RATIO times the first, the step and epoch counters and the
    AdamW and accumulation state continued by the resume, and validation
    after the resume within HEALTH_RESUME_SPREAD of the one before it."""
    device, epochs, eval_epochs = "cuda", HEALTH_EPOCHS, HEALTH_EVAL_EPOCHS
    n_snakes = sum(calls for _, calls in stage_shapes(config_from_dict(base_hp), 1, 1))
    root = Path(tempfile.mkdtemp(prefix="svc_train_health_"))
    phase_t0 = time.perf_counter()
    cwd = os.getcwd()
    try:
        ws = root / "ws"
        with contextlib.redirect_stdout(io.StringIO()):
            rows = make_synth_dataset.main(["--out", str(ws), "--device", device])
        sync(device)
        build_s = time.perf_counter() - phase_t0
        data_bytes = sum(p.stat().st_size for p in ws.rglob("*") if p.is_file())
        os.chdir(ws)  # the filelists hold paths relative to the workspace
        hp_dict = train_health.health_config(base_hp, HEALTH_BATCH, log=dict(
            eval_interval=eval_epochs, save_interval=min(HEALTH_SAVE_EPOCHS, epochs),
            keep_ckpts=2, num_audio=0))
        hp = config_from_dict(hp_dict)
        train_ds = SvcDataset(hp.data.training_files, hp.data)
        n_val = len(SvcDataset(hp.data.validation_files, hp.data))
        n_batches = BucketBatcher(train_ds, HEALTH_BATCH, boundaries_for(hp.data),
                                  seed=hp.train.seed).batches_per_epoch()
        check(len(train_ds) + n_val == len(rows) and n_val > 0 and n_batches > 0,
              f"workspace: {len(rows)} rows, {len(train_ds)} training and {n_val} validation "
              f"utterances, {n_batches} batches an epoch")
        hp_dict["log"]["info_interval"] = n_batches  # one info line an epoch
        cfg = root / "health.json"
        cfg.write_text(json.dumps(hp_dict))
        steps = epochs * n_batches
        accum = hp_dict["train"]["accum_step"]
        pth_dir = os.path.join("chkpt", "health")

        runs, text = {}, ""
        for run in ("train", "resume"):
            resume = run == "resume"
            latest = tckpt.latest_checkpoint(pth_dir, "health") if resume else None
            end = steps + n_batches if resume else steps
            argv = ["-c", str(cfg), "-n", "health", "--max-steps", str(end),
                    "--device", device] + (["-p", latest] if resume else [])
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            with loop_probes(device) as rec:
                t0 = time.perf_counter()
                out, div = train_health.run_trainer(argv, out=io.StringIO())
                sync(device)
                rec["wall_s"] = time.perf_counter() - t0
            counts = read_counts()
            text += out
            check(div is None and "NaN guard" not in out,
                  f"{run}: the NaN guard fired: {div}\n{out[-3000:]}")
            n_steps = n_batches if resume else steps
            n_evals = 1 if resume else epochs // eval_epochs
            train_fwd = counts["direct"] - rec["validate_fwd"]
            check(rec["batches"] == n_steps, f"{run}: {rec['batches']} batches, expected "
                                             f"{n_steps}\n{out[-3000:]}")
            check(train_fwd == n_snakes * n_steps and counts["bwd"] == n_snakes * n_steps,
                  f"{run}: {train_fwd} forward / {counts['bwd']} backward snake launches in "
                  f"{n_steps} steps, expected {n_snakes} each a step")
            check(rec["validate_utts"] == n_val * n_evals
                  and rec["validate_fwd"] == n_snakes * n_val * n_evals
                  and rec["validate_bwd"] == 0,
                  f"{run}: {rec['validate_utts']} validation utterances launched "
                  f"{rec['validate_fwd']} forward / {rec['validate_bwd']} backward snakes, "
                  f"expected {n_evals} evaluations of {n_val}")
            check(counts["strips"] == counts["mma"] == counts["amp"] == 0,
                  f"{run}: an alternative kernel was launched: {counts}")
            saved = tckpt.load(tckpt.latest_checkpoint(pth_dir, "health"))
            check((saved["step"], saved["epoch"]) == (end, epochs),
                  f"{run}: newest checkpoint at step {saved['step']}, epoch {saved['epoch']}; "
                  f"expected {end}, {epochs}")
            rec.update(counts=counts, train_fwd=train_fwd, steps=n_steps, evals=n_evals,
                       checkpoint=latest, saved=saved,
                       peak_bytes=torch.cuda.max_memory_allocated())
            runs[run] = rec

        traj = train_health.trajectory(hp.log.log_dir, "health", text)
        val, info = traj["validation"], traj["train"]
        n_evals = runs["train"]["evals"]
        want = [((e - 1) * n_batches, e) for e in range(eval_epochs, epochs + 1, eval_epochs)]
        check([(v["step"], v["epoch"]) for v in val] == want + [(steps, epochs)],
              f"validations at (step, epoch) {[(v['step'], v['epoch']) for v in val]}, "
              f"expected {want + [(steps, epochs)]}")
        check([(r["step"], r["epoch"]) for r in info]
              == [(e * n_batches, e) for e in range(1, epochs + 1)] + [(steps + n_batches, epochs)],
              f"info lines at (step, epoch) {[(r['step'], r['epoch']) for r in info]}")
        check(all(np.isfinite(x) for r in info for k, x in r.items() if k != "epoch")
              and all(np.isfinite(v["mel"]) for v in val), "non-finite losses or validation mel")
        first, last = val[0]["mel"], val[n_evals - 1]["mel"]
        check(last <= HEALTH_MEL_RATIO * first,
              f"validation mel {last:.4f} at step {val[n_evals - 1]['step']} is above "
              f"{HEALTH_MEL_RATIO} x the first {first:.4f}: {[round(v['mel'], 4) for v in val]}")

        # the resume: counters, optimizer state and validation carried on
        before, after = runs["resume"]["checkpoint"], runs["resume"]["saved"]
        check(traj["resumed"] == [dict(path=before, epoch=epochs, step=steps)],
              f"resume: {traj['resumed']}, expected {before} at epoch {epochs}, step {steps}")
        held = runs["train"]["saved"]

        def adam_step(payload, key):
            return {float(s["step"]) for s in payload[key]["state"].values()}

        mini = held["optim_g"]["mini_step"] + n_batches
        check(adam_step(after, "optim_d") == {s + n_batches for s in adam_step(held, "optim_d")}
              and adam_step(after, "optim_g")
              == {s + mini // accum for s in adam_step(held, "optim_g")}
              and after["optim_g"]["mini_step"] == mini % accum,
              f"resume: AdamW steps D {adam_step(held, 'optim_d')} -> "
              f"{adam_step(after, 'optim_d')}, G {adam_step(held, 'optim_g')} -> "
              f"{adam_step(after, 'optim_g')}, mini_step {held['optim_g']['mini_step']} -> "
              f"{after['optim_g']['mini_step']} after {n_batches} steps")
        check(val[-1]["mel"] <= (1 + HEALTH_RESUME_SPREAD) * val[n_evals - 1]["mel"],
              f"validation after the resume {val[-1]['mel']:.4f} is above the one before it "
              f"{val[n_evals - 1]['mel']:.4f} by more than {HEALTH_RESUME_SPREAD:.0%}")
        for rec in runs.values():
            del rec["saved"]
        return dict(runs=runs, val=val, info=info, n_batches=n_batches, n_val=n_val,
                    steps=steps, rows=len(rows), build_s=build_s, data_bytes=data_bytes,
                    device=device,
                    route=native_loader.route(), phase_s=time.perf_counter() - phase_t0)
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)


def report_train_health(th: dict, smi: str) -> None:
    tr, rs = th["runs"]["train"], th["runs"]["resume"]
    print(f"[train-health] workspace (make_synth_dataset, spectrograms on {th['device']}): "
          f"{th['rows']} utterances, {th['data_bytes'] / 1e6:.1f} MB in {th['build_s']:.2f} s; "
          f"{th['n_batches']} batches of {HEALTH_BATCH} an epoch, {th['n_val']} held out; "
          f"loader route {th['route']} | {smi}", flush=True)
    first, last, resumed = (th["val"][i]["mel"] for i in (0, tr["evals"] - 1, -1))
    print("[train-health] validation mel (step, epoch, mel): " + json.dumps(
        [(v["step"], v["epoch"], round(v["mel"], 4)) for v in th["val"]])
          + f"; last of the run over the first {last / first:.4f} (at most "
          f"{HEALTH_MEL_RATIO}); after the resume over before it {resumed / last:.4f} (at "
          f"most {1 + HEALTH_RESUME_SPREAD}) | {smi}", flush=True)
    for r in th["info"]:
        print(f"[train-health] step {r['step']} epoch {r['epoch']}: g {r['loss_g']:.4f} "
              f"mel {r['loss_m']:.4f} d {r['loss_d']:.4f}", flush=True)
    ms = sorted(1e3 / r["steps_per_s"] for r in th["info"])
    print(f"[train-health] wall ms per loop step, each epoch's (the writer's 1 / steps_per_s, "
          f"one info line an epoch): median {ms[len(ms) // 2]:.2f} ({ms[0]:.2f}-{ms[-1]:.2f}, "
          f"n {len(ms)}) | {smi}", flush=True)
    for run, rec in th["runs"].items():
        print(f"[train-health] {run}: {rec['steps']} steps and {rec['evals']} evaluations in "
              f"{rec['wall_s']:.2f} s ({rec['steps'] / rec['wall_s']:.3f} steps/s of wall, "
              f"model build, validation and checkpoints included); peak device memory "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB; snake launches fwd {rec['train_fwd']} bwd "
              f"{rec['counts']['bwd']}, validation fwd {rec['validate_fwd']} | {smi}", flush=True)
    print(f"[train-health] the resume continued at step {th['steps']}, epoch "
          f"{th['val'][-1]['epoch']} with the AdamW and accumulation state; the phase took "
          f"{th['phase_s']:.1f} s | {smi}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    resolve_device("cuda")  # TF32 off: the plain versions' convolutions run in float32
    t0 = time.perf_counter()
    sources = cuda_build.all_sources()
    compare = all(p.exists() for p in (*PREV_SOURCES, PREV_DIR / "snake_alias.cuh"))
    libs = cuda_build.build(*sources, *(PREV_SOURCES if compare else ()))
    for load in (snake_cuda._library, snake_cuda._library_bwd, snake_cuda._library_strips,
                 snake_cuda._library_mma, amp_cuda._library, viterbi_cuda._library,
                 crepe_conv_cuda._library):
        load()
    prev = load_prev()
    check(len(sources) == 7, f"{len(sources)} kernel sources, expected 7")
    print(f"[build] {', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.2f} s"
          + (f" (with the earlier mma and amp_iter from {PREV_DIR.name}/)" if prev else
             "; no build/prev_kernels/: no comparison with earlier kernels"), flush=True)

    trellis = trellis_phase()
    report_trellis(trellis, smi)
    crepe_conv = crepe_conv_phase()
    report_crepe_conv(crepe_conv, smi)

    hp = config_from_dict(BASE_MODEL_CONFIG)
    stages = stage_shapes(hp, 1, CHUNK_FRAMES)
    rows = []
    for i, (shape, _) in enumerate(stages):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_kernel(shape, dtype, seed=i))
    for i, shape in enumerate(ODD_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_kernel(shape, dtype, seed=100 + i))
    for r in rows:
        print("[kernel] " + json.dumps(r), flush=True)
    per_chunk, bound_by = per_call_sum(rows, stages)
    n_calls = sum(calls for _, calls in stages)
    print(f"[kernel] per 1020-frame chunk, f32, {n_calls} calls: {json.dumps(per_chunk)}",
          flush=True)

    # the backward kernel at a training step's shapes and the JAX test shapes
    seg_frames = hp.data.segment_size // hp.data.hop_length
    train_stages = stage_shapes(hp, hp.train.batch_size, seg_frames)
    bwd_rows = []
    for i, shape in enumerate([s for s, _ in train_stages] + list(BWD_ODD_SHAPES)):
        for dtype in (torch.float32, torch.bfloat16):
            bwd_rows.append(check_bwd_kernel(shape, dtype, seed=200 + i))
    for r in bwd_rows:
        print("[kernel-bwd] " + json.dumps(r), flush=True)
    per_step, bwd_bound_by = per_call_sum(bwd_rows, train_stages)
    n_train_calls = sum(calls for _, calls in train_stages)
    print(f"[kernel-bwd] per training step (batch {hp.train.batch_size}, {seg_frames}-frame "
          f"segments), f32, {n_train_calls} calls: {json.dumps(per_step)}", flush=True)
    # the forward kernel at the same training shapes
    fwd_train_rows = []
    for i, (shape, _) in enumerate(train_stages):
        for dtype in (torch.float32, torch.bfloat16):
            fwd_train_rows.append(check_kernel(shape, dtype, seed=300 + i))
    for r in fwd_train_rows:
        print("[kernel-train] " + json.dumps(r), flush=True)
    fwd_per_step, fwd_step_bound_by = per_call_sum(fwd_train_rows, train_stages)
    print(f"[kernel-train] forward per training step, f32, {n_train_calls} calls: "
          f"{json.dumps(fwd_per_step)}; backward {json.dumps(per_step)}", flush=True)
    # the forward kernel at validation's shapes: one utterance padded to the
    # dataset's longest
    val_frames = MAX_SEGMENTS * seg_frames
    val_stages = stage_shapes(hp, 1, val_frames)
    val_rows = []
    for i, (shape, _) in enumerate(val_stages):
        for dtype in (torch.float32, torch.bfloat16):
            val_rows.append(check_kernel(shape, dtype, seed=350 + i))
    for r in val_rows:
        print("[kernel-validate] " + json.dumps(r), flush=True)
    fwd_per_val, fwd_val_bound_by = per_call_sum(val_rows, val_stages)
    print(f"[kernel-validate] forward per validation utterance ({val_frames} frames), f32, "
          f"{n_calls} calls: {json.dumps(fwd_per_val)}", flush=True)

    # the corners of the work plan, and large arguments, forward and backward
    corners = [(shape, False, False) for shape in PLAN_ODD_SHAPES + BWD_ODD_SHAPES]
    corners += [((2, 16, 1024), False, True), ((16, 160, 125), False, True)]
    corners += [(shape, True, False) for shape in LARGE_ARG_SHAPES]
    for i, (shape, large, misaligned) in enumerate(corners):
        for dtype in (torch.float32, torch.bfloat16):
            r = check_corner(shape, dtype, seed=700 + i, large=large, misaligned=misaligned)
            print("[kernel-corner] " + json.dumps(r), flush=True)
    print(f"[kernel-corner] {2 * len(corners)} cases within the tolerances", flush=True)

    alt = alt_kernel_phase(hp, stages, prev)

    # requests at full base width on the card
    model = pipeline.build_infer_model(hp, device="cuda", seed=0)
    run = dict(hp=hp, device="cuda")
    reqs = [features(hp, frames, seed=i) for i, frames in enumerate(REQUEST_FRAMES)]
    pipeline.svc_infer(model, DummyRetrieval(), *reqs[-1], **run)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    total_chunks, total_audio_s, total_wall_s = 0, 0.0, 0.0
    req_audio = []
    for frames, (spk, pit, ppg, vec) in zip(REQUEST_FRAMES, reqs):
        t0 = time.perf_counter()
        audio = pipeline.svc_infer(model, DummyRetrieval(), spk, pit, ppg, vec, **run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        req_audio.append(audio)
        chunks = len(pipeline._chunk_plan(frames, 1000, 10))
        audio_s = frames * hp.data.hop_length / hp.data.sampling_rate
        rms = float(np.sqrt(np.mean(np.square(audio))))
        check(audio.shape == (frames * hp.data.hop_length,), f"output shape {audio.shape}")
        check(bool(np.isfinite(audio).all()), "non-finite samples")
        check(rms > 1e-3, f"silent output (rms {rms})")
        total_chunks += chunks
        total_audio_s += audio_s
        total_wall_s += wall
        print(f"[request] {frames} frames ({audio_s:.2f} s audio, {chunks} chunks): "
              f"{wall * 1e3:.2f} ms wall, realtime x{audio_s / wall:.2f}, rms {rms:.4f}",
              flush=True)
    counts_default = counts = read_counts()
    launches, infer_bwd = counts["direct"], counts["bwd"]
    check(launches == 91 * total_chunks,
          f"{launches} snake launches for {total_chunks} chunks, expected 91 per chunk")
    check(infer_bwd == 0, f"{infer_bwd} backward snake launches during inference")
    check(counts["strips"] == counts["mma"] == counts["amp"] == 0,
          f"the default configuration launched an alternative kernel: {counts}")
    print(f"[requests] {total_chunks} chunks, snake launches {launches} "
          f"(91 per chunk), realtime x{total_audio_s / total_wall_s:.2f} overall", flush=True)

    # where one chunk's device time goes (the 2 s request, one chunk)
    prof = profile(lambda: pipeline.svc_infer(model, DummyRetrieval(), *reqs[-1], **run))
    print(prof["table"], flush=True)
    print(f"[profile] 200-frame request: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['busy_ms']:.2f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), "
          f"profiler on; device ms by kind "
          + json.dumps({k: round(v, 3) for k, v in prof["kinds"].items()}), flush=True)

    # the 2 s request on the card and on the CPU, same weights, features, noise
    short = dict(hp=hp, out_chunk=200)
    card = pipeline.svc_infer(model, DummyRetrieval(), *reqs[-1], device="cuda", **short)
    cpu_model = pipeline.build_infer_model(hp, device="cpu", seed=0)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    cpu = pipeline.svc_infer(cpu_model, DummyRetrieval(), *reqs[-1], device="cpu", **short)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(card - cpu).max())
    print(f"[card-vs-cpu] 200 frames: max abs err {err:.3e} (tolerance {CARD_VS_CPU_ATOL}), "
          f"cpu {cpu_s:.2f} s", flush=True)
    check(err <= CARD_VS_CPU_ATOL, f"card vs CPU max abs err {err}")

    # weight norm folded once at load, on the same seeded checkpoint and
    # features; B1's device time from the trace; the 48 kHz mel discriminator
    fw = fold_wn_phase(hp, model, reqs, req_audio)
    report_fold_wn(fw, smi)
    dt = device_trace_phase(hp, model, reqs[-1])
    report_device_trace(dt, smi)
    md = med_phase()
    report_med(md, smi)

    # the three alternative configurations of the same weights
    alt_runs = alt_config_phase(hp, model, cpu_model, reqs[-1], cpu)
    del model, cpu_model

    # training steps at full base width on the card
    reset_counts()
    tr = train_phase(hp)
    counts = read_counts()
    train_fwd, train_bwd = counts["direct"], counts["bwd"]
    n_steps = TIMED_STEPS + 2  # warm-up, timed, profiled
    check(train_fwd == 91 * n_steps and train_bwd == 91 * n_steps,
          f"{train_fwd} forward / {train_bwd} backward snake launches in {n_steps} steps")
    check(counts["strips"] == counts["mma"] == counts["amp"] == 0,
          f"the training step launched an alternative kernel: {counts}")
    ms_step = float(np.mean(tr["step_ms"]))
    utt_s = hp.train.batch_size / (ms_step / 1e3)
    print(f"[train] {TIMED_STEPS} timed steps, batch {hp.train.batch_size} x {TRAIN_FRAMES} "
          f"frames: {ms_step:.2f} ms per step (steps {[round(t, 2) for t in tr['step_ms']]}), "
          f"{utt_s:.2f} utterances/s, peak device memory "
          f"{tr['peak_bytes'] / 2**30:.2f} GiB; snake launches fwd {train_fwd} bwd {train_bwd} "
          f"in {n_steps} steps", flush=True)
    prof = tr["profile"]
    print(prof["table"], flush=True)
    check(prof["counts"]["snake_fwd"] == 91 and prof["counts"]["snake_bwd"] == 91,
          f"profiled step: {prof['counts']['snake_fwd']} forward and "
          f"{prof['counts']['snake_bwd']} backward snake kernels, expected 91 each")
    print(f"[train-profile] one step: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['busy_ms']:.2f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), "
          f"profiler on; device ms by kind "
          + json.dumps({k: round(v, 3) for k, v in prof["kinds"].items()})
          + "; kernels by kind " + json.dumps(prof["counts"]), flush=True)

    # the training step's losses and gradients on the card and on the CPU
    cmp = train_card_vs_cpu(hp, tr["g_state"].model, tr["d_state"].model)
    rel = [r for r, _ in cmp["grad_rel"]]
    within = float(np.mean(np.array(rel) <= TRAIN_GRAD_REL_L2))
    median = float(np.median(rel))
    worst_loss = max(cmp["loss_rel"].values())
    worst_term = max(cmp["term_rel"].values())

    def top(pairs, n):
        return [(float(f"{r:.3e}"), name) for r, name in pairs[:n]]

    print(f"[train-card-vs-cpu] {CHECK_BATCH} x {CHECK_FRAMES} frames, frozen noise, the CPU "
          f"taking the card's ReLU/leaky-ReLU/abs branches ({cmp['flips']} of {cmp['kinks']} "
          f"inputs differed): loss rel err "
          + json.dumps({k: float(f"{v:.3e}") for k, v in cmp["loss_rel"].items()})
          + f"; grad rel L2 over {len(rel)} parameters: median {median:.3e}, "
          f"{100 * within:.2f}% within {TRAIN_GRAD_REL_L2}, worst {top(cmp['grad_rel'], 6)}; "
          f"d term / d audio rel L2 "
          + json.dumps({k: float(f"{v:.3e}") for k, v in cmp["term_rel"].items()})
          + f"; G's VJP of one d audio, worst of {len(cmp['vjp_rel'])} "
          f"{top(cmp['vjp_rel'], 3)}; conv_k.bias (zero in exact arithmetic) against "
          f"conv_q.bias {top(cmp['zero_rel'], 2)}; cpu {cmp['cpu_s']:.2f} s", flush=True)
    check(worst_loss <= TRAIN_LOSS_RTOL, f"training loss terms card vs CPU: {cmp['loss_rel']}")
    check(cmp["vjp_rel"][0][0] <= TRAIN_VJP_REL_L2,
          f"G's backward card vs CPU: {top(cmp['vjp_rel'], 5)}")
    check(worst_term <= TRAIN_GRAD_REL_L2,
          f"d loss term / d audio card vs CPU: {cmp['term_rel']}")
    check(rel[0] <= TRAIN_GRAD_REL_L2,
          f"training gradients card vs CPU: {100 * within:.2f}% within "
          f"{TRAIN_GRAD_REL_L2}, worst {top(cmp['grad_rel'], 5)}")
    check(cmp["zero_rel"][0][0] <= TRAIN_GRAD_REL_L2,
          f"conv_k.bias gradients not near zero: {top(cmp['zero_rel'], 3)}")

    # the training loop around the step: data, prefetch, checkpoints,
    # validation, the NaN guard
    lp = train_loop_phase(hp)
    report_train_loop(hp, lp, tr["step_ms"], smi)
    loop_run = lp["runs"]["epoch"]

    # audio in: the CLI from a wave file, the extractors at full width
    ai = audio_in_phase(BASE_MODEL_CONFIG)
    report_audio_in(ai, smi)
    audio_in = {k: ai["plain"]["counts"][k] + ai["blended"]["counts"][k]
                for k in ai["plain"]["counts"]}

    # the rest of inference: --bf16, fast_edges, every F0 engine, the VAD
    # post filter, merge and eva
    ex = infer_extras_phase(BASE_MODEL_CONFIG, smi)
    b1_bf16, b1_bf16_by = per_call_sum(rows, stages, dtype="bfloat16")
    print(f"[infer-extras] B1 at bf16, a 1020-frame chunk's five stage shapes (held to its "
          f"plain version in [kernel] within {BF16_TOL}): {b1_bf16['ms']:.3f} ms per chunk, "
          f"bound {b1_bf16['bound_ms']:.3f} ms ({b1_bf16_by}), plain "
          f"{b1_bf16['plain_ms']:.2f} ms; f32 {per_chunk['ms']:.3f} ms, bound "
          f"{per_chunk['bound_ms']:.3f} ms | {smi}", flush=True)
    bf16_req = ex["reqs"]["bf16"]

    # streaming: B1 at the window's stage shapes, StreamingSvc on features,
    # then audio in and out through the streaming extractors
    stream_stages = stage_shapes(hp, 1, STREAM_BLOCK + STREAM_CONTEXT)
    stream_rows = [check_kernel(shape, torch.float32, seed=800 + i)
                   for i, (shape, _) in enumerate(stream_stages)]
    for r in stream_rows:
        print("[kernel-stream] " + json.dumps(r), flush=True)
    per_block, stream_bound_by = per_call_sum(stream_rows, stream_stages)
    padded_stages = [(shape, calls) for shape, calls in stream_stages if shape[-1] % 128]
    per_block_padded, padded_bound_by = per_call_sum(stream_rows, padded_stages)
    print(f"[kernel-stream] per {STREAM_BLOCK + STREAM_CONTEXT}-frame streaming window, f32, "
          f"{n_calls} calls: {json.dumps(per_block)}; the {sum(c for _, c in padded_stages)} "
          f"calls whose T is no multiple of 128: {json.dumps(per_block_padded)} | {smi}",
          flush=True)
    st = stream_phase(BASE_MODEL_CONFIG)
    report_stream(st, per_block, smi)
    sa = stream_audio_phase(BASE_MODEL_CONFIG)
    report_stream_audio(sa, smi)

    # training with the bf16 discriminator, and through a one-rank process group
    bd = train_bf16d_phase(BASE_MODEL_CONFIG)
    report_train_bf16d(bd, tr["step_ms"], smi)
    dd = train_ddp_phase(BASE_MODEL_CONFIG)
    report_train_ddp(dd, smi)
    ddp_counts = dd["runs"]["ddp"]["counts"]

    # making a voice model through the port's entry points: the preprocessing
    # CLI, the trainer CLI, the export CLI and its torch.export artifacts, the
    # inference CLI, the WebUI's jobs; then whisper's tensor-parallel forward
    # and the ResNet d-vector
    flow_root = Path(tempfile.mkdtemp(prefix="svc_prep_"))
    try:
        pr = prep_phase(BASE_MODEL_CONFIG, flow_root)
        report_prep(pr, smi)
        with snake_dtypes(key=tile_key) as tiles:
            pf = prep_flow_phase(BASE_MODEL_CONFIG, flow_root, pr)
            report_prep_flow(pf, smi)
            wu = webui_phase(BASE_MODEL_CONFIG, flow_root, pr, pf)
            report_webui(wu, smi)
        flow_tiles = dict(tiles)
    finally:
        shutil.rmtree(flow_root, ignore_errors=True)
    tp = tp_phase()
    report_tp(tp, smi)
    report_resnet(resnet_phase(), smi)

    # the training-health run: the learnable synthetic workspace, the trainer
    # CLI at base width, batch 8, for 80 epochs, validation falling, a resume
    th = train_health_phase(BASE_MODEL_CONFIG)
    report_train_health(th, smi)
    health = {k: sum(r["counts"][k] for r in th["runs"].values())
              for k in th["runs"]["train"]["counts"]}
    health_val = {k: sum(r[f"validate_{k}"] for r in th["runs"].values()) for k in ("fwd", "bwd")}
    flow = {"prep_train": pf["train_counts"], "prep_artifact_check": pf["kernel_counts"],
            "prep_artifact": pf["artifact_counts"], "train_health": health,
            "prep_infer": pf["infer"]["counts"], "webui": wu["counts"],
            "fold_wn": fw["counts"], "device_trace": dt["counts"], "med": md["counts"]}

    kernels = [{
        "name": "snake_alias", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows + fwd_train_rows + val_rows
                           + stream_rows if r["dtype"] == "float32"),
        "ms": per_chunk["ms"], "plain_ms": per_chunk["plain_ms"],
        "bound_ms": per_chunk["bound_ms"], "bound_by": bound_by, "library_ms": None,
        "trace_ms_per_call": dt["per_call"], "trace_ms_per_chunk": dt["total"],
        "per": f"one {CHUNK_FRAMES}-frame chunk at base width, float32, {n_calls} calls",
        "launches_by_path": {"svc_infer": launches, "train_step": train_fwd,
                             "train_loop": loop_run["train_fwd"],
                             "validate": loop_run["validate_fwd"],
                             "audio_in": audio_in["direct"],
                             "bf16_request": bf16_req["counts"]["direct"],
                             "f32_request": ex["reqs"]["f32"]["counts"]["direct"],
                             "fast_edges": ex["fast_counts"]["direct"],
                             "merged_model": ex["merge_counts"]["direct"],
                             "stream": st["counts"]["direct"],
                             "stream_audio": sa["counts"]["direct"],
                             "train_bf16d": bd["counts"]["direct"],
                             "train_ddp": ddp_counts["direct"],
                             "train_health_validate": health_val["fwd"]}
                            | {k: v["direct"] for k, v in flow.items()},
        "bf16": b1_bf16 | {
            "bound_by": b1_bf16_by, "launches": bf16_req["dtypes"].get("bfloat16", 0),
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16"),
            "per": f"one {CHUNK_FRAMES}-frame chunk at base width, bfloat16, {n_calls} calls "
                   f"(launches: the --bf16 request's {bf16_req['chunks']} chunks)"},
        "train_step": fwd_per_step | {
            "bound_by": fwd_step_bound_by,
            "per": f"one training step at base width (batch {hp.train.batch_size}, "
                   f"{seg_frames}-frame segments), float32, {n_train_calls} calls"},
        "validate": fwd_per_val | {
            "bound_by": fwd_val_bound_by,
            "per": f"one validation utterance at base width ({val_frames} frames), float32, "
                   f"{n_calls} calls"},
        "stream": per_block | {
            "bound_by": stream_bound_by, "launches": st["counts"]["direct"],
            "per": f"one streaming block ({STREAM_BLOCK} + {STREAM_CONTEXT} frames) at base "
                   f"width, float32, {n_calls} calls"},
    }, {
        "name": "snake_alias_bwd", "route": "cuda", "source": SOURCE_BWD,
        "replaces": REPLACES_BWD, "launches": train_bwd,
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows if r["dtype"] == "float32"),
        "ms": per_step["ms"], "plain_ms": per_step["plain_ms"],
        "bound_ms": per_step["bound_ms"], "bound_by": bwd_bound_by, "library_ms": None,
        "per": f"one training step at base width (batch {hp.train.batch_size}, "
               f"{seg_frames}-frame segments), float32, {n_train_calls} calls",
        "launches_by_path": {"svc_infer": infer_bwd, "train_step": train_bwd,
                             "train_loop": loop_run["counts"]["bwd"],
                             "validate": loop_run["validate_bwd"],
                             "audio_in": audio_in["bwd"],
                             "stream": st["counts"]["bwd"], "stream_audio": sa["counts"]["bwd"],
                             "train_bf16d": bd["counts"]["bwd"],
                             "train_ddp": ddp_counts["bwd"],
                             "train_health_validate": health_val["bwd"]}
                            | {k: v["bwd"] for k, v in flow.items()},
    }, {
        # the same Hopper kernel, at the shapes the JAX package sends to
        # _kernel_padded: the streaming window's stages whose T is no
        # multiple of 128
        "name": "snake_alias (padded)", "route": "cuda", "source": SOURCE,
        "replaces": PADDED_REPLACES, "launches": st["by_tile"].get("padded", 0),
        "max_abs_err": max(r["max_abs_err"] for r in stream_rows
                           if r["shape"][-1] % 128),
        "ms": per_block_padded["ms"], "plain_ms": per_block_padded["plain_ms"],
        "bound_ms": per_block_padded["bound_ms"], "bound_by": padded_bound_by,
        "library_ms": None,
        "per": f"one streaming block's {sum(c for _, c in padded_stages)} calls with T "
               f"no multiple of 128, base width, float32",
        "launches_by_path": {"stream": st["by_tile"].get("padded", 0),
                             "stream_tiled": st["by_tile"].get("tiled", 0),
                             "prep_flow_and_webui": flow_tiles.get("padded", 0),
                             "prep_flow_and_webui_tiled": flow_tiles.get("tiled", 0)},
    }]
    chunk = f"one {CHUNK_FRAMES}-frame chunk at base width, float32"
    fused_run = alt_runs["fused"]
    kernels.append({
        "name": "amp_iter", "route": "cuda", "source": SOURCE_AMP, "replaces": REPLACES_AMP,
        "launches": fused_run["counts"]["amp"],
        "max_abs_err": max(r["max_abs_err"] for r in alt["amp_rows"]
                           if r["dtype"] == "float32"),
        "ms": alt["amp"]["ms"], "plain_ms": alt["amp"]["plain_ms"],
        "bound_ms": alt["amp"]["bound_ms"], "bound_by": alt["amp_bound_by"],
        "library_ms": None, "unfused_ms": alt["amp"]["unfused_ms"],
        "tc_bound_ms": alt["amp"]["tc_bound_ms"], "prev_ms": alt["amp"].get("prev_ms"),
        "per": f"{chunk}, {alt['amp_calls']} calls (amp_fused_iter=True)",
        "launches_by_path": {"svc_infer": counts_default["amp"],
                             "svc_infer_fused": fused_run["counts"]["amp"],
                             "train_step": counts["amp"],
                             "train_loop": loop_run["counts"]["amp"],
                             "audio_in": audio_in["amp"]}
                            | {k: v["amp"] for k, v in flow.items()},
    })
    for variant, source, replaces in (("strips", SOURCE_STRIPS, REPLACES_STRIPS),
                                      ("mma", SOURCE_MMA, REPLACES_MMA)):
        run, total = alt_runs[variant], alt[variant]
        kernels.append({
            "name": f"snake_alias_{variant}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": run["counts"][variant],
            "max_abs_err": max(r["max_abs_err"] for r in alt[f"{variant}_rows"]
                               if r["dtype"] == "float32"),
            "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": alt[f"{variant}_bound_by"], "library_ms": None,
            "direct_ms": total["direct_ms"], "prev_ms": total.get("prev_ms"),
            "per": f"{chunk}, {alt[f'{variant}_calls']} calls "
                   f"(snake_variant=\"{variant}\")",
            "launches_by_path": {"svc_infer": counts_default[variant],
                                 f"svc_infer_{variant}": run["counts"][variant],
                                 "train_step": counts[variant],
                                 "train_loop": loop_run["counts"][variant],
                                 "audio_in": audio_in[variant]}
                                | {k: v[variant] for k, v in flow.items()},
        })
    kernels.append({
        "name": "viterbi_trellis", "route": "cuda", "source": SOURCE_TRELLIS,
        "replaces": REPLACES_TRELLIS, "launches": sa["trellis_launches"],
        "max_abs_err": trellis["value_err"], "value_bins_differ": trellis["value_bins"],
        "pointer_rows_differ": trellis["ptr_rows"],
        "ms": trellis["kernel_ms"], "plain_ms": trellis["plain_card_ms"],
        "bound_ms": trellis["bound_ms"],
        "bound_by": "latency: the launch, then per frame a 9-level first-index maximum and "
                    "one exchange across the warps, at this card's measured latencies",
        "library_ms": None,
        "card_path_ms": trellis["card_push_ms"],
        "ms_2000_frames": trellis["kernel_2000_ms"],
        "per": f"one push's {TRELLIS_PUSH} frames from a carried value, float32",
        "launches_by_path": {"stream_audio": sa["trellis_launches"]},
    })
    kernels.append({
        "name": "crepe_conv", "route": "cuda", "source": SOURCE_CREPE_CONV,
        "replaces": REPLACES_CREPE_CONV, "launches": sa["crepe_conv_launches"],
        "max_abs_err": crepe_conv["prob_err"],
        "ms": crepe_conv["kernel_ms_64"], "plain_ms": crepe_conv["plain_ms_64"],
        "bound_ms": crepe_conv["bound_ms_64"],
        "bound_by": "float32 FMAs at 67 TFLOP/s (bytes at 3.35 TB/s where larger)",
        "library_ms": crepe_conv["library_ms_64"],
        "ms_512_rows": crepe_conv["kernel_ms_512"], "plain_ms_512_rows": crepe_conv["plain_ms_512"],
        "bound_ms_512_rows": crepe_conv["bound_ms_512"],
        "library_ms_512_rows": crepe_conv["library_ms_512"],
        "per": "CREPE full's six layers at the stream's 64 rows, float32 (the probabilities' "
               "largest difference from the plain version as max_abs_err)",
        "launches_by_path": {"stream_audio": sa["crepe_conv_launches"]},
    })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
