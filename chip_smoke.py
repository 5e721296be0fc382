"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:
  env      torch, CUDA, nvcc, the card's name and power limit, and whether
           the host figure stages' matplotlib, PIL and sklearn are installed
           (read from package metadata; nothing imports them);
  build    compiles the kernels of medvae_tpu_torch/ops/csrc, one nvcc per
           source, all started together (timed), with ptxas's registers and
           spills for the Hopper backward's kernels and whether ptxas
           serialized any wgmma;
  kernel   the flash-attention forward kernel B1 against its plain PyTorch
           version on the card (bf16: max abs 4e-3 and relative L2 1e-2 at
           (32,3136,512), (2,784,1024), (2,1000,512), (3,1000,256); fp32: max abs
           and relative L2 1e-4 at (2,3136,512)), each line naming the instance
           that took it (wgmma_tma for bf16 c % 128 == 0 up to 512, mma_sync for
           the rest, fp32_fma), a bitwise repeat at (32,3136,512), and its time
           beside its bound, the plain version's and
           scaled_dot_product_attention's; then B1's lse (max abs 1e-4) and the
           backward (B2: dK, dV; B3: dQ) through `flash_bwd` against its plain
           versions at the same shapes (bf16: relative L2 1e-2 and max abs 15 %
           of the gradient's std; fp32: 1e-4 for both), each line naming the
           instance that took it (wgmma_tma: the Hopper instance's two passes,
           every bf16 shape; fp32_fma: kernels B2 then B3), a bitwise repeat
           at (32,3136,512), the autograd Function against autograd through
           the plain forward, and the times at (32,3136,512) bf16 beside the
           bounds (10 b n² c operations; bytes with and without the P and dS
           planes) and the plain versions'; the library yardsticks are the
           efficient-attention forward asked for its lse (B1 with lse) and the
           backward of scaled_dot_product_attention, which computes dq, dk and
           dv at once as `flash_bwd` does;
  serve    the full-width 224² flagship DisentangledConditionalVAE (random
           weights from a seed, bf16) behind InferenceEngine(buckets 1/8/32):
           reconstruct/encode/decode/sample requests with mixed modalities,
           the kernel's launches per chunk, then reconstruct latency per
           bucket (median, spread and every sample);
  parity   the same weights in fp32: card against CPU, and card bf16
           against card fp32;
  http     one /reconstruct, /encode and /sample through cli/serve.py;
  profile  device time by kernel and by layer for one bs-32 reconstruct
           (torch.profiler), and the card's idle share during it;
  gn kernel the fused GroupNorm+SiLU kernels B6 (forward) and B7 (backward)
           against their plain versions at GN_SHAPES, each line naming the
           instances that took them (resident, cluster or streamed; B6: fp32
           relative L2 1e-5 and max abs 1e-4, bf16 one rounding apart
           elementwise and relative L2 2e-3; B7: fp32 relative L2 1e-4 for
           dx, dgamma, dbeta; bf16 dx by GRAD_REL and GRAD_ABS_OF_STD and
           within GN_DX_ROUNDINGS of one rounding of the plain version's fp32
           dx, dgamma/dbeta relative L2 1e-3), a bitwise repeat of B6 and B7 at
           GN_REPEAT, the autograd Function against autograd through the
           plain forward, and their times at every distinct bf16 shape of
           cvae28_train and flagship_fused_gn (found by a forward on the meta
           device) beside bound, the streamed instance (the first design's) and
           F.group_norm + F.silu (two calls; for B7 their autograd backward),
           the plain version at GN_TIMED, and each path's per-step sums;
  flagship_fused_gn  the flagship's bucket-32 reconstruct with
           MEDVAE_FUSED_GN=1 (50 B6 launches a chunk, derived from the model,
           beside B1's 5) and then off on the same engine, and after the train
           phase 2 warmup and 5 timed train steps with it on (50/50 B6/B7 and
           5/5 B1/flash_bwd a step): ms, img/s, peak memory, a profile;
  train    the full-width 224² flagship's training step (fp32 params, bf16
           compute, the full-scale experiment's loss with fp32 LPIPS and
           CLIP-ViT towers from fixed seeds, adamw lr 1e-4 constant, clip 1.0,
           bench.py's synthetic bs-32 batch, augment on, switch off): 2 warmup
           and 10 timed steps, each with its loss terms, grad norm and B1 and
           flash_bwd launches (5/5 or it raises), then ms per step, img/s, peak memory
           and a torch.profiler breakdown of one step;
  train_parity  one fp32 step of the same model on the card against the CPU
           (bs 2, same weights, batch and noise, augment off: loss relative
           1e-4, gradient global relative L2 1e-3, and relative L2 ATTN_GRAD_REL
           for each q/k/v/proj_out weight of the five 3136x512 attention
           blocks), with two controls beside it (the card's step repeated as
           it was, and with the noise nudged by 1e-6), and the bf16 loss
           against the fp32 one on the card (relative 5e-2);
  cvae28_train  bench.py's default step through medvae_tpu_torch.bench's
           builder: the 28² ConditionalVAE, fp32 params, bf16 compute, bs 4096,
           adam 1e-3, with MEDVAE_FUSED_GN=1 (B6/B7 at each of the 28
           GroupNorm+SiLU sites, derived from the model): 2 warmup and 10 timed
           steps with their losses and launches, ms, img/s, flops per step and
           mfu, peak memory, a profile; then the same with the switch off;
  cvae28_parity  one fp32 step of it at bs 8 with the switch on, card against
           CPU (loss relative 1e-4, gradient global relative L2 1e-3, each
           GroupNorm weight and bias gradient relative L2 1e-3 beside a repeat),
           and bf16 against fp32 (5e-2);
  cvae28_serve  the CVAE behind InferenceEngine(buckets 1/8/32) with the switch
           on: requests by modality name and index, B6 launches a chunk,
           latency per bucket, card fp32 against CPU fp32 (1e-3);
  attn kernel  the whole-sequence attention kernels B4 (forward) and B5
           (backward) against their plain versions at ATTN_SHAPES in bf16 and
           fp32 (fp32: B4 max abs and relative L2 1e-5, B5 1e-4; bf16: B4 one
           rounding apart elementwise and relative L2 2e-3, B5 by GRAD_REL and
           GRAD_ABS_OF_STD), each line naming the instance that took it
           (wgmma_tma for bf16 with c % 64 == 0 and n <= 256, fma for the
           rest), a bitwise repeat of B4 and of B5, the FusedAttention
           Function against autograd through the plain forward, and their
           times at (64, 256, 1024) bf16 beside two bounds (the Hopper
           instance's arithmetic, each product with P or dS three times on
           the tensor cores; and every such product once at the fp32 rate),
           the FMA instance's time at the same shape, plain,
           scaled_dot_product_attention in fp32 (and its backward) and
           reference_attention;
  base128_train  the chest_base_vae experiment's step at 128² (the BaseVAE of
           configs/model/base_vae.yaml, 251 M params, attention at 16² x 1024;
           fp32 params, bf16 compute, adamw 2e-4, wd 1e-4, cosine, clip 1.0,
           `vae` loss, augment on) at bs 64 on the synthetic ChestMNIST feed:
           2 warmup and 10 timed steps with 7/7 B4/B5 launches each, ms,
           img/s, peak memory, a profile;
  base128_serve  that model (seeded weights, bf16) behind InferenceEngine
           (buckets 1/8/32): B4 launches a chunk (7 a reconstruct, 3 an encode,
           4 a decode or sample), latency per bucket, card fp32 vs CPU fp32
           (1e-3) and bf16 vs fp32 (5e-2);
  base128_parity  one fp32 step at bs 2, card against CPU: loss 1e-4, gradient
           1e-3, each of the 28 attention q/k/v/proj_out weight gradients
           ATTN_GRAD_REL, beside a repeat of the card's step;
  trainer128  `medvae_tpu_torch.cli.train` on experiment=chest_base_vae at
           128² (1 epoch of 8 batches, validation and test), the same command
           with one more epoch and resume=true ("Resuming at optimizer step
           8"), then 2 epochs uninterrupted: the resumed params against those,
           launches counted (7 B4 a train step or eval batch, 7 B5 a train
           step, 7 + 4 for epoch 0's media grids), the media PNGs decoded to
           their sizes, and the final checkpoint served (7 B4). Its work
           directory is build/chip_smoke_work, removed after eval128;
  eval128  on the uninterrupted run's final snapshot, cli/generate.py
           (16 samples, 2 seeds, interpolation of 4), cli/evaluate.py (4
           batches, --fid, --mig where sklearn is installed) and
           cli/analyze.py (32 a modality): B4 launches a CLI as derived (7 a
           reconstruct batch, 4 a decode, 3 an encode), the files, every
           number finite; then analyze on two classes (the first 16
           validation images of chestmnist and of pneumoniamnist written as
           MedMNIST npz files, one batch) on the card and on the CPU, the
           centroid distance and silhouette within 1e-2 of each other;
  gan224_train  the full-width 224² GAN experiment (experiment=multi_modal_cvae:
           the concat ConditionalVAE, hidden 256, 906.3 M params, the PatchGAN
           and LPIPS in fp32, adamw betas (0.5, 0.999), cosine) with its gate
           at step 1 and MEDVAE_FUSED_GN=1, bs 24, fp32 params, bf16 compute,
           augment on: 2 warmup and 5 timed steps with the loss terms and
           d_weight, 50/50 B6/B7 a step (derived from the model); d_weight and
           d_loss 0 at step 0 and > 0 after; ms, img/s, peak memory, a
           profile (convolution split by type: bf16 the VAE's, fp32 the
           towers' and D's) and the towers' and D's time alone. A batch that
           does not fit halves, with the reason printed;
  gan_parity  one fp32 GAN step past the gate of the quick GAN model at 28²
           (no dropout), bs 4, card against CPU: each loss term relative 1e-4,
           the generator's and D's gradients relative L2 1e-3, D's BatchNorm
           statistics 1e-5, beside a repeat of the card's step and a 1e-6
           nudge of the noise;
  gan_trainer  cli/train.py on experiment=multi_modal_cvae_gan_quick with
           MEDVAE_FUSED_GN=1 (1 epoch of 6 batches, the gate at step 3), then
           resume +1 epoch, then 2 epochs uninterrupted: B6/B7 launches, the
           adversarial terms past the gate, the resumed generator's and D's
           params and statistics against the uninterrupted ones (RESUME_BAR,
           beside the first run's), epoch 0's media PNGs, and the final
           checkpoint served;
  eval224  the full-width flagship (the serve phase's seeded weights) saved
           as a port checkpoint beside a config.yaml of
           experiment=disentangled_multi_modal_cvae_full with two of its five
           datasets: generate (--per_modality, 8 samples, interpolation of 4),
           evaluate (2 batches of 32, --fid), analyze (32 a modality) and
           evaluate again with MEDVAE_FUSED_GN=1 on the card: B1 launches a
           CLI as derived (5 a reconstruct, 3 a decode, 2 an encode), B6 in
           the switched run (50 a reconstruct batch, the decoder's sites a
           decode), the files, every number finite, the seconds and peak
           memory of each CLI, analyze's PCA alone, and eval_batch (bs 32)
           and a bs-8 conditional sample alone (host clock, synchronized),
           switch off and on. It runs after train_parity.
  dispatch  what binding B1, B4 and B6 as torch.library ops (the serving
           forwards `medvae::flash_attention`, `medvae::attention_fwd`,
           `medvae::gn_swish_fwd`) costs: host µs a call of each op against
           its raw wrapper at a tiny shape (200 calls, then a synchronize; in
           turns raw, op, op, raw), and both at the main path's shape (events);
  import224  the serve phase's seeded flagship written as a reference
           Lightning `.ckpt` (reference names with `model.`, per-head
           `modality_decoders`, 1x1-conv projectors, loss and discriminator
           keys, epoch and global_step) and imported by cli/import_ckpt.py
           with --experiment disentangled_multi_modal_cvae_full: every
           tensor equal bit for bit, the skipped keys counted, and the
           imported checkpoint's bucket-32 reconstruct (bf16, the card) equal
           bit for bit to the serve phase's engine's, with 5 B1 launches;
           the import's seconds and the .ckpt's bytes;
  export224  the imported flagship exported by serve/export.py (torch.export;
           reconstruct at bs 32, sample at bs 8), with MEDVAE_FUSED_GN=0 and
           then 1, loaded on the card: 5 / 3 medvae.flash_attention nodes and
           B1 launches, with the switch on 50 / 29 medvae.gn_swish_fwd nodes
           and B6 launches; each output against the eager engine's (bit for
           bit expected, bf16 bars of TOLERANCE; the line says which held);
           export and load seconds, artifact bytes, and the artifact's ms a
           bucket-32 reconstruct beside the engine's (host clock, median of 5);
  export128  trainer128's final snapshot (the 128² BaseVAE that eval128
           reads) exported at bs 8 and run from the artifact: 7 / 4
           medvae.attention_fwd nodes and B4 launches, outputs against the
           engine with the same bars; it runs before build/chip_smoke_work
           is removed;
  options_parity  one fp32 step card against CPU (same weights, batch and
           noise; `vae` loss) of the 28² ConditionalVAE with `film` and with
           `inject`, and of the quick flagship with linear attention: every
           loss term relative 1e-4, the global gradient relative L2 1e-3,
           beside a repeat of the card's step (grad_rel_l2_card_repeat);
  fast28   the Trainer on experiment=multi_modal_cvae_quick at full width
           (28², bs 16, 640 steps an epoch) with MEDVAE_FUSED_GN=1, four
           runs from one seed: (a) host feeder, (b) the device-cached
           feeder, (cpre) cached with fused chunks (replays of one captured
           CUDA graph), each the epoch's first FAST28_PREFIX (50) steps; (c) as (cpre), one
           epoch. Each: seconds, img/s, peak memory; (a), (b), (c): the
           card's idle share over 30 more steps; gates: (b) and (cpre) bit
           for bit (params, EMA, moments, validation), B6/B7 launches =
           sites x steps by the wrappers' counts (and sites x batches in
           validation) and, in each profiled window, (c)'s 30 replays
           included, by the trace's kernel events; the native gather used
           in (a), the card's epoch-0 order the CPU's;
  fast128  experiment=chest_base_vae at 128²: batch_size=auto (the probe's
           trajectory), remat=auto at bs 64 (each probed peak, the
           decision), the rungs block and full against no remat (ms, peak,
           gradients within REMAT_GRAD_REL, bit for bit or not),
           accumulate_grad_batches 2 against 1, and a fused chunk of 8 steps
           against 8 per-step calls: bit for bit, 7 + 7 B4/B5 launches a
           step, by the wrappers' counts and, in a window of 8 replays and
           one of 8 per-step calls, by the trace's kernel events; ms a step
           and idle share both ways.
  bench_serve  medvae_tpu_torch.cli.bench_serve's cells at --reps 3
           --min-seconds 0 on flagship224 (the serve phase's engine and
           weights) and quick28 (multi_modal_cvae_quick, MEDVAE_FUSED_GN=1):
           ms and img/s of every method and bucket, single-image p50/p99,
           MicroBatcher req/s and p50/p99; B1 and B6 launches as derived from
           the calls; the bucket-32 reconstruct within 10 % of serve's;
  towers_bf16  the train phase's flagship step with loss.tower_dtype=
           bfloat16: step 0's loss terms against the fp32 towers' (relative),
           2 warmup and 5 timed steps (5/5 B1/flash_bwd each), ms and peak
           memory beside train's, and the towers alone fp32 against bf16
           (torch.profiler's device ms, event ms);
  sweep    `cli/train.py -m` on multi_modal_cvae_quick with the switch on,
           three jobs of 8 steps swept on training.optimizer.lr (the third
           repeats the first): summary.json, each job's B6/B7 launches, the
           repeated job bit for bit;
  resilient  cli/train_resilient.py's supervise on the quick experiment (2
           epochs of 12 steps, `last` every 4), its first child killed with
           SIGKILL once `last` exists, relaunched once with +resume=true: the
           resumed child's own B6/B7 launches (read from the child) sites x
           the steps left after `last` (and the test batches), the final
           params bit for bit an uninterrupted run's;
  bench_modes  BENCH_MODE=generate and pipeline (cached and BENCH_CACHE=0)
           with the switch on: their JSON lines and B6/B7 launches;
  surface  (this and the next two phases run in a fresh child process,
           `chip_smoke.py --public-child`) the kernels through the
           package's public names:
           ops.fused_attention_or_none at (32,3136,512) (B1; B2/B3 under
           autograd) and (64,256,1024) (B4; B5) in bf16, forward, backward
           and a serving call against the kernels' plain versions
           (TOLERANCE and GRAD_REL / GRAD_ABS_OF_STD for B1-B3, one rounding
           and ATTN_FWD_BAR for B4); nn.GroupNormSwish at (32,256,224,224)
           bf16 with MEDVAE_FUSED_GN=1 (B6, B7) against the module with the
           switch off, relative L2 SURFACE_GN_BAR; each with its launches
           by wrapper and by trace; utils.gradient_penalty through
           multi_modal_cvae.yaml's PatchGAN at bs 24 x 224² fp32 against the
           same call on the CPU (PENALTY_BAR), a second card call bit for bit
           the first (the penalty and D's gradients); every subpackage
           imported in a fresh process without JAX or medvae_tpu;
  walkthroughs  both examples/*_walkthrough_torch.py at their shipped flags
           on the card with MEDVAE_FUSED_GN=1: B6/B7 launches (> 0) by
           wrapper and by trace, every figure decoded, every number finite;
  notebooks  the code cells of both notebooks/*_torch.ipynb in order on the
           card (MEDVAE_NB_QUICK=1, MEDVAE_FUSED_GN=1): figures, losses
           finite and falling, B6/B7 launches;
  demo     (not in the default run, which it would take too near its
           time limit; alone: python -c "import chip_smoke as c;
           c.phase_build(); c.phase_demo()") scripts/demo_torch.sh
           training.max_epochs=1 into a temporary DEMO_LOG_DIR: each
           stage's output;
  options  the quick experiment with debug.nan_checks (bit for bit off/on,
           FloatingPointError on chip_smoke's NaN batch), debug.profile (the
           trace's B6/B7 kernel events as derived), data.normalize=false (a
           fused epoch, finite losses) and SGD fused against per-step calls,
           bit for bit;
  dp_flagship  a one-rank NCCL group (every collective an identity): the
           train phase's flagship at bs 32 with FLAGSHIP_LOSS, 3 steps of
           build_shard_map_train_step against 3 of build_train_step from the
           same weights, batch and generator seed, and 3 more plain steps
           (the card's repeat): params and metrics bit for bit both times,
           5/5 B1/flash_bwd a step each, ms a step both ways;
  dp2_card, tp2_card  one phase (phase_two_ranks), whose parts overlap:
           one torchrun takes every parity run below while another takes the
           cli runs in turn and this process the one-rank sides; each prints
           its row.
  dp2_card  two ranks sharing the card (torchrun, gloo), MEDVAE_FUSED_GN=1:
           cli/train.py on multi_modal_cvae_quick with mesh.data=2 (global
           bs 16), 2 epochs of 1 batch with validation and test, then a
           second run resumed from the first's step-1 snapshot: the resumed
           final params bit for bit the uninterrupted ones; each rank's
           B6/B7 launches sites x (steps + eval batches) and sites x steps.
           Then the parity runs (PARITY: SGD at lr 1e-2, dropout off, the
           noise pinned per global row) of the quick CVAE (global bs 16) and
           the quick flagship (global bs 32, its separation and contrastive
           losses on the gathered latent), PARITY_STEPS of the Trainer's
           own step on two ranks against one rank on the same global batch:
           parity_gate (the same initial params, the updates' relative L2,
           each step's loss and grad_norm, against TOLERANCE's bf16 relative
           bar) and sites x steps B6/B7 on each rank; each rank's seconds
           and peak memory;
  tp2_card  experiment=chest_base_vae at 128² with mesh.model=2 on two ranks
           sharing the card, global bs 8, MEDVAE_FUSED_GN=1: the parity run
           of PARITY_STEPS against one rank (parity_gate), 7/7 B4/B5 and
           sites/sites B6/B7 a step on each rank, and each rank's bytes of
           params and moments beside the one-rank run's;
  dryrun_card  entry.dryrun_multichip(1) on the card with the switch on:
           its four `ok` lines (DP×TP needs 4 ranks), the fused chunk captured
           with its collectives and bit for bit the per-step calls, B6/B7
           launches as dryrun_sites derives them; then dryrun_multichip(4)
           on the card (four spawned ranks sharing it under gloo): its five
           `ok` lines;
  serve_mesh  the flagship engine over a mesh of the one card against one
           without: a bucket-32 reconstruct bit for bit, 5 B1 launches each.
The repeat of train_parity, cvae28_parity and base128_parity is gated at
0.0: the fused chunks rest on it. Then the card line from nvidia-smi, the
kernels line, and {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import ctypes
import dataclasses
import gc
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

try:
    from medvae_tpu_torch import bench
    from medvae_tpu_torch.analysis.latent import pca
    from medvae_tpu_torch.cli import analyze as cli_analyze
    from medvae_tpu_torch.cli import evaluate as cli_evaluate
    from medvae_tpu_torch.cli import generate as cli_generate
    from medvae_tpu_torch.cli import import_ckpt as cli_import_ckpt
    from medvae_tpu_torch.cli import train as cli_train
    from medvae_tpu_torch.cli.common import load_checkpoint, load_model, save_checkpoint
    from medvae_tpu_torch.cli.serve import _b64_to_np, _np_to_b64, serve
    from medvae_tpu_torch.config.compose import compose, save_yaml
    from medvae_tpu_torch.config.models import CVAE_BENCH, FLAGSHIP, build_model, init_weights
    from medvae_tpu_torch.config.instantiate import instantiate
    from medvae_tpu_torch.core.rng import fold_in
    from medvae_tpu_torch.data.medmnist import MedMNISTDataModule
    from medvae_tpu_torch.data.modalities import MODALITY_NAMES
    from medvae_tpu_torch import native
    from medvae_tpu_torch.data.pipeline import DeviceCachedFeeder, DeviceFeeder
    from medvae_tpu_torch.nn import blocks
    from medvae_tpu_torch.nn.blocks import AttnBlock, ResnetBlock
    from medvae_tpu_torch.nn.discriminator import build_discriminator
    from medvae_tpu_torch.nn.encoder_decoder import Decoder, Encoder, set_remat
    from medvae_tpu_torch.ops import _build
    from medvae_tpu_torch.ops import attention as at
    from medvae_tpu_torch.ops import flash_attention as fa
    from medvae_tpu_torch.ops import groupnorm_swish as gs
    from medvae_tpu_torch.ops.attention import reference_attention
    from medvae_tpu_torch.serve.engine import InferenceEngine, sample_batch
    from medvae_tpu_torch.serve.export import GRAPHS, export_model, load_exported, medvae_ops
    from medvae_tpu_torch.utils.visualization import read_png_size
    from medvae_tpu_torch.train.optim import build_optimizer, discriminator_optimizer
    from medvae_tpu_torch.train.state import create_train_state
    from medvae_tpu_torch.train.multistep import build_chunk_runner
    from medvae_tpu_torch.train.step import (build_gan_grads, build_loss_and_grads, build_train_step,
                                             make_frozen, make_gan_loss)
    from medvae_tpu_torch.train.trainer import Trainer
    from medvae_tpu_torch.core import mesh as core_mesh
    from medvae_tpu_torch import entry as entry_mod
    from medvae_tpu_torch.entry import dryrun_multichip
    from medvae_tpu_torch.parallel import shard_map_step
    from medvae_tpu_torch import nn as port_nn
    from medvae_tpu_torch import ops as port_ops
    from medvae_tpu_torch import utils as port_utils
    from medvae_tpu_torch.core import threefry
    from medvae_tpu_torch.core.precision import configure_backends
except ImportError as e:
    print(f"chip_smoke: the medvae_tpu_torch package is missing here ({e})", file=sys.stderr)
    raise SystemExit(3)

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, same data sheet
H100_BYTES_PER_S = 3.35e12
REPS = 20
# kernel vs plain version: (max abs, relative L2) by dtype. The bf16 bar is
# ~4x the max error measured at the served shape and a fraction of a typical
# output there (|o| ~ 0.03 at n = 3136), so a kernel that drops a key tile
# fails it.
TOLERANCE = {torch.bfloat16: (4e-3, 1e-2), torch.float32: (1e-4, 1e-4)}
# backward kernels vs plain versions, scaled to each gradient: relative L2,
# and max abs as a fraction of the gradient's std (bf16) or absolute (fp32)
GRAD_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
GRAD_ABS_OF_STD = {torch.bfloat16: 0.15, torch.float32: None}
LSE_TOLERANCE = 1e-4
KERNEL_SOURCES = ("flash_fwd", "flash_bwd", "groupnorm_swish", "attention")
CHECK_SHAPES = [((32, 3136, 512), torch.bfloat16), ((2, 784, 1024), torch.bfloat16),
                ((2, 1000, 512), torch.bfloat16), ((3, 1000, 256), torch.bfloat16),
                ((2, 3136, 512), torch.float32)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reset_launches() -> None:
    fa.reset_launches()
    gs.reset_launches()
    at.reset_launches()


def launches() -> dict:
    """Every kernel's count: B1-B3, B6 and B7, then B4 and B5."""
    return {**fa.launches, **gs.launches, **at.launches}


def want_launches(**counts) -> dict:
    """Every kernel's count zero, but for `counts`."""
    return {**dict.fromkeys(launches(), 0), **counts}


@contextlib.contextmanager
def fused_gn(on: bool = True):
    """MEDVAE_FUSED_GN set for the block (the gate reads it at every call);
    every other phase runs with it off, as the port's default is."""
    before = os.environ.get("MEDVAE_FUSED_GN")
    os.environ["MEDVAE_FUSED_GN"] = "1" if on else "0"
    try:
        yield
    finally:
        os.environ["MEDVAE_FUSED_GN"] = before if before is not None else "0"


def gn_swish_sites(module) -> int:
    """GroupNorm+SiLU sites one forward of `module` runs, each one B6 launch
    with the switch on (and one B7 in the backward): two in every ResnetBlock
    and each codec's norm_out. AttnBlock's GroupNorm has no SiLU."""
    mods = list(module.modules())
    return (2 * sum(isinstance(m, ResnetBlock) for m in mods)
            + sum(isinstance(m, (Encoder, Decoder)) for m in mods))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median over `reps` single calls, each timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_samples_ms(fn, reps: int) -> list:
    """Wall times, in call order, of a call that ends on the host (results
    in numpy)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def torch_rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def phase_env() -> str:
    smi = nvidia_smi_line()
    nvcc = subprocess.run(
        [_build.find_nvcc(), "--version"], capture_output=True, text=True, timeout=60,
        check=True,
    ).stdout.strip().splitlines()[-1]
    import yaml  # config/compose.py reads configs/ with it (trainer128)

    emit({
        "phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvcc": nvcc, "pyyaml": yaml.__version__, "gpu": smi,
        "device_count": torch.cuda.device_count(),
        # the host figure stages' packages (evaluate's t-SNE, analyze's
        # figure, --mig); the card's path needs none of them
        "host_packages": {name: host_package(name) for name in HOST_PACKAGES},
    })
    return smi


HOST_PACKAGES = {"matplotlib": "matplotlib", "PIL": "pillow", "sklearn": "scikit-learn"}


def host_package(module: str):
    """The installed version of a host plotting package, or None: read from
    its distribution's metadata, so that nothing here imports it."""
    import importlib.metadata
    import importlib.util

    if importlib.util.find_spec(module) is None:
        return None
    try:
        return importlib.metadata.version(HOST_PACKAGES[module])
    except importlib.metadata.PackageNotFoundError:
        return "present"


# the Hopper backward's kernels, by a fragment of their mangled names
BWD_KERNELS = {"flash_planes_kernel": "flash_planes_kernel (pass a)",
               "flash_grads_kernelILi256E": "flash_grads_kernel<256> (pass b)",
               "flash_grads_kernelILi128E": "flash_grads_kernel<128> (pass b)",
               "flash_grads_kernelILi64E": "flash_grads_kernel<64> (pass b)"}


def phase_build() -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:  # one nvcc per source, in parallel
        paths = list(pool.map(_build.build, KERNEL_SOURCES))
    for name in KERNEL_SOURCES:
        _build.load(name)
    seconds = round(time.perf_counter() - t0, 3)
    stats = _build.ptxas_stats("flash_bwd")
    emit({"phase": "build", "seconds": seconds, "libraries": [p.name for p in paths],
          "flash_bwd_ptxas": {label: next((s for k, s in stats.items() if frag in k), None)
                              for frag, label in BWD_KERNELS.items()},
          # ptxas warning C7520: a wgmma serialized
          "wgmma_serialized": [name for name in KERNEL_SOURCES if "C7520" in _build.report(name)]})


def phase_kernel() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, n, c, dtype):
        return [torch.randn((b, n, c), generator=gen, device="cuda").to(dtype) for _ in range(3)]

    errs = {}
    for shape, dtype in CHECK_SHAPES:
        tol_abs, tol_rel = TOLERANCE[dtype]
        q, k, v = qkv(*shape, dtype)
        got = fa.flash_attention(q, k, v)
        want = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = torch_rel_l2(got, want)
        finite = bool(torch.isfinite(got).all())
        emit({"phase": "kernel", "shape": list(shape), "dtype": str(dtype).split(".")[-1],
              "instance": fa.flash_fwd_instance(shape[2], dtype),
              "max_abs_err": err, "rel_l2": rel, "tolerance_max_abs": tol_abs,
              "tolerance_rel_l2": tol_rel, "output_std": want.float().std().item(),
              "finite": finite})
        if not finite or not err <= tol_abs or not rel <= tol_rel:
            raise AssertionError(
                f"flash_fwd {shape} {dtype}: max abs err {err} (bar {tol_abs}), "
                f"relative L2 {rel} (bar {tol_rel})"
            )
        errs[(shape, dtype)] = err
        del q, k, v, got, want

    b, n, c = 32, 3136, 512
    q, k, v = qkv(b, n, c, torch.bfloat16)
    # B1 repeats bit for bit (B2/B3 read its lse; resume on the card is exact)
    runs = [fa.flash_attention_fwd(q, k, v) for _ in range(2)]
    repeat = all(torch.equal(x, y) for x, y in zip(*runs))
    emit({"phase": "kernel", "shape": [b, n, c], "repeat_bitwise": repeat})
    if not repeat:
        raise AssertionError("flash_fwd (32, 3136, 512): two launches differ")
    del runs
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, want_lse=False))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v))
    q4, k4, v4 = (t[:, None] for t in (q, k, v))
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)
    )
    flops = 4.0 * b * n * n * c
    nbytes = 4.0 * b * n * c * q.element_size()  # q, k, v read once, o written once
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    row = {
        "shape": [b, n, c], "dtype": "bfloat16", "instance": fa.flash_fwd_instance(c, q.dtype),
        "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes, "tflops_per_s": flops / ms / 1e9,
        "max_abs_err": errs[((b, n, c), torch.bfloat16)],
    }
    emit({"phase": "kernel", **row})

    # the routing question: the 784x1024 blocks stay on reference_attention by
    # the TPU's gate; time both paths there on the card
    q, k, v = qkv(32, 784, 1024, torch.bfloat16)
    emit({"phase": "kernel", "gate_shape": [32, 784, 1024], "dtype": "bfloat16",
          "instance": fa.flash_fwd_instance(1024, q.dtype),
          "kernel_ms": cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, want_lse=False)),
          "reference_attention_ms": cuda_ms(lambda: reference_attention(q, k, v))})
    return row


def grad_check(name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> dict:
    """One gradient against its plain version, with the bars of GRAD_REL and
    GRAD_ABS_OF_STD."""
    err = (got.double() - want.double()).abs().max().item()
    rel = torch_rel_l2(got, want)
    std = want.double().std().item()
    frac = GRAD_ABS_OF_STD[dtype]
    bar = frac * std if frac else 1e-4
    finite = bool(torch.isfinite(got).all())
    return {"name": name, "max_abs_err": err, "max_abs_bar": bar, "rel_l2": rel,
            "rel_l2_bar": GRAD_REL[dtype], "std": std, "finite": finite,
            "ok": finite and err <= bar and rel <= GRAD_REL[dtype]}


def sdpa_backward_ms(q, k, v, g):
    """The library yardstick of B2 and B3: the backward of one
    scaled_dot_product_attention call (dq, dk and dv together) at the same
    inputs, with the first backend that takes head dim c backward."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t[:, None].detach().requires_grad_(True) for t in (q, k, v))
    g4 = g[:, None]
    refused = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                out = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)
                ms = cuda_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), g4, retain_graph=True))
            return ms, backend.name, refused
        except RuntimeError as e:
            refused.append(f"{backend.name}: {str(e).splitlines()[0][:120]}")
    return None, "none", refused


def efficient_lse_ms(q, k, v, lse):
    """The library yardstick of B1 with lse: the efficient-attention forward
    asked for its log-sum-exp, at the same inputs. Returns (ms, max abs
    difference of its lse from B1's), or (None, why) if it refuses."""
    q4, k4, v4 = (t[:, None] for t in (q, k, v))

    def call():
        return torch.ops.aten._scaled_dot_product_efficient_attention(q4, k4, v4, None, True)

    try:
        lib_lse = call()[1][:, 0, : q.shape[1]]
        return cuda_ms(call), (lib_lse.float() - lse).abs().max().item()
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:120]


def phase_backward() -> dict:
    """B1's lse and the backward (B2, B3) against their plain versions, the
    autograd Function against autograd through the plain forward, and their
    times."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(shape, dtype, count):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(count)]

    worst = {"flash_fwd_lse": 0.0, "flash_dkv": 0.0, "flash_dq": 0.0}
    for shape, dtype in CHECK_SHAPES:
        q, k, v, g = randn(shape, dtype, 4)
        o, lse = fa.flash_attention_fwd(q, k, v)
        _, lse_ref = fa.flash_attention_fwd_plain(q, k, v)
        lse_err = (lse - lse_ref).abs().max().item()
        delta = (g.float() * o.float()).sum(-1)
        before = dict(fa.launches)
        dq, dk, dv = fa.flash_bwd(q, k, v, g, lse, delta)
        torch.cuda.synchronize()
        count = fa.launches["flash_bwd"] - before["flash_bwd"]
        instance = fa.flash_bwd_instance(shape[2], dtype)
        ref_dk, ref_dv = fa.flash_dkv_plain(q, k, v, g, lse, delta)
        ref_dq = fa.flash_dq_plain(q, k, v, g, lse, delta)
        rows = [grad_check("dq", dq, ref_dq, dtype), grad_check("dk", dk, ref_dk, dtype),
                grad_check("dv", dv, ref_dv, dtype)]
        emit({"phase": "kernel", "kernels": "flash_fwd lse, flash_bwd", "instance": instance,
              "launches": count, "shape": list(shape), "dtype": str(dtype).split(".")[-1],
              "lse_max_abs_err": lse_err, "lse_bar": LSE_TOLERANCE, "grads": rows})
        if not lse_err <= LSE_TOLERANCE or not all(r["ok"] for r in rows) or count != 1:
            raise AssertionError(f"backward {shape} {dtype} ({instance}): lse {lse_err}, {rows}, {count} launches")
        if shape == (32, 3136, 512):
            worst = {"flash_fwd_lse": lse_err, "flash_dkv": max(rows[1]["max_abs_err"], rows[2]["max_abs_err"]),
                     "flash_dq": rows[0]["max_abs_err"]}
            # the Hopper backward repeats bit for bit (no atomics)
            repeat = all(torch.equal(x, y) for x, y in zip((dq, dk, dv), fa.flash_bwd(q, k, v, g, lse, delta)))
            emit({"phase": "kernel", "kernel": "flash_bwd", "shape": list(shape), "repeat_bitwise": repeat})
            if not repeat:
                raise AssertionError("flash_bwd (32, 3136, 512): two launches differ")
        del q, k, v, g, o, lse, dk, dv, dq, ref_dk, ref_dv, ref_dq
        torch.cuda.empty_cache()

    for shape, dtype in (((4, 3136, 512), torch.bfloat16), ((2, 1000, 512), torch.float32)):
        q, k, v, w = randn(shape, dtype, 4)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = torch.autograd.grad(fa.FlashAttention.apply(*leaves), leaves, w)
        want = torch.autograd.grad(fa.flash_attention_fwd_plain(*ref_leaves)[0], ref_leaves, w)
        rows = [grad_check("d" + n, a, b, dtype) for n, a, b in zip("qkv", got, want)]
        emit({"phase": "kernel", "kernels": "FlashAttention autograd vs autograd of the plain forward",
              "shape": list(shape), "dtype": str(dtype).split(".")[-1], "grads": rows})
        if not all(r["ok"] for r in rows):
            raise AssertionError(f"FlashAttention grads {shape} {dtype}: {rows}")

    b, n, c = 32, 3136, 512
    q, k, v, g = randn((b, n, c), torch.bfloat16, 4)
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = (g.float() * o.float()).sum(-1)
    library_ms, backend, refused = sdpa_backward_ms(q, k, v, g)
    lse_library_ms, lse_library_check = efficient_lse_ms(q, k, v, lse)
    el = q.element_size()
    n_pad = fa.plane_shape(b, n)[2]
    plane_bytes = b * n_pad * n_pad * el  # one of the two planes
    work = {  # operations; bytes with each input read once and each output written once
        "flash_fwd_lse": (4.0 * b * n * n * c, 4.0 * b * n * c * el + 4.0 * b * n),
        # five n x n x c products (S, dP, dV, dK, dQ); q, k, v, dO, lse, delta
        # in, dq, dk, dv out
        "flash_bwd": (10.0 * b * n * n * c, 7.0 * b * n * c * el + 8.0 * b * n),
    }
    calls = {
        "flash_fwd_lse": (lambda: fa.flash_attention_fwd(q, k, v),
                          lambda: fa.flash_attention_fwd_plain(q, k, v)),
        "flash_bwd": (lambda: fa.flash_bwd(q, k, v, g, lse, delta),
                      lambda: fa.flash_bwd_grads_plain(fa.flash_bwd_planes_plain(q, k, v, g, lse, delta),
                                                       q, k, g)),
    }
    rows = {}
    for name, (kernel, plain) in calls.items():
        flops, nbytes = work[name]
        t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        ms = cuda_ms(kernel)
        rows[name] = {
            "shape": [b, n, c], "dtype": "bfloat16", "ms": ms, "plain_ms": cuda_ms(plain),
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "tflops_per_s": flops / ms / 1e9,
        }
    rows["flash_fwd_lse"].update(
        max_abs_err=worst["flash_fwd_lse"], library_ms=lse_library_ms,
        library="aten._scaled_dot_product_efficient_attention, lse on",
        library_lse_max_abs_diff_or_refusal=lse_library_check)
    # the design's own traffic: the planes written once and read three times
    # (dS by dQ and dK, P by dV)
    bytes_with_planes = rows["flash_bwd"]["bytes"] + 5.0 * plane_bytes
    rows["flash_bwd"].update(
        instance=fa.flash_bwd_instance(c, q.dtype), max_abs_err_dkv=worst["flash_dkv"],
        max_abs_err_dq=worst["flash_dq"], bytes_with_planes=bytes_with_planes,
        bound_with_planes_ms=max(rows["flash_bwd"]["bound_ms"], bytes_with_planes / H100_BYTES_PER_S * 1e3),
        # one SDPA backward computes dq, dk and dv, as flash_bwd does
        library_ms=library_ms, library="scaled_dot_product_attention backward",
        library_backend=backend, library_refused=refused)
    for name, row in rows.items():
        emit({"phase": "kernel", "kernel": name, **row})
    return rows


# B6/B7 against their plain versions: the 28² CVAE's bs-4096 levels (cg = 1;
# h·w = 49), the flagship's widest level at bs 32 and at bs 1 (clusters), an
# fp32 flagship level, a ragged fp32 shape with cg = 3 and a ragged bf16 one
# (cg = 3, h·w = 49, L = 147)
GN_SHAPES = [((4096, 32, 28, 28), torch.bfloat16), ((4096, 128, 7, 7), torch.bfloat16),
             ((32, 128, 224, 224), torch.bfloat16), ((1, 128, 224, 224), torch.bfloat16),
             ((2, 1024, 28, 28), torch.float32), ((3, 96, 9, 9), torch.float32),
             ((512, 96, 7, 7), torch.bfloat16)]
GN_TIMED = [(4096, 32, 28, 28), (32, 128, 224, 224)]  # bf16; the first is the main path's
GN_REPEAT = [(4096, 32, 28, 28), (32, 128, 224, 224)]  # bf16, a bitwise repeat of B6 and B7 each
CVAE_BATCH, FLAGSHIP_BATCH = 4096, 32  # cvae28_train's, flagship_fused_gn's
# B6: fp32 relative L2 and max abs; bf16 one rounding apart elementwise
# (2^-7 |p| + 1e-6) and relative L2. B7: fp32 relative L2 for dx, dgamma and
# dbeta; bf16 dx by GRAD_REL and GRAD_ABS_OF_STD, dgamma/dbeta relative L2.
GN_FWD_BARS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-3, None)}
GN_BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# bf16 dx is one rounding of its fp32 value: its relative L2 from the plain
# version's fp32 dx at most this many times that of the rounding alone (one
# more bf16 rounding, of dz, gives about 1.41)
GN_DX_ROUNDINGS = 1.1
GN_OPS_PER_ELEMENT = {"gn_swish_fwd": 11, "gn_swish_bwd": 45}  # fp32, counted from the source (B7 forms dz twice)


def gn_inputs(gen, shape, dtype):
    c = shape[1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
    w = torch.rand((c,), generator=gen, device="cuda") + 0.5
    b = torch.randn((c,), generator=gen, device="cuda") * 0.1
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return x, w, b, g, min(32, c)


def gn_library(x, w, b, groups):
    """The library yardstick: F.group_norm then F.silu, two calls, in x's
    dtype (group_norm takes weight and bias of x's dtype)."""
    return torch.nn.functional.silu(
        torch.nn.functional.group_norm(x, groups, w.to(x.dtype), b.to(x.dtype), 1e-6))


GN_PASSES = {"gn_swish_fwd (B6)": "gn_swish_fwd", "gn_swish_bwd (B7)": "gn_swish_bwd"}


def gn_device_ms(calls: dict, per_call: dict, reps: int = 10) -> dict:
    """Device time a call of each of `calls` (kernel name -> call), from the
    kernels the profiler sees over `reps` calls of each, sorted into B6 and
    B7 by name (`_category`): the card's time without the host's launch
    overhead, which single-call event times include at small shapes. The
    trace must show `reps` calls of each (`per_call`: kernels a call,
    `traced_launches`), else it raises."""
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()

    def window():
        for fn in calls.values():
            for _ in range(reps):
                fn()

    totals, events = dict.fromkeys(calls, 0.0), collections.Counter()
    for kernel, (ms, n) in device_kernels(window).items():
        events[_category(kernel)] += n
        name = GN_PASSES.get(_category(kernel))
        if name in totals:
            totals[name] += ms / reps
    seen = traced_launches(events, per_call)
    if seen != dict.fromkeys(calls, reps):
        raise AssertionError(f"the trace shows {seen} calls of B6/B7, not {reps} each: {dict(events)}")
    return totals


def gn_swish_shapes(model, *inputs, **kwargs) -> collections.Counter:
    """(shape, groups) -> GroupNorm+SiLU sites of one forward of `model`,
    from a forward on the meta device (shapes only; attention through
    reference_attention, which the meta device runs)."""
    seen = collections.Counter()

    def record(x, weight, bias, num_groups, eps):
        seen[(tuple(x.shape), num_groups)] += 1
        return None

    with mock.patch.object(blocks, "fused_group_norm_swish_or_none", record), \
            mock.patch.object(blocks, "attention", reference_attention):
        model(*inputs, **kwargs)
    return seen


def main_path_gn_shapes(with_base128: bool = False, with_gan224: bool = False) -> dict:
    """Path -> (shape, groups) -> sites a step, for the paths that run B6/B7
    (the bs-4096 CVAE step, the flagship's bs-32 step and, with
    `with_gan224`, the full-width GAN experiment's bs-24 step) and, with
    `with_base128`, the 128² BaseVAE's bs-64 step."""
    cvae = build_model(CVAE_BENCH, "bf16", "meta", train=True)
    flagship = build_model(FLAGSHIP, "bf16", "meta", train=True)
    meta = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device="meta")
    out = {"cvae28_train": gn_swish_shapes(cvae, meta(CVAE_BATCH, 28, 28, 3),
                                           condition=meta(CVAE_BATCH, cvae.cond_dim)),
           "flagship_fused_gn": gn_swish_shapes(
               flagship, meta(FLAGSHIP_BATCH, 224, 224, 3),
               modality_indices=meta(FLAGSHIP_BATCH, dtype=torch.long))}
    if with_base128:
        cfg = base128_config()
        base = build_model(cfg["model"], "bf16", "meta", train=True)
        out["base128_train"] = gn_swish_shapes(base, meta(BASE128_BATCH, 128, 128, 1))
    if with_gan224:
        gan = build_model(gan224_config()["model"], "bf16", "meta", train=True)
        out["gan224_train"] = gn_swish_shapes(gan, meta(GAN224_BATCH, 224, 224, 3),
                                              condition=meta(GAN224_BATCH, gan.cond_dim))
    return out


def gn_check(y, y_ref, dx, dx_ref, dw, dw_ref, db, db_ref, dtype):
    """B6's output and B7's gradients against the plain versions: (fwd ok,
    fwd max abs, fwd relative L2, one_rounding, gradient rows)."""
    fwd_err = (y.double() - y_ref.double()).abs()
    fwd_rel = torch_rel_l2(y, y_ref)
    rel_bar, abs_bar = GN_FWD_BARS[dtype]
    if dtype == torch.float32:
        fwd_ok = fwd_rel <= rel_bar and fwd_err.max().item() <= abs_bar
        one_rounding = None
    else:
        one_rounding = bool((fwd_err <= 2.0**-7 * y_ref.double().abs() + 1e-6).all())
        fwd_ok = one_rounding and fwd_rel <= rel_bar
    fwd_ok = fwd_ok and bool(torch.isfinite(y).all())

    def rel_row(n, a, r):
        return {"name": n, "rel_l2": torch_rel_l2(a, r), "rel_l2_bar": GN_BWD_REL[dtype],
                "max_abs_err": (a.double() - r.double()).abs().max().item(),
                "ok": torch_rel_l2(a, r) <= GN_BWD_REL[dtype] and bool(torch.isfinite(a).all())}

    if dtype == torch.float32:
        rows = [rel_row(n, a, r) for n, a, r in (("dx", dx, dx_ref), ("dgamma", dw, dw_ref),
                                                 ("dbeta", db, db_ref))]
    else:
        rows = [grad_check("dx", dx, dx_ref, dtype)] + [
            rel_row(n, a, r) for n, a, r in (("dgamma", dw, dw_ref), ("dbeta", db, db_ref))]
    return fwd_ok, fwd_err.max().item(), fwd_rel, one_rounding, rows


def gn_instances(shape, dtype=torch.bfloat16) -> dict:
    return {"fwd_instance": gs.gn_swish_instance(shape, dtype),
            "bwd_instance": gs.gn_swish_instance(shape, dtype, backward=True)}


def phase_gn_kernel() -> dict:
    """B6 and B7 against their plain versions at GN_SHAPES (each line naming
    the instances), a bitwise repeat of each at GN_REPEAT, the autograd
    Function against autograd through the plain forward, and their times at
    every distinct bf16 shape of cvae28_train and flagship_fused_gn beside
    the bytes bound, the streamed instance and the two-call library version
    (and the plain version at GN_TIMED), then each path's per-step sums."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"gn_swish_fwd": 0.0, "gn_swish_bwd": 0.0}
    for shape, dtype in GN_SHAPES:
        x, w, b, g, groups = gn_inputs(gen, shape, dtype)
        y, mean, rstd = gs.group_norm_swish_fwd(x, w, b, groups, 1e-6)
        dx, dw, db = gs.group_norm_swish_bwd(x, w, b, g, mean, rstd)
        torch.cuda.synchronize()
        y_ref, mean_ref, rstd_ref = gs.group_norm_swish_fwd_plain(x, w, b, groups, 1e-6)
        dx_ref, dw_ref, db_ref = gs.group_norm_swish_bwd_plain(x, w, b, g, mean, rstd)
        fwd_ok, fwd_max, fwd_rel, one_rounding, rows = gn_check(y, y_ref, dx, dx_ref, dw, dw_ref,
                                                                db, db_ref, dtype)
        stats_rel = max(torch_rel_l2(mean, mean_ref), torch_rel_l2(rstd, rstd_ref))
        dx_roundings = None
        if dtype == torch.bfloat16:
            dx32 = gs.group_norm_swish_bwd_plain(x.float(), w, b, g.float(), mean, rstd)[0]
            dx_roundings = torch_rel_l2(dx, dx32) / torch_rel_l2(dx32.to(dtype), dx32)
            del dx32
        rel_bar, abs_bar = GN_FWD_BARS[dtype]
        emit({"phase": "kernel", "kernels": "gn_swish_fwd (B6), gn_swish_bwd (B7)",
              "shape": list(shape), "dtype": str(dtype).split(".")[-1],
              **gn_instances(shape, dtype),
              "fwd_max_abs_err": fwd_max, "fwd_rel_l2": fwd_rel,
              "fwd_rel_l2_bar": rel_bar, "fwd_max_abs_bar": abs_bar,
              "fwd_within_one_rounding": one_rounding, "stats_rel_l2": stats_rel,
              "dx_roundings": dx_roundings, "dx_roundings_bar": GN_DX_ROUNDINGS, "grads": rows})
        if (not fwd_ok or not stats_rel <= 1e-5 or not all(r["ok"] for r in rows)
                or not (dx_roundings is None or dx_roundings <= GN_DX_ROUNDINGS)):
            raise AssertionError(f"gn_swish kernels {shape} {dtype}: fwd rel {fwd_rel}, "
                                 f"stats rel {stats_rel}, dx roundings {dx_roundings}, {rows}")
        if tuple(shape) == GN_TIMED[0]:
            worst = {"gn_swish_fwd": fwd_max, "gn_swish_bwd": max(r["max_abs_err"] for r in rows)}
        del x, g, y, dx, y_ref, dx_ref
        torch.cuda.empty_cache()

    for shape in GN_REPEAT:
        x, w, b, g, groups = gn_inputs(gen, shape, torch.bfloat16)
        first = (*gs.group_norm_swish_fwd(x, w, b, groups, 1e-6),)
        first += gs.group_norm_swish_bwd(x, w, b, g, first[1], first[2])
        second = (*gs.group_norm_swish_fwd(x, w, b, groups, 1e-6),)
        second += gs.group_norm_swish_bwd(x, w, b, g, second[1], second[2])
        same = [bool(torch.equal(p, q)) for p, q in zip(first, second)]
        emit({"phase": "kernel", "kernels": "gn_swish_fwd (B6), gn_swish_bwd (B7) bitwise repeat",
              "shape": list(shape), "dtype": "bfloat16", **gn_instances(shape),
              "fwd_equal": same[:3], "bwd_equal": same[3:]})
        if not all(same):
            raise AssertionError(f"gn_swish kernels {shape}: a repeat differs ({same})")
        del x, g, first, second
        torch.cuda.empty_cache()

    for shape, dtype in (((8, 128, 56, 56), torch.bfloat16), ((2, 96, 9, 9), torch.float32)):
        x, w, b, g, groups = gn_inputs(gen, shape, dtype)
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        ref_leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        got = torch.autograd.grad(gs.GroupNormSwish.apply(*leaves, groups, 1e-6), leaves, g)
        want = torch.autograd.grad(gs.group_norm_swish_plain(*ref_leaves, groups, 1e-6), ref_leaves, g)
        bar = 1e-4 if dtype == torch.float32 else 1e-2
        rows = [{"name": "d" + n, "rel_l2": torch_rel_l2(a, r), "bar": bar}
                for n, a, r in zip(("x", "gamma", "beta"), got, want)]
        emit({"phase": "kernel", "kernels": "GroupNormSwish autograd vs autograd of the plain forward",
              "shape": list(shape), "dtype": str(dtype).split(".")[-1], "grads": rows})
        if not all(r["rel_l2"] <= bar for r in rows):
            raise AssertionError(f"GroupNormSwish grads {shape} {dtype}: {rows}")

    paths = main_path_gn_shapes(with_gan224=True)
    for path, want in (("cvae28_train", 28), ("flagship_fused_gn", 50), ("gan224_train", 50)):
        if sum(paths[path].values()) != want:
            raise AssertionError(f"{path}: {sum(paths[path].values())} GroupNorm+SiLU sites, not {want}")
    shapes = sorted({shape for sites in paths.values() for shape, _ in sites},
                    key=lambda s: (-s[0], s))
    timed = {}
    for shape in shapes:
        x, w, b, g, groups = gn_inputs(gen, shape, torch.bfloat16)
        _, mean, rstd = gs.group_norm_swish_fwd(x, w, b, groups, 1e-6)
        xl = x.clone().requires_grad_(True)
        wl, bl = (t.to(x.dtype).requires_grad_(True) for t in (w, b))
        lib_out = torch.nn.functional.silu(torch.nn.functional.group_norm(xl, groups, wl, bl, 1e-6))
        streamed = {"fwd": gs.plan_for(x, groups, instance="streamed"),
                    "bwd": gs.plan_for(x, groups, backward=True, instance="streamed")}
        n, el, c = x.numel(), x.element_size(), shape[1]
        work = {  # bytes with each input read once and each output written once
            "gn_swish_fwd": 2.0 * n * el + 2 * c * 4 + 2 * shape[0] * groups * 4,
            "gn_swish_bwd": 3.0 * n * el + 4 * c * 4 + 2 * shape[0] * groups * 4,
        }
        calls = {
            "gn_swish_fwd": (lambda: gs.group_norm_swish_fwd(x, w, b, groups, 1e-6),
                             lambda: gs.group_norm_swish_fwd(x, w, b, groups, 1e-6, plan=streamed["fwd"]),
                             lambda: gs.group_norm_swish_fwd_plain(x, w, b, groups, 1e-6),
                             lambda: gn_library(x, w, b, groups)),
            "gn_swish_bwd": (lambda: gs.group_norm_swish_bwd(x, w, b, g, mean, rstd),
                             lambda: gs.group_norm_swish_bwd(x, w, b, g, mean, rstd, plan=streamed["bwd"]),
                             lambda: gs.group_norm_swish_bwd_plain(x, w, b, g, mean, rstd),
                             lambda: torch.autograd.grad(lib_out, (xl, wl, bl), g, retain_graph=True)),
        }
        device = gn_device_ms({name: fns[0] for name, fns in calls.items()},
                              {name: gn_kernels_per_call(name, [(shape, groups)]) for name in calls})
        streamed_device = gn_device_ms({name: fns[1] for name, fns in calls.items()},
                                       {name: KERNELS_PER_CALL[name]["streamed"] for name in calls})
        for name, (kernel, streamed_call, plain, library) in calls.items():
            flops = GN_OPS_PER_ELEMENT[name] * float(n)
            t_ops, t_bytes = flops / H100_FP32_FLOPS * 1e3, work[name] / H100_BYTES_PER_S * 1e3
            ms = cuda_ms(kernel)
            row = {"shape": list(shape), "dtype": "bfloat16",
                   "instance": gs.gn_swish_instance(shape, torch.bfloat16, name == "gn_swish_bwd"),
                   "sites": {path: sites[(shape, groups)] for path, sites in paths.items()
                             if (shape, groups) in sites},
                   "ms": ms, "streamed_ms": cuda_ms(streamed_call),
                   "device_ms": device[name], "streamed_device_ms": streamed_device[name],
                   "plain_ms": cuda_ms(plain) if shape in GN_TIMED else None,
                   "library_ms": cuda_ms(library),
                   "library": "F.group_norm + F.silu, two calls" + (", autograd backward"
                                                                    if name == "gn_swish_bwd" else ""),
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "bytes": work[name], "flops": flops, "gb_per_s": work[name] / ms / 1e6,
                   "bound_share_of_device_ms": max(t_ops, t_bytes) / device[name]}
            emit({"phase": "kernel", "kernel": name, **row})
            timed[(name, shape)] = row
        del x, g, xl, lib_out
        torch.cuda.empty_cache()
    for path, sites in paths.items():
        per_step = {}
        for name in ("gn_swish_fwd", "gn_swish_bwd"):
            rows = [(timed[(name, shape)], k) for (shape, _), k in sites.items()]
            per_step[name] = {key: sum(r[key] * k for r, k in rows)
                              for key in ("ms", "device_ms", "streamed_ms", "streamed_device_ms",
                                          "bound_ms", "library_ms")}
        emit({"phase": "kernel", "gn_per_step": path, "sites": sum(sites.values()),
              "shapes": len(sites), **per_step})
    return {name: dict(timed[(name, GN_TIMED[0])], max_abs_err=worst[name],
                       at_224={k: timed[(name, GN_TIMED[1])][k]
                               for k in ("shape", "instance", "ms", "device_ms", "streamed_ms",
                                         "plain_ms", "library_ms", "bound_ms")})
            for name in worst}


def build_engines():
    cpu_model = build_model(FLAGSHIP, "fp32", "cpu")
    init_weights(cpu_model, seed=0)
    state = cpu_model.state_dict()
    bf16 = build_model(FLAGSHIP, "bf16", "cuda")
    bf16.load_state_dict(state)
    fp32 = build_model(FLAGSHIP, "fp32", "cuda")
    fp32.load_state_dict(state)
    return (InferenceEngine(bf16, buckets=(1, 8, 32), device="cuda"),
            InferenceEngine(fp32, buckets=(1,), device="cuda"),
            InferenceEngine(cpu_model, buckets=(1,), device="cpu"))


# flash launches a chunk of each request makes on the flagship: the five 56²
# attention blocks, two in the encoder and three in the decoder
PER_CHUNK = {"reconstruct": 5, "encode": 2, "decode": 3, "sample": 3}


def phase_serve(engine) -> int:
    t0 = time.perf_counter()
    n_warm = engine.warmup()
    emit({"phase": "serve", "warmup_runs": n_warm,
          "warmup_seconds": round(time.perf_counter() - t0, 3)})
    rs = np.random.RandomState(0)
    res, c = int(engine.model.resolution), int(engine.model.max_channels)
    r = engine.model.encoder_out_res
    zdim = engine.model.total_latent_dim
    images = {n: rs.randint(0, 256, (n, res, res, c), np.uint8) for n in (1, 8, 37)}
    mods = {n: (np.arange(n) % 5).astype(np.int32) for n in (1, 8, 37)}
    z8 = rs.randn(8, r, r, zdim).astype(np.float32)
    requests = [
        ("reconstruct", 1, lambda: engine.reconstruct(images[1], modality=mods[1])),
        ("reconstruct", 8, lambda: engine.reconstruct(images[8], modality=mods[8])),
        ("reconstruct", 37, lambda: engine.reconstruct(images[37], modality=mods[37])),
        ("encode", 8, lambda: engine.encode(images[8], modality=mods[8])),
        ("decode", 8, lambda: engine.decode(z8, modality=mods[8])),
        ("sample", 8, lambda: engine.sample(8, modality=mods[8], seed=1)),
    ]
    fa.reset_launches()  # the main path starts here
    for method, n, fn in requests:
        before = fa.launches["flash_fwd"]
        out = fn()
        got = fa.launches["flash_fwd"] - before
        chunks = len(list(engine._chunks(n)))
        arrays = out if isinstance(out, tuple) else (out,)
        want_shape = (n, r, r, zdim) if method == "encode" else (n, res, res, c)
        ok = all(a.shape == want_shape and np.isfinite(a).all() for a in arrays)
        emit({"phase": "serve", "method": method, "n": n, "chunks": chunks,
              "flash_launches": got, "shape": list(arrays[0].shape), "finite_and_shaped": ok})
        if not ok:
            raise AssertionError(f"{method}({n}): bad output {[a.shape for a in arrays]}")
        if got != PER_CHUNK[method] * chunks:
            raise AssertionError(
                f"{method}({n}): {got} flash launches, want {PER_CHUNK[method]} x {chunks}"
            )
    main_path_launches = dict(fa.launches)  # the main path ends here
    if main_path_launches["flash_bwd"]:
        raise AssertionError(f"serving launched backward kernels: {main_path_launches}")

    for b in engine.buckets:
        x, m = rs.randint(0, 256, (b, res, res, c), np.uint8), (np.arange(b) % 5).astype(np.int32)
        engine.reconstruct(x, modality=m)
        times = host_samples_ms(lambda: engine.reconstruct(x, modality=m), reps=max(5, 40 // b))
        ms = statistics.median(times)
        SUMMARY.setdefault("serve_ms", {})[b] = ms
        emit({"phase": "serve", "method": "reconstruct", "bucket": b,
              "ms_per_batch": ms, "images_per_sec": b / ms * 1e3,
              "min_ms": min(times), "max_ms": max(times), "samples_ms": times})
    return main_path_launches["flash_fwd"]


def phase_parity(bf16_engine, fp32_engine, cpu_engine) -> None:
    res, c = int(fp32_engine.model.resolution), int(fp32_engine.model.max_channels)
    x = np.random.RandomState(1).randint(0, 256, (1, res, res, c), np.uint8)
    m = np.array([2], np.int32)
    card = fp32_engine.reconstruct(x, modality=m)
    cpu = cpu_engine.reconstruct(x, modality=m)
    half = bf16_engine.reconstruct(x, modality=m)
    row = {"phase": "parity", "fp32_card_vs_cpu_max_abs": float(np.abs(card - cpu).max()),
           "fp32_card_vs_cpu_rel_l2": rel_l2(card, cpu), "tolerance": 1e-3,
           "bf16_vs_fp32_card_rel_l2": rel_l2(half, card), "bf16_bound": 5e-2}
    emit(row)
    if not row["fp32_card_vs_cpu_rel_l2"] <= 1e-3:
        raise AssertionError(f"fp32 card vs CPU rel L2 {row['fp32_card_vs_cpu_rel_l2']}")
    if not row["bf16_vs_fp32_card_rel_l2"] <= 5e-2:
        raise AssertionError(f"bf16 vs fp32 rel L2 {row['bf16_vs_fp32_card_rel_l2']}")


def phase_http(engine) -> None:
    httpd = serve(engine, port=0, warmup=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.load(resp)

    model = engine.model
    res, c, r = int(model.resolution), int(model.max_channels), model.encoder_out_res
    try:
        img = np.random.RandomState(2).randint(0, 256, (1, res, res, c), np.uint8)
        rec = _b64_to_np(post("/reconstruct", {"images_b64": _np_to_b64(img),
                                               "modality": "pathmnist", "output": "uint8"})["images_b64"])
        enc = post("/encode", {"images_b64": _np_to_b64(img), "modality": 1})
        mean = _b64_to_np(enc["mean_b64"])
        smp = _b64_to_np(post("/sample", {"num_samples": 2, "modality": [0, 4], "seed": 3})["images_b64"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    ok = (rec.shape == (1, res, res, c) and rec.dtype == np.uint8
          and mean.shape == (1, r, r, model.total_latent_dim)
          and smp.shape == (2, res, res, c) and np.isfinite(smp).all() and np.isfinite(mean).all())
    emit({"phase": "http", "reconstruct": list(rec.shape), "encode_mean": list(mean.shape),
          "sample": list(smp.shape), "ok": bool(ok)})
    if not ok:
        raise AssertionError("http round trips returned bad shapes")


# kernel-name fragments -> the layer a kernel belongs to, for the breakdown
_CATEGORIES = (
    ("attention_fwd_kernel", "attention_fwd (B4)"),  # the FMA instance
    ("attention_bwd_", "attention_bwd (B5)"),
    ("attention_rows_wgmma_kernel<true>", "attention_fwd (B4)"),  # the Hopper instance
    ("attention_rows_wgmma_kernelILb1E", "attention_fwd (B4)"),
    ("attention_rows_wgmma", "attention_bwd (B5)"),
    ("attention_cols_wgmma", "attention_bwd (B5)"),
    ("gn_fwd_", "gn_swish_fwd (B6)"),  # gn_fwd_resident, gn_fwd_cluster
    ("gn_row_stats", "gn_swish_fwd (B6)"),  # the streamed instance's three
    ("gn_group_stats", "gn_swish_fwd (B6)"),
    ("gn_swish_apply", "gn_swish_fwd (B6)"),
    ("gn_bwd", "gn_swish_bwd (B7)"),  # gn_bwd_{resident,cluster,reduce,row,apply}
    ("flash_fwd", "flash_fwd (B1)"),
    ("flash_planes_kernel", "flash_bwd (B2 + B3)"),  # the Hopper instance's two passes
    ("flash_grads_kernel", "flash_bwd (B2 + B3)"),
    ("Nhwc", "cudnn layout transforms"),
    ("Nchw", "cudnn layout transforms"),
    ("fprop", "convolution"),
    ("dgrad", "convolution"),  # cuDNN's implicit-GEMM backward kernels, whose
    ("wgrad", "convolution"),  # names hold "gemm" but not "conv"
    ("conv", "convolution"),
    ("gemm", "matmul"),
    ("group_norm", "group norm"),
    ("GroupNorm", "group norm"),
    ("softmax", "softmax"),
)


def _category(name: str) -> str:
    for frag, cat in _CATEGORIES:
        if frag in name:
            return cat
    return "elementwise / copy / other"


def _conv_by_dtype(name: str) -> str:
    """`_category`, with convolution split by the kernel's type: bf16 (the
    VAE's convs) or the rest (the fp32 towers and discriminator)."""
    cat = _category(name)
    if cat == "convolution":
        return "convolution (bf16)" if "bf16" in name else "convolution (fp32)"
    return cat


# host seconds the trace runs before `fn`'s first launch and after its last
# kernel: Kineto keeps a kernel only where its start and end, on the host's
# clock, lie inside the trace's window, and with none the first kernels of a
# window launched right at its start were dropped (all 30 of a B6 window and
# 3 of the B7 window after it on the H100); the launch counts that every
# profiled window is held to find a loss. 25 ms did not always do: in one
# full run on an H100 the trace lost the first 2 of fast28 (b)'s 30 window
# steps (56 B6 and B7 events)
TRACE_PAD_S = 0.25


def device_kernels(fn) -> dict:
    """{kernel name: [device ms, launches]} over one call of `fn`, from
    torch.profiler's CUPTI tracing (Kineto) of the card's activity alone,
    summed from the profiler's raw events (`kineto_results`): turning them
    into FunctionEvents (what `key_averages()` does) took 54 s for a window
    of 175,000 launches, summing the raw ones 2 s (the same busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    totals = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            totals[e.name()][0] += e.duration_ns() / 1e6
            totals[e.name()][1] += 1
    return dict(totals)


# the trace's category of each wrapper's kernels (`_category`), and the
# kernels one call of the wrapper launches, by instance where they differ:
# B6 one (the streamed instance three), B7 two, dx and the per-channel sums
# then their sum over the batch (streamed three), B4 one, B5 two, rows then
# columns, in either instance (ops/groupnorm_swish.py, ops/attention.py)
TRACE_CATEGORY = {"gn_swish_fwd": "gn_swish_fwd (B6)", "gn_swish_bwd": "gn_swish_bwd (B7)",
                  "attention_fwd": "attention_fwd (B4)", "attention_bwd": "attention_bwd (B5)",
                  "flash_fwd": "flash_fwd (B1)", "flash_bwd": "flash_bwd (B2 + B3)"}
KERNELS_PER_CALL = {"gn_swish_fwd": {"resident": 1, "cluster": 1, "streamed": 3},
                    "gn_swish_bwd": {"resident": 2, "cluster": 2, "streamed": 3},
                    "attention_fwd": 1, "attention_bwd": 2,  # either instance
                    "flash_fwd": 1, "flash_bwd": 2}  # flash_bwd: the bf16 (Hopper) instance's two passes


def gn_kernels_per_call(name: str, shapes) -> int:
    """The kernels one call of B6 or B7 (`name`) launches at every bf16
    (shape, groups) of `shapes`; raises where the shapes' instances launch
    different numbers."""
    counts = {KERNELS_PER_CALL[name][gs.gn_swish_instance(shape, torch.bfloat16, name == "gn_swish_bwd", groups)]
              for shape, groups in shapes}
    if len(counts) != 1:
        raise AssertionError(f"{name}: the shapes' instances launch {counts} kernels a call")
    return counts.pop()


def traced_launches(events: dict, per_call: dict) -> dict:
    """Calls of each wrapper of `per_call` (name -> kernels a call) that a
    trace shows: its category's kernel events (`events`, category -> count,
    `device_breakdown`'s calls_by_layer) over its kernels a call. Raises
    where they do not divide: an event lost or one too many."""
    out = {}
    for name, k in per_call.items():
        n = events.get(TRACE_CATEGORY[name], 0)
        if n % k:
            raise AssertionError(f"{name}: {n} kernel events in the trace, not a multiple of {k} a call")
        out[name] = n // k
    return out


def device_breakdown(fn, wall_ms: float, category=None) -> dict:
    """Device time and kernel events by kernel and by layer (`category`,
    `_category` when None) over one call of `fn` (`device_kernels`), beside
    the same call's unprofiled wall time."""
    kernels = sorted(((ms, name, n) for name, (ms, n) in device_kernels(fn).items()), reverse=True)
    busy = sum(k[0] for k in kernels)
    by_cat, calls = {}, collections.Counter()
    category = category or _category
    for ms, name, n in kernels:
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + ms
        calls[category(name)] += n
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if kernels else "not measured",
            "idle_share": 1.0 - busy / wall_ms if kernels else "not measured",
            "by_layer_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
            "calls_by_layer": dict(calls),
            "top": [{"kernel": k[:80], "ms": ms, "calls": n} for ms, k, n in kernels[:12]]}


def phase_profile(engine) -> None:
    """Device time by kernel over one bs-32 reconstruct."""
    res, c = int(engine.model.resolution), int(engine.model.max_channels)
    x = np.random.RandomState(3).randint(0, 256, (32, res, res, c), np.uint8)
    m = (np.arange(32) % 5).astype(np.int32)
    wall_ms = statistics.median(host_samples_ms(lambda: engine.reconstruct(x, modality=m), reps=3))
    emit({"phase": "profile", "bucket": 32,
          **device_breakdown(lambda: engine.reconstruct(x, modality=m), wall_ms)})


# configs/experiment/disentangled_multi_modal_cvae_full.yaml, training.loss,
# with the fp32 towers (medvae_tpu/train/step.py:147-158)
FLAGSHIP_LOSS = {
    "type": "disentangled_vae", "recon_loss_type": "mse", "kl_weight": 1.0, "recon_weight": 1.0,
    "separation_weight": 0.1, "contrastive_weight": 0.2, "perceptual_weight": 0.1,
    "biomedclip_weight": 0.1, "clip_encoder": "vit",
}
TRAIN_BATCH, WARMUP_STEPS, TIMED_STEPS = 32, 2, 10
# per-leaf bar of train_parity's attention weights, card vs CPU: 1.75x the
# worst reading on the H100 (5.7e-4, a q weight); each leaf's gap is 0.55-0.6 of
# what a 1e-6 nudge of the noise moves it by, and a bf16-grade error in the fp32
# kernels would be ~3e-3
ATTN_GRAD_REL = 1e-3
CARD = "cuda"  # the train phases' device
PER_TRAIN_STEP = {"flash_fwd": 5, "flash_bwd": 5}  # the five 56² blocks


def bench_optimizer():
    """bench.py's flagship full224 optimizer (bench.py:217-222)."""
    return build_optimizer({"type": "adamw", "lr": 1e-4}, {"type": "constant"},
                           gradient_clip_val=1.0)


def synthetic_batch(batch_size: int, size: int, device) -> dict:
    """bench.py's _synthetic_batch (bench.py:132-142): five modalities round
    robin, channels [1, 3, 3, 1, 3], uint8 images from seed 0."""
    rs = np.random.RandomState(0)
    midx = np.arange(batch_size) % 5
    return {
        "image_u8": torch.from_numpy(rs.randint(0, 255, (batch_size, size, size, 3), np.uint8)).to(device),
        "modality_idx": torch.from_numpy(midx).to(device),
        "channels": torch.tensor([1, 3, 3, 1, 3])[midx].to(device),
    }


def train_model(state_dict, precision: str, device, frozen_from=None):
    """The flagship built for training (fp32 params, `precision` compute)
    with `state_dict` loaded, and its frozen towers (seeded, or copies of
    `frozen_from`'s)."""
    model = build_model(FLAGSHIP, precision, device, train=True)
    model.load_state_dict(state_dict)
    if frozen_from is None:
        frozen = make_frozen(FLAGSHIP_LOSS, device, seed=0)
    else:
        frozen = {k: copy.deepcopy(v).to(device) for k, v in frozen_from.items()}
    return model, frozen


def run_steps(tag: str, step, state, batch, gen, warmup: int, timed: int, want: dict,
              history: list | None = None):
    """`warmup` + `timed` train steps, each a run of the main path: the
    counts are reset just before it and read just after, and must equal
    `want`; every step's metrics must be finite (and are appended to
    `history` when given). Returns (state, the timed steps' ms, the counts
    summed over all steps)."""
    totals = dict.fromkeys(want, 0)
    times = []
    for i in range(warmup + timed):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = launches()
        values = {k.split("/", 1)[1]: float(v) for k, v in metrics.items()}
        emit({"phase": tag, "step": i, "warmup": i < warmup, "ms": ms, **values,
              "launches": counts})
        if not all(np.isfinite(list(values.values()))):
            raise AssertionError(f"{tag} step {i}: non-finite metrics {values}")
        if history is not None:
            history.append(values)
        if counts != want:
            raise AssertionError(f"{tag} step {i}: launches {counts}, want {want}")
        for name in totals:
            totals[name] += counts[name]
        if i >= warmup:
            times.append(ms)
    return state, times, totals


def phase_train(state_dict) -> dict:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, frozen = train_model(state_dict, "bf16", CARD)
    tx = bench_optimizer()
    state = create_train_state(model, tx, frozen)
    step = build_train_step(model, FLAGSHIP_LOSS, tx, augment=True, max_channels=3)
    batch = synthetic_batch(TRAIN_BATCH, int(model.resolution), CARD)
    gen = torch.Generator(device=CARD).manual_seed(0)
    want = want_launches(**PER_TRAIN_STEP)
    state, times, totals = run_steps("train", step, state, batch, gen, WARMUP_STEPS, TIMED_STEPS,
                                     want)
    median = statistics.median(times)
    SUMMARY["train"] = {"ms": median, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit({"phase": "train", "batch": TRAIN_BATCH, "resolution": int(model.resolution),
          "ms_per_step_median": median, "ms_per_step_min": min(times),
          "ms_per_step_max": max(times), "samples_ms": times,
          "images_per_sec": TRAIN_BATCH / median * 1e3,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
          "params": sum(p.numel() for p in state.params.values())})
    emit({"phase": "train", "profile": "one step",
          **device_breakdown(lambda: step(state, batch, gen), median)})
    del model, frozen, state, step, batch
    torch.cuda.empty_cache()
    return totals


FUSED_FLAGSHIP_TIMED = 5


def phase_flagship_fused_serve(engine) -> dict:
    """The flagship's bucket-32 reconstruct with MEDVAE_FUSED_GN on (B6 at
    every GroupNorm+SiLU), then off, on the same engine: launches, ms, peak
    memory, and the two outputs against each other."""
    res, c = int(engine.model.resolution), int(engine.model.max_channels)
    x = np.random.RandomState(3).randint(0, 256, (32, res, res, c), np.uint8)
    m = (np.arange(32) % 5).astype(np.int32)
    sites = gn_swish_sites(engine.model)
    want = want_launches(flash_fwd=PER_CHUNK["reconstruct"], gn_swish_fwd=sites)
    row = {"phase": "flagship_fused_gn", "path": "reconstruct", "bucket": 32}
    outs = {}
    for on in (True, False):
        key = "on" if on else "off"
        with fused_gn(on):
            engine.reconstruct(x, modality=m)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()  # the path starts here
            outs[key] = engine.reconstruct(x, modality=m)
            counts = launches()  # and ends here
            peak = torch.cuda.max_memory_allocated() / 2**30
            times = host_samples_ms(lambda: engine.reconstruct(x, modality=m), reps=5)
        if on and counts != want:
            raise AssertionError(f"fused flagship reconstruct: launches {counts}, want {want}")
        ms = statistics.median(times)
        row.update({f"launches_{key}": counts, f"ms_{key}": ms, f"samples_ms_{key}": times,
                    f"images_per_sec_{key}": 32 / ms * 1e3, f"peak_memory_gib_{key}": peak})
    row["on_vs_off_rel_l2"] = rel_l2(outs["on"], outs["off"])
    emit(row)
    if not np.isfinite(outs["on"]).all() or not row["on_vs_off_rel_l2"] <= 5e-2:
        raise AssertionError(f"fused flagship reconstruct: {row['on_vs_off_rel_l2']} from the plain path")
    return row["launches_on"]


def phase_flagship_fused_train(state_dict) -> dict:
    """The flagship's train step with MEDVAE_FUSED_GN on: B6/B7 at every
    GroupNorm+SiLU next to B1's and flash_bwd's 5/5; ms, img/s, peak memory and a
    profile of one step, beside the `train` phase's switch-off numbers."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with fused_gn(True):
        model, frozen = train_model(state_dict, "bf16", CARD)
        tx = bench_optimizer()
        state = create_train_state(model, tx, frozen)
        step = build_train_step(model, FLAGSHIP_LOSS, tx, augment=True, max_channels=3)
        batch = synthetic_batch(TRAIN_BATCH, int(model.resolution), CARD)
        gen = torch.Generator(device=CARD).manual_seed(0)
        sites = gn_swish_sites(model)
        want = want_launches(**PER_TRAIN_STEP, gn_swish_fwd=sites, gn_swish_bwd=sites)
        state, times, totals = run_steps("flagship_fused_gn", step, state, batch, gen, WARMUP_STEPS,
                                         FUSED_FLAGSHIP_TIMED, want)
        median = statistics.median(times)
        emit({"phase": "flagship_fused_gn", "path": "train", "batch": TRAIN_BATCH,
              "gn_swish_sites": sites, "ms_per_step_median": median, "samples_ms": times,
              "images_per_sec": TRAIN_BATCH / median * 1e3,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
        emit({"phase": "flagship_fused_gn", "profile": "one train step",
              **device_breakdown(lambda: step(state, batch, gen), median)})
    del model, frozen, state, step, batch
    torch.cuda.empty_cache()
    return totals


def phase_train_parity(state_dict) -> None:
    """One fp32 step's loss and gradients, card against CPU, at bs 2 with the
    same weights, batch and noise, augment off; and the card's bf16 loss
    against its fp32 loss."""
    res = FLAGSHIP["resolution"]
    r = res // 2 ** (len(FLAGSHIP["ch_mult"]) - 1)
    zdim = FLAGSHIP["shared_latent_dim"] + FLAGSHIP["modality_latent_dim"]
    batch = synthetic_batch(2, res, "cpu")
    batch["noise"] = torch.from_numpy(np.random.RandomState(5).randn(2, r, r, zdim).astype(np.float32))
    frozen_cpu = make_frozen(FLAGSHIP_LOSS, "cpu", seed=0)

    def loss_and_grads(precision, device, noise_jitter=0.0):
        model, frozen = train_model(state_dict, precision, device, frozen_from=frozen_cpu)
        state = create_train_state(model, bench_optimizer(), frozen)
        fn = build_loss_and_grads(model, FLAGSHIP_LOSS, augment=False, max_channels=3)
        run = {k: v.to(device) for k, v in batch.items()}
        run["noise"] = run["noise"] * (1.0 + noise_jitter * jitter.to(device))
        t0 = time.perf_counter()
        losses, grads = fn(state, run)
        seconds = time.perf_counter() - t0
        names = list(state.params)
        return {k: float(v) for k, v in losses.items()}, [g.float().cpu() for g in grads], seconds, names

    def grad_rel(a_grads, b_grads):
        diff = torch.sqrt(sum(((a - b).double() ** 2).sum() for a, b in zip(a_grads, b_grads)))
        return float(diff / torch.sqrt(sum((b.double() ** 2).sum() for b in b_grads)))

    jitter = torch.from_numpy(np.random.RandomState(6).randn(*batch["noise"].shape).astype(np.float32))
    card, card_grads, card_s, names = loss_and_grads("fp32", CARD)
    cpu, cpu_grads, cpu_s, _ = loss_and_grads("fp32", "cpu")
    half, _, _, _ = loss_and_grads("bf16", CARD)
    # two controls: the card's fp32 step repeated as it was (its run-to-run
    # nondeterminism) and with the latent noise moved by 1e-6 relative (the
    # step's conditioning)
    _, repeat_grads, _, _ = loss_and_grads("fp32", CARD)
    _, jittered_grads, _, _ = loss_and_grads("fp32", CARD, noise_jitter=1e-6)
    share = sorted(((float(((a - b).double() ** 2).sum()), n)
                    for a, b, n in zip(card_grads, cpu_grads, names)), reverse=True)
    total = sum(v for v, _ in share) or 1.0
    # the q/k/v/proj_out weights of the five 3136x512 blocks, the ones the
    # kernels' fp32 instances differentiate
    attn = [i for i, n in enumerate(names)
            if re.search(r"\.attn\.\d+\.(q|k|v|proj_out)\.weight$", n) and card_grads[i].shape[0] == 512]
    if len(attn) != 20:
        raise AssertionError(f"want the 20 attention weights of the five 56x56 blocks, got {len(attn)}")
    attn_rows = [{"param": names[i], "card_vs_cpu": torch_rel_l2(card_grads[i], cpu_grads[i]),
                  "card_repeat": torch_rel_l2(repeat_grads[i], card_grads[i]),
                  "card_noise_jitter_1e-6": torch_rel_l2(jittered_grads[i], card_grads[i])}
                 for i in attn]
    worst_attn = max(r["card_vs_cpu"] for r in attn_rows)
    row = {"phase": "train_parity", "batch": 2, "fp32_card_losses": card, "fp32_cpu_losses": cpu,
           "bf16_card_losses": half,
           "loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]), "loss_bar": 1e-4,
           "grad_global_rel_l2": grad_rel(card_grads, cpu_grads), "grad_bar": 1e-3,
           "grad_rel_l2_card_repeat": grad_rel(repeat_grads, card_grads),
           "grad_rel_l2_card_noise_jitter_1e-6": grad_rel(jittered_grads, card_grads),
           "attn_grad_rel_l2_max": worst_attn, "attn_grad_bar": ATTN_GRAD_REL,
           "attn_grads": attn_rows,
           "grad_diff_share_top": [{"param": n, "share": v / total} for v, n in share[:5]],
           "bf16_vs_fp32_loss_rel": abs(half["loss"] - card["loss"]) / abs(card["loss"]),
           "bf16_bar": 5e-2, "card_seconds": card_s, "cpu_seconds": cpu_s}
    emit(row)
    # the fused chunks rest on a step repeating bit for bit: the repeat is gated at 0.0
    if not (row["loss_rel"] <= 1e-4 and row["grad_global_rel_l2"] <= 1e-3
            and worst_attn <= ATTN_GRAD_REL and row["bf16_vs_fp32_loss_rel"] <= 5e-2
            and row["grad_rel_l2_card_repeat"] == 0.0):
        raise AssertionError(f"train parity out of bars: {row}")


# bench.py's default step (config/models.py:CVAE_BENCH, bs 4096, adam 1e-3,
# the `vae` loss) through medvae_tpu_torch.bench's builder
CVAE_LOSS = {"type": "vae", "recon_loss_type": "mse", "kl_weight": 1.0, "recon_weight": 1.0}
CVAE_PARITY_BATCH = 8


def phase_cvae28_train(on: bool) -> dict:
    """2 warmup and 10 timed steps of the 28² CVAE at bs 4096 with
    MEDVAE_FUSED_GN `on` (B6/B7 at every GroupNorm+SiLU, counts derived from
    the model) or off; ms, img/s, flops and mfu, peak memory, a profile."""
    tag = "cvae28_train" if on else "cvae28_train_off"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with fused_gn(on):
        model, step, state, batch = bench.build_bench("cvae", "quick", device=CARD)
        sites = gn_swish_sites(model)
        want = want_launches(gn_swish_fwd=sites if on else 0, gn_swish_bwd=sites if on else 0)
        gen = torch.Generator(device=CARD).manual_seed(0)
        state, times, totals = run_steps(tag, step, state, batch, gen, WARMUP_STEPS, TIMED_STEPS,
                                         want)
        median = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() / 2**30
        flops, state = bench.flops_per_step(step, state, batch, gen)
        bs = int(batch["image_u8"].shape[0])
        row = {"phase": tag, "batch": bs, "resolution": int(model.resolution),
               "gn_swish_sites": {"encoder": gn_swish_sites(model.encoder),
                                  "decoder": gn_swish_sites(model.decoder)},
               "ms_per_step_median": median, "ms_per_step_min": min(times),
               "ms_per_step_max": max(times), "samples_ms": times,
               "images_per_sec": bs / median * 1e3, "flops_per_step": flops,
               "achieved_tflops": flops / median / 1e9,
               "mfu": flops / (median / 1e3) / H100_BF16_FLOPS, "peak_memory_gib": peak,
               "params": sum(p.numel() for p in state.params.values())}
        emit(row)
        emit({"phase": tag, "profile": "one step",
              **device_breakdown(lambda: step(state, batch, gen), median)})
    del model, step, state, batch
    torch.cuda.empty_cache()
    return totals


def phase_cvae28_parity() -> None:
    """One fp32 step of the 28² CVAE at bs 8 with MEDVAE_FUSED_GN on, card
    against CPU (same weights, batch and noise): loss relative 1e-4, gradient
    global relative L2 1e-3, and relative L2 1e-3 for the gradient of every
    GroupNorm weight and bias that B7 computes, beside a repeat of the card's
    step; then the card's bf16 loss against its fp32 loss (5e-2)."""
    cpu_model = init_weights(build_model(CVAE_BENCH, "fp32", "cpu", train=True), seed=0)
    state_dict = cpu_model.state_dict()
    batch = bench.synthetic_batch(CVAE_PARITY_BATCH, CVAE_BENCH["resolution"], "cpu")
    r = cpu_model.encoder_out_res
    batch["noise"] = torch.from_numpy(
        np.random.RandomState(8).randn(CVAE_PARITY_BATCH, r, r, cpu_model.latent_dim).astype(np.float32))
    gn_leaves = [n for n, m in cpu_model.named_modules()
                 if re.search(r"(norm1|norm2|norm_out)$", n)]

    def loss_and_grads(precision, device):
        model = build_model(CVAE_BENCH, precision, device, train=True)
        model.load_state_dict(state_dict)
        state = create_train_state(model, build_optimizer({"type": "adam", "lr": 1e-3},
                                                          {"type": "constant"}, gradient_clip_val=1.0))
        fn = build_loss_and_grads(model, CVAE_LOSS, augment=False, max_channels=3)
        reset_launches()
        losses, grads = fn(state, {k: v.to(device) for k, v in batch.items()})
        counts = launches()
        return ({k: float(v) for k, v in losses.items()},
                dict(zip(state.params, (g.float().cpu() for g in grads))), counts)

    with fused_gn(True):
        card, card_grads, card_counts = loss_and_grads("fp32", CARD)
        _, repeat_grads, _ = loss_and_grads("fp32", CARD)
        cpu, cpu_grads, _ = loss_and_grads("fp32", "cpu")
        half, _, _ = loss_and_grads("bf16", CARD)
    sites = gn_swish_sites(cpu_model)
    if card_counts["gn_swish_fwd"] != sites or card_counts["gn_swish_bwd"] != sites:
        raise AssertionError(f"cvae28_parity: the card's step launched {card_counts}, want {sites}/{sites}")

    def grad_rel(a, b):
        diff = torch.sqrt(sum(((a[k] - b[k]).double() ** 2).sum() for k in b))
        return float(diff / torch.sqrt(sum((v.double() ** 2).sum() for v in b.values())))

    gn_rows = [{"param": f"{n}.{leaf}",
                "card_vs_cpu": torch_rel_l2(card_grads[f"{n}.{leaf}"], cpu_grads[f"{n}.{leaf}"]),
                "card_repeat": torch_rel_l2(repeat_grads[f"{n}.{leaf}"], card_grads[f"{n}.{leaf}"])}
               for n in gn_leaves for leaf in ("weight", "bias")]
    worst = max(r["card_vs_cpu"] for r in gn_rows)
    row = {"phase": "cvae28_parity", "batch": CVAE_PARITY_BATCH, "card_launches": card_counts,
           "fp32_card_losses": card, "fp32_cpu_losses": cpu, "bf16_card_losses": half,
           "loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]), "loss_bar": 1e-4,
           "grad_global_rel_l2": grad_rel(card_grads, cpu_grads), "grad_bar": 1e-3,
           "grad_rel_l2_card_repeat": grad_rel(repeat_grads, card_grads),
           "gn_grad_rel_l2_max": worst, "gn_grad_bar": 1e-3, "gn_leaves": len(gn_rows),
           "gn_grads": gn_rows,
           "bf16_vs_fp32_loss_rel": abs(half["loss"] - card["loss"]) / abs(card["loss"]),
           "bf16_bar": 5e-2}
    emit(row)
    if not (row["loss_rel"] <= 1e-4 and row["grad_global_rel_l2"] <= 1e-3 and worst <= 1e-3
            and row["bf16_vs_fp32_loss_rel"] <= 5e-2 and len(gn_rows) == 2 * sites
            and row["grad_rel_l2_card_repeat"] == 0.0):
        raise AssertionError(f"cvae28 parity out of bars: {row}")


def phase_cvae28_serve() -> dict:
    """The 28² CVAE (random weights from seed 0, bf16) behind
    InferenceEngine(buckets 1/8/32) with MEDVAE_FUSED_GN on: requests by
    modality name and by index, B6 launches per chunk (derived from the
    model), reconstruct latency per bucket, and card fp32 against CPU fp32
    (relative L2 1e-3)."""
    cpu_model = init_weights(build_model(CVAE_BENCH, "fp32", "cpu"), seed=0)
    state = cpu_model.state_dict()
    models = {}
    for precision in ("bf16", "fp32"):
        models[precision] = build_model(CVAE_BENCH, precision, CARD)
        models[precision].load_state_dict(state)
    engine = InferenceEngine(models["bf16"], buckets=(1, 8, 32), device=CARD)
    enc, dec = gn_swish_sites(cpu_model.encoder), gn_swish_sites(cpu_model.decoder)
    per_chunk = {"reconstruct": enc + dec, "encode": enc, "decode": dec, "sample": dec}
    rs = np.random.RandomState(9)
    res, c, r, zdim = CVAE_BENCH["resolution"], CVAE_BENCH["input_channels"], cpu_model.encoder_out_res, cpu_model.latent_dim
    images = {n: rs.randint(0, 256, (n, res, res, c), np.uint8) for n in (1, 8, 37)}
    z8 = rs.randn(8, r, r, zdim).astype(np.float32)
    requests = [
        ("reconstruct", 1, lambda: engine.reconstruct(images[1], modality="dermamnist")),
        ("reconstruct", 8, lambda: engine.reconstruct(images[8], modality=np.arange(8) % 12)),
        ("reconstruct", 37, lambda: engine.reconstruct(images[37], modality=(np.arange(37) * 5) % 12)),
        ("encode", 8, lambda: engine.encode(images[8], modality="octmnist")),
        ("decode", 8, lambda: engine.decode(z8)),
        ("sample", 8, lambda: engine.sample(8, modality="pathmnist", seed=1)),
    ]
    totals = dict.fromkeys(gs.launches, 0)
    with fused_gn(True):
        t0 = time.perf_counter()
        n_warm = engine.warmup()
        emit({"phase": "cvae28_serve", "warmup_runs": n_warm,
              "warmup_seconds": round(time.perf_counter() - t0, 3), "per_chunk": per_chunk})
        for method, n, fn in requests:
            reset_launches()  # each request is a run of the path
            out = fn()
            counts = launches()
            chunks = len(list(engine._chunks(n)))
            arrays = out if isinstance(out, tuple) else (out,)
            want_shape = (n, r, r, zdim) if method == "encode" else (n, res, res, c)
            ok = all(a.shape == want_shape and np.isfinite(a).all() for a in arrays)
            emit({"phase": "cvae28_serve", "method": method, "n": n, "chunks": chunks,
                  "launches": counts, "shape": list(arrays[0].shape), "finite_and_shaped": ok})
            if not ok or counts["gn_swish_fwd"] != per_chunk[method] * chunks or counts["gn_swish_bwd"]:
                raise AssertionError(f"cvae28 {method}({n}): {counts}, want "
                                     f"{per_chunk[method]} x {chunks} B6 launches; shapes ok {ok}")
            for k in totals:
                totals[k] += counts[k]
        for b in engine.buckets:
            x, m = rs.randint(0, 256, (b, res, res, c), np.uint8), np.arange(b) % 12
            engine.reconstruct(x, modality=m)
            times = host_samples_ms(lambda: engine.reconstruct(x, modality=m), reps=max(5, 40 // b))
            ms = statistics.median(times)
            emit({"phase": "cvae28_serve", "method": "reconstruct", "bucket": b, "ms_per_batch": ms,
                  "images_per_sec": b / ms * 1e3, "min_ms": min(times), "max_ms": max(times)})
        x, m = images[8], np.arange(8) % 12
        card = InferenceEngine(models["fp32"], buckets=(8,), device=CARD).reconstruct(x, modality=m)
        cpu = InferenceEngine(cpu_model, buckets=(8,), device="cpu").reconstruct(x, modality=m)
        half = engine.reconstruct(x, modality=m)
    row = {"phase": "cvae28_serve", "parity": "reconstruct n=8",
           "fp32_card_vs_cpu_rel_l2": rel_l2(card, cpu), "tolerance": 1e-3,
           "bf16_vs_fp32_card_rel_l2": rel_l2(half, card), "bf16_bound": 5e-2}
    emit(row)
    if not (row["fp32_card_vs_cpu_rel_l2"] <= 1e-3 and row["bf16_vs_fp32_card_rel_l2"] <= 5e-2):
        raise AssertionError(f"cvae28 serve parity: {row}")
    return totals


# ------------------------------------------------------------ B4 and B5 ---- #

# the 128² BaseVAE's attention (64, 256, 1024), a narrower level, and ragged
# edges of the gate: n off the tiles, odd channel counts, the largest n at
# c 64 and the largest c at n 128
ATTN_SHAPES = [(64, 256, 1024), (64, 256, 512), (2, 144, 64), (3, 196, 96), (2, 863, 64),
               (2, 128, 2870)]
ATTN_TIMED = (64, 256, 1024)  # bf16, the main path's shape
# B4 against its plain version: fp32 max abs and relative L2 1e-5 (JAX's bar,
# tests/test_ops.py:40); bf16 one rounding apart elementwise (2^-7 |p| + 1e-6)
# and relative L2 2e-3. B5: fp32 max abs and relative L2 1e-4
# (tests/test_ops.py:59); bf16 by GRAD_REL and GRAD_ABS_OF_STD.
ATTN_FWD_BAR = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
ATTN_BWD_BAR = 1e-4


def attn_grad_check(name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> dict:
    if dtype == torch.bfloat16:
        return grad_check(name, got, want, dtype)
    err = (got.double() - want.double()).abs().max().item()
    rel = torch_rel_l2(got, want)
    finite = bool(torch.isfinite(got).all())
    return {"name": name, "max_abs_err": err, "rel_l2": rel, "bar": ATTN_BWD_BAR, "finite": finite,
            "ok": finite and err <= ATTN_BWD_BAR and rel <= ATTN_BWD_BAR}


def fma_instance_calls(q, k, v, g) -> dict:
    """B4 and B5 on the FMA instance (the first design) at the shape of q
    (bf16), through the library's `medvae_attention_{fwd,bwd}_bf16_fma`,
    which take it at any shape: the before of this run's before-and-after.
    The port's wrappers never call these, so they count no launch."""
    lib = _build.load("attention")
    b, n, c = q.shape
    stream = torch.cuda.current_stream().cuda_stream
    outs = [torch.empty_like(q) for _ in range(4)]
    stats = torch.empty((3, b, n), dtype=torch.float32, device=q.device)
    fns = {}
    for name, n_ptrs in (("fwd", 4), ("bwd", 8)):
        fn = getattr(lib, f"medvae_attention_{name}_bf16_fma")
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def call(name, tensors):
        err = fns[name](*(t.data_ptr() for t in tensors), b, n, c, float(c) ** -0.5, stream)
        if err != 0:
            raise RuntimeError(f"FMA instance {name}: CUDA error {err}")

    return {"attention_fwd": lambda: call("fwd", (q, k, v, outs[0])),
            "attention_bwd": lambda: call("bwd", (q, k, v, g, *outs[1:], stats))}


def phase_attn_kernel() -> dict:
    """B4 and B5 against their plain versions at ATTN_SHAPES in bf16 and
    fp32, a bitwise repeat of B5, FusedAttention against autograd through the
    plain forward, and their times at ATTN_TIMED beside bound, plain,
    scaled_dot_product_attention in fp32 and reference_attention."""
    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(shape, dtype, count):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(count)]

    worst = {}
    for shape in ATTN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, g = randn(shape, dtype, 4)
            o = at.fused_attention_fwd(q, k, v)
            grads = at.fused_attention_bwd(q, k, v, g)
            torch.cuda.synchronize()
            o_ref = at.fused_attention_fwd_plain(q, k, v)
            err = (o.double() - o_ref.double()).abs()
            rel = torch_rel_l2(o, o_ref)
            if dtype == torch.float32:
                fwd_ok = err.max().item() <= ATTN_FWD_BAR[dtype] and rel <= ATTN_FWD_BAR[dtype]
                one_rounding = None
            else:
                one_rounding = bool((err <= 2.0**-7 * o_ref.double().abs() + 1e-6).all())
                fwd_ok = one_rounding and rel <= ATTN_FWD_BAR[dtype]
            fwd_ok = fwd_ok and bool(torch.isfinite(o).all())
            rows = [attn_grad_check(n, a, b, dtype)
                    for n, a, b in zip(("dq", "dk", "dv"), grads, at.fused_attention_bwd_plain(q, k, v, g))]
            emit({"phase": "attn kernel", "kernels": "attention_fwd (B4), attention_bwd (B5)",
                  "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                  "instance": at.attention_instance(shape[1], shape[2], dtype),
                  "fwd_max_abs_err": err.max().item(), "fwd_rel_l2": rel,
                  "fwd_bar": ATTN_FWD_BAR[dtype], "fwd_within_one_rounding": one_rounding,
                  "output_std": o_ref.float().std().item(), "grads": rows})
            if not fwd_ok or not all(r["ok"] for r in rows):
                raise AssertionError(f"attention kernels {shape} {dtype}: fwd max abs "
                                     f"{err.max().item()}, rel {rel}, {rows}")
            if (tuple(shape), dtype) == (ATTN_TIMED, torch.bfloat16):
                worst = {"attention_fwd": err.max().item(),
                         "attention_bwd": max(r["max_abs_err"] for r in rows)}
            del q, k, v, g, o, grads, o_ref, err
            torch.cuda.empty_cache()

    q, k, v, g = randn(ATTN_TIMED, torch.bfloat16, 4)
    first, second = at.fused_attention_bwd(q, k, v, g), at.fused_attention_bwd(q, k, v, g)
    repeat = all(torch.equal(a, b) for a, b in zip(first, second))
    fwd_repeat = torch.equal(at.fused_attention_fwd(q, k, v), at.fused_attention_fwd(q, k, v))
    emit({"phase": "attn kernel", "attention_bwd_bitwise_repeat": repeat,
          "attention_fwd_bitwise_repeat": fwd_repeat, "shape": list(ATTN_TIMED),
          "instance": at.attention_instance(ATTN_TIMED[1], ATTN_TIMED[2], torch.bfloat16)})
    if not (repeat and fwd_repeat):
        raise AssertionError("attention_fwd or attention_bwd is not bitwise repeatable")
    for shape, dtype in (((4, 256, 1024), torch.bfloat16), ((2, 144, 96), torch.float32)):
        q2, k2, v2, w = randn(shape, dtype, 4)
        leaves = [t.clone().requires_grad_(True) for t in (q2, k2, v2)]
        ref_leaves = [t.clone().requires_grad_(True) for t in (q2, k2, v2)]
        got = torch.autograd.grad(at.FusedAttention.apply(*leaves), leaves, w)
        want = torch.autograd.grad(at.fused_attention_fwd_plain(*ref_leaves), ref_leaves, w)
        rows = [attn_grad_check("d" + n, a, b, dtype) for n, a, b in zip("qkv", got, want)]
        emit({"phase": "attn kernel", "kernels": "FusedAttention autograd vs autograd of the plain forward",
              "shape": list(shape), "dtype": str(dtype).split(".")[-1], "grads": rows})
        if not all(r["ok"] for r in rows):
            raise AssertionError(f"FusedAttention grads {shape} {dtype}: {rows}")

    b, n, c = ATTN_TIMED
    el = q.element_size()
    q32, k32, v32 = (t.float() for t in (q, k, v))
    q4, k4, v4 = (t[:, None] for t in (q32, k32, v32))
    library_bwd_ms, backend, refused = sdpa_backward_ms(q32, k32, v32, g.float())
    # (tensor-core operations, bytes, (operations of the products with two
    # bf16 operands, of those with P or dS)). The first counts the Hopper
    # instance's own arithmetic, all at the bf16 rate: Q·Kᵀ and G·Vᵀ take two bf16
    # operands and run once on the tensor cores; P·V, Pᵀ·G, dS·K and dSᵀ·Q
    # take the fp32 P or dS as three bf16 terms, so they run three times on
    # the tensor cores (P and dS are never rounded once to bf16, as the TPU
    # multiplies with an fp32 P). Beside it, `bound_fp32_products_ms` counts
    # those products once at the fp32 rate, the bound of the FMA instance's design.
    # Bytes: each input read once and each output written once.
    mm = 2.0 * b * n * n * c
    work = {
        "attention_fwd": ((1 + 3) * mm, 4.0 * b * n * c * el, (mm, mm)),
        "attention_bwd": ((2 + 3 * 3) * mm, 7.0 * b * n * c * el, (2 * mm, 3 * mm)),
    }
    fma = fma_instance_calls(q, k, v, g)
    calls = {
        "attention_fwd": (lambda: at.fused_attention_fwd(q, k, v), lambda: at.fused_attention_fwd_plain(q, k, v),
                          cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)),
                          "scaled_dot_product_attention, fp32 inputs"),
        "attention_bwd": (lambda: at.fused_attention_bwd(q, k, v, g),
                          lambda: at.fused_attention_bwd_plain(q, k, v, g), library_bwd_ms,
                          f"scaled_dot_product_attention backward, fp32 inputs ({backend})"),
    }
    rows = {}
    for name, (kernel, plain, library_ms, library) in calls.items():
        tc_flops, nbytes, (bf16_products, fp32_products) = work[name]
        t_ops = tc_flops / H100_BF16_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_fp32 = (bf16_products / H100_BF16_FLOPS + fp32_products / H100_FP32_FLOPS) * 1e3
        ms = cuda_ms(kernel)
        flops = bf16_products + fp32_products  # the function's own operations
        rows[name] = {"shape": [b, n, c], "dtype": "bfloat16",
                      "instance": at.attention_instance(n, c, torch.bfloat16), "ms": ms,
                      "plain_ms": cuda_ms(plain), "library_ms": library_ms, "library": library,
                      "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "bound_fp32_products_ms": max(t_fp32, t_bytes),
                      "fma_instance_ms": cuda_ms(fma[name]),
                      "flops": flops, "tensor_core_flops": tc_flops, "bytes": nbytes,
                      "tflops_per_s": flops / ms / 1e9,
                      "max_abs_err": worst[name]}
    rows["attention_fwd"]["reference_attention_ms"] = cuda_ms(lambda: reference_attention(q, k, v))
    rows["attention_bwd"]["library_refused"] = refused
    for name, row in rows.items():
        emit({"phase": "attn kernel", "kernel": name, **row})
    del q, k, v, g, q32, k32, v32, first, second, fma
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------- the 128² BaseVAE slice ---- #

BASE128_OVERRIDES = ["experiment=chest_base_vae", "model.resolution=128", "data.size=128"]
BASE128_SITES = 7  # encoder level 3 (two), encoder mid, decoder mid, decoder level 3 (three)
BASE128_PER_CHUNK = {"reconstruct": 7, "encode": 3, "decode": 4, "sample": 4}
BASE128_BATCH = 64
REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke_work")


def base128_config():
    """configs/experiment/chest_base_vae.yaml at 128², composed by the port."""
    return compose(cli_train.default_config_dir(), "config", BASE128_OVERRIDES)


def attn_sites(model) -> int:
    return sum(isinstance(m, AttnBlock) for m in model.modules())


def phase_base128_serve(model_cfg, state_dict) -> dict:
    """The 128² BaseVAE (`state_dict`, random weights from seed 0; bf16) behind
    InferenceEngine(buckets 1/8/32): requests with B4 launches per chunk
    (7 a reconstruct, 3 an encode, 4 a decode or sample), latency per
    bucket, card fp32 against CPU fp32 (1e-3) and bf16 against fp32."""
    cpu_model = build_model(model_cfg, "fp32", "cpu")
    cpu_model.load_state_dict(state_dict)
    if attn_sites(cpu_model) != BASE128_SITES:
        raise AssertionError(f"the 128² BaseVAE has {attn_sites(cpu_model)} attention blocks")
    models = {}
    for precision in ("bf16", "fp32"):
        models[precision] = build_model(model_cfg, precision, CARD)
        models[precision].load_state_dict(state_dict)
    engine = InferenceEngine(models["bf16"], buckets=(1, 8, 32), device=CARD)
    rs = np.random.RandomState(10)
    res, c, r, zdim = 128, 1, cpu_model.encoder_out_res, cpu_model.latent_dim
    images = {n: rs.randint(0, 256, (n, res, res, c), np.uint8) for n in (1, 8, 37)}
    z8 = rs.randn(8, r, r, zdim).astype(np.float32)
    requests = [
        ("reconstruct", 1, lambda: engine.reconstruct(images[1])),
        ("reconstruct", 8, lambda: engine.reconstruct(images[8])),
        ("reconstruct", 37, lambda: engine.reconstruct(images[37])),
        ("encode", 8, lambda: engine.encode(images[8])),
        ("decode", 8, lambda: engine.decode(z8)),
        ("sample", 8, lambda: engine.sample(8, seed=1)),
    ]
    t0 = time.perf_counter()
    emit({"phase": "base128_serve", "params": sum(p.numel() for p in cpu_model.parameters()),
          "attention_blocks": BASE128_SITES, "warmup_runs": engine.warmup(),
          "warmup_seconds": round(time.perf_counter() - t0, 3)})
    totals = dict.fromkeys(at.launches, 0)
    for method, n, fn in requests:
        reset_launches()  # each request is a run of the path
        out = fn()
        counts = launches()
        chunks = len(list(engine._chunks(n)))
        arrays = out if isinstance(out, tuple) else (out,)
        want_shape = (n, r, r, zdim) if method == "encode" else (n, res, res, c)
        ok = all(a.shape == want_shape and np.isfinite(a).all() for a in arrays)
        emit({"phase": "base128_serve", "method": method, "n": n, "chunks": chunks, "launches": counts,
              "shape": list(arrays[0].shape), "finite_and_shaped": ok})
        if not ok or counts != want_launches(attention_fwd=BASE128_PER_CHUNK[method] * chunks):
            raise AssertionError(f"base128 {method}({n}): {counts}, want {BASE128_PER_CHUNK[method]} x "
                                 f"{chunks} B4 launches; shapes ok {ok}")
        for k in totals:
            totals[k] += counts[k]
    for bucket in engine.buckets:
        x = rs.randint(0, 256, (bucket, res, res, c), np.uint8)
        engine.reconstruct(x)
        times = host_samples_ms(lambda: engine.reconstruct(x), reps=max(5, 40 // bucket))
        ms = statistics.median(times)
        emit({"phase": "base128_serve", "method": "reconstruct", "bucket": bucket, "ms_per_batch": ms,
              "images_per_sec": bucket / ms * 1e3, "min_ms": min(times), "max_ms": max(times)})
    x = images[1]
    card = InferenceEngine(models["fp32"], buckets=(1,), device=CARD).reconstruct(x)
    t0 = time.perf_counter()
    cpu = InferenceEngine(cpu_model, buckets=(1,), device="cpu").reconstruct(x)
    cpu_s = time.perf_counter() - t0
    half = engine.reconstruct(x)
    row = {"phase": "base128_serve", "parity": "reconstruct n=1",
           "fp32_card_vs_cpu_rel_l2": rel_l2(card, cpu), "tolerance": 1e-3,
           "bf16_vs_fp32_card_rel_l2": rel_l2(half, card), "bf16_bound": 5e-2, "cpu_seconds": cpu_s}
    emit(row)
    if not (row["fp32_card_vs_cpu_rel_l2"] <= 1e-3 and row["bf16_vs_fp32_card_rel_l2"] <= 5e-2):
        raise AssertionError(f"base128 serve parity: {row}")
    del engine, models
    torch.cuda.empty_cache()
    return totals


def base128_batch(cfg, device, batch_size: int) -> dict:
    """The first training batch of the 128² synthetic ChestMNIST split, as
    the trainer's feeder gives it (shuffled for epoch 0)."""
    dm = MedMNISTDataModule(**{k: v for k, v in cfg["data"].items() if k != "_target_"})
    dm.root = os.path.join(WORK, "data")
    feeder = DeviceFeeder(dm.split("train"), batch_size, device, seed=int(cfg["seed"]))
    return next(iter(feeder.epoch(0)))


def base128_optimizer(cfg):
    tcfg = cfg["training"]
    return build_optimizer(dict(tcfg["optimizer"]), dict(tcfg["scheduler"]),
                           steps_per_epoch=2048 // BASE128_BATCH,
                           gradient_clip_val=tcfg["gradient_clip_val"])


def phase_base128_train(cfg, state_dict) -> dict:
    """12 steps of the chest_base_vae step at 128², bs 64 (fp32 params, bf16
    compute, adamw 2e-4 wd 1e-4 on the cosine schedule, clip 1.0, `vae` loss,
    augment on): 7/7 B4/B5 launches a step or it raises; ms, img/s, peak
    memory and a profile of one step."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg["model"], "bf16", CARD, train=True)
    model.load_state_dict(state_dict)
    tx = base128_optimizer(cfg)
    state = create_train_state(model, tx)
    step = build_train_step(model, dict(cfg["training"]["loss"]), tx, augment=True, max_channels=1)
    batch = base128_batch(cfg, CARD, BASE128_BATCH)
    gen = torch.Generator(device=CARD).manual_seed(0)
    want = want_launches(attention_fwd=BASE128_SITES, attention_bwd=BASE128_SITES)
    state, times, totals = run_steps("base128_train", step, state, batch, gen, WARMUP_STEPS, TIMED_STEPS,
                                     want)
    median = statistics.median(times)
    emit({"phase": "base128_train", "batch": BASE128_BATCH, "resolution": 128,
          "ms_per_step_median": median, "ms_per_step_min": min(times), "ms_per_step_max": max(times),
          "samples_ms": times, "images_per_sec": BASE128_BATCH / median * 1e3,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
          "params": sum(p.numel() for p in state.params.values())})
    emit({"phase": "base128_train", "profile": "one step",
          **device_breakdown(lambda: step(state, batch, gen), median)})
    del model, state, step, batch
    torch.cuda.empty_cache()
    return {k: totals[k] for k in at.launches}


def phase_base128_parity(cfg, state_dict) -> None:
    """One fp32 step of the 128² BaseVAE at bs 2, card against CPU (same
    weights, batch and noise, augment off): loss relative 1e-4, gradient
    global relative L2 1e-3 and ATTN_GRAD_REL for each of the 28 attention
    q/k/v/proj_out weight gradients (B5's fp32 instance), beside a repeat of
    the card's step; and the card's bf16 loss against its fp32 loss (5e-2)."""
    batch = base128_batch(cfg, "cpu", 2)
    m = cfg["model"]
    r = m["resolution"] // 2 ** (len(m["ch_mult"]) - 1)
    batch["noise"] = torch.from_numpy(np.random.RandomState(11).randn(2, r, r, m["latent_dim"]).astype(np.float32))
    loss_cfg = dict(cfg["training"]["loss"])

    def loss_and_grads(precision, device):
        model = build_model(cfg["model"], precision, device, train=True)
        model.load_state_dict(state_dict)
        state = create_train_state(model, base128_optimizer(cfg))
        fn = build_loss_and_grads(model, loss_cfg, augment=False, max_channels=1)
        reset_launches()
        t0 = time.perf_counter()
        losses, grads = fn(state, {k: v.to(device) for k, v in batch.items()})
        seconds = time.perf_counter() - t0
        return ({k: float(v) for k, v in losses.items()},
                dict(zip(state.params, (g.float().cpu() for g in grads))), launches(), seconds)

    card, card_grads, card_counts, card_s = loss_and_grads("fp32", CARD)
    _, repeat_grads, _, _ = loss_and_grads("fp32", CARD)
    cpu, cpu_grads, _, cpu_s = loss_and_grads("fp32", "cpu")
    half, _, _, _ = loss_and_grads("bf16", CARD)
    if card_counts != want_launches(attention_fwd=BASE128_SITES, attention_bwd=BASE128_SITES):
        raise AssertionError(f"base128_parity: the card's step launched {card_counts}")

    def grad_rel(a, b):
        diff = torch.sqrt(sum(((a[k] - b[k]).double() ** 2).sum() for k in b))
        return float(diff / torch.sqrt(sum((v.double() ** 2).sum() for v in b.values())))

    attn = [n for n in cpu_grads if re.search(r"attn(_1|\.\d+)\.(q|k|v|proj_out)\.weight$", n)]
    if len(attn) != 4 * BASE128_SITES:
        raise AssertionError(f"want the 28 attention weights, got {len(attn)}")
    rows = [{"param": n, "card_vs_cpu": torch_rel_l2(card_grads[n], cpu_grads[n]),
             "card_repeat": torch_rel_l2(repeat_grads[n], card_grads[n])} for n in attn]
    worst = max(r["card_vs_cpu"] for r in rows)
    row = {"phase": "base128_parity", "batch": 2, "card_launches": card_counts,
           "fp32_card_losses": card, "fp32_cpu_losses": cpu, "bf16_card_losses": half,
           "loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]), "loss_bar": 1e-4,
           "grad_global_rel_l2": grad_rel(card_grads, cpu_grads), "grad_bar": 1e-3,
           "grad_rel_l2_card_repeat": grad_rel(repeat_grads, card_grads),
           "attn_grad_rel_l2_max": worst, "attn_grad_bar": ATTN_GRAD_REL, "attn_grads": rows,
           "bf16_vs_fp32_loss_rel": abs(half["loss"] - card["loss"]) / abs(card["loss"]),
           "bf16_bar": 5e-2, "card_seconds": card_s, "cpu_seconds": cpu_s}
    emit(row)
    if not (row["loss_rel"] <= 1e-4 and row["grad_global_rel_l2"] <= 1e-3 and worst <= ATTN_GRAD_REL
            and row["bf16_vs_fp32_loss_rel"] <= 5e-2 and row["grad_rel_l2_card_repeat"] == 0.0):
        raise AssertionError(f"base128 parity out of bars: {row}")


TRAINER_EPOCHS, TRAINER_BATCHES = 1, 8  # the first run's epochs (one more resumed) and batches
# resumed params against the uninterrupted run's, relative L2: bit for bit on
# the CPU; on the card cuDNN's algorithms need not repeat, so a bar
RESUME_BAR = 1e-3


def train_cli(work: str, epochs: int, *extra) -> tuple:
    """One `python -m medvae_tpu_torch.cli.train` run of the 128²
    chest_base_vae experiment in `work`, its stdout captured; returns (the
    captured text, the run's metrics.jsonl rows, seconds, the counts of B4/B5
    launched by the run)."""
    import io

    # remat=false: the 128² default, auto, would probe the rungs with real
    # steps whose launches this phase's derived counts leave out (fast128
    # runs the probe)
    args = [*BASE128_OVERRIDES, f"device={CARD}", f"work_dir={work}", f"training.max_epochs={epochs}",
            "+model.remat=false",
            f"+training.limit_train_batches={TRAINER_BATCHES}", "training.log_every_n_steps=4",
            "checkpointing.save_top_k=1", "early_stopping.enabled=false", *extra]
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_train.main(args)
    seconds = time.perf_counter() - t0
    counts = {k: launches()[k] for k in at.launches}
    if rc != 0:
        raise AssertionError(f"cli.train returned {rc}")
    with open(os.path.join(work, "logs", "chest_base_vae", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return out.getvalue(), rows, seconds, counts


def final_params(work: str) -> dict:
    path = os.path.join(work, "logs", "checkpoints", "chest_base_vae", "chest_base_vae_final", "checkpoint.pt")
    return torch.load(path, map_location="cpu", weights_only=True)["state_dict"]


def media_sizes(run_dir: str) -> dict:
    """{file: (width, height)} of a run's media grids, each decoded."""
    media = os.path.join(run_dir, "media")
    return {name: read_png_size(os.path.join(media, name)) for name in sorted(os.listdir(media))}


def want_media(size: int) -> dict:
    """Epoch 0's grids (the only media epoch of a run under 10 epochs): 8
    validation images over their reconstructions, 16 prior samples 4 x 4,
    tiles 2 px apart."""
    return {"epoch_0000_recon.png": (8 * (size + 2) + 2, 2 * (size + 2) + 2),
            "epoch_0000_samples.png": (4 * (size + 2) + 2, 4 * (size + 2) + 2)}


def phase_trainer128() -> dict:
    """cli/train.py on experiment=chest_base_vae at 128² (TRAINER_EPOCHS
    epochs of 8 batches, validation and test on), then the same command with
    one more epoch and resume=true, then TRAINER_EPOCHS + 1 epochs
    uninterrupted: steps, img/s and the
    validation per epoch, B4/B5 launches (7 a train step, 7 a validation or
    test batch, 7 + 4 for epoch 0's media grids: a validation batch
    reconstructed and 16 prior samples decoded), the media files, the
    resumed params against the uninterrupted ones (within RESUME_BAR, and the
    first run's params past it as a control); and the final checkpoint served
    through InferenceEngine (7 B4 a reconstruct). The uninterrupted run stays
    in WORK for eval128."""
    split, whole = os.path.join(WORK, "split"), os.path.join(WORK, "whole")
    for d in (split, whole):
        shutil.rmtree(d, ignore_errors=True)
    # the synthetic 128² split is cached on disk: the runs share it
    data = f"data_dir={os.path.join(WORK, 'data')}"
    totals = dict.fromkeys(at.launches, 0)
    eval_batches = 2 * (256 // BASE128_BATCH)  # one validation and the test, 4 batches each

    def check(tag, text, rows, seconds, counts, epochs_run, media_epochs):
        steps = epochs_run * TRAINER_BATCHES
        media = media_epochs * (BASE128_SITES + BASE128_PER_CHUNK["decode"])
        want = {"attention_fwd": BASE128_SITES * (steps + epochs_run * eval_batches // 2 + eval_batches // 2)
                + media, "attention_bwd": BASE128_SITES * steps}
        val = [{k: r[k] for k in ("step", "val/loss", "val/psnr", "val/ssim", "val/kl_total",
                                  "epoch_time_sec")} for r in rows if "val/loss" in r]
        speed = [{"step": r["step"], "train/loss": r["train/loss"],
                  "images_per_sec": r["train/images_per_sec"]} for r in rows if "train/images_per_sec" in r]
        emit({"phase": "trainer128", "run": tag, "seconds": seconds, "train_steps": steps,
              "launches": counts, "want_launches": want, "val_per_epoch": val, "train_logs": speed,
              "printed": [line for line in text.splitlines() if line.startswith(("Resum", "Final", "remat",
                                                                                 "device_cache", "fused"))]})
        finite = all(np.isfinite(v["val/loss"]) for v in val)
        if counts != want or not finite or not val:
            raise AssertionError(f"trainer128 {tag}: launches {counts}, want {want}; val {val}")
        for k in totals:
            totals[k] += counts[k]

    text, first_rows, seconds, counts = train_cli(split, TRAINER_EPOCHS, data)
    check(f"{TRAINER_EPOCHS} epochs", text, first_rows, seconds, counts, TRAINER_EPOCHS, 1)
    first_run = final_params(split)
    gc.collect()
    text, rows, seconds, counts = train_cli(split, TRAINER_EPOCHS + 1, data, "resume=true")
    resumed_at = TRAINER_EPOCHS * TRAINER_BATCHES
    if f"Resuming at optimizer step {resumed_at}" not in text:
        raise AssertionError(f"trainer128 resume did not print 'Resuming at optimizer step {resumed_at}'")
    check("resume +1 epoch", text, rows[len(first_rows):], seconds, counts, 1, 0)  # the log appends
    resumed = final_params(split)
    final_dir = os.path.join(split, "logs", "checkpoints", "chest_base_vae", "chest_base_vae_final")
    engine = InferenceEngine.from_checkpoint(final_dir, buckets=(8,), device=CARD)
    reset_launches()
    res = int(engine.model.resolution)
    rec = engine.reconstruct(np.random.RandomState(12).randint(0, 256, (8, res, res, 1), np.uint8))
    serve_counts = {k: launches()[k] for k in at.launches}
    del engine
    gc.collect()
    shutil.rmtree(split, ignore_errors=True)
    text, rows, seconds, counts = train_cli(whole, TRAINER_EPOCHS + 1, data)
    check(f"{TRAINER_EPOCHS + 1} epochs uninterrupted", text, rows, seconds, counts, TRAINER_EPOCHS + 1, 1)
    whole_params = final_params(whole)
    media = media_sizes(os.path.join(whole, "logs", "chest_base_vae"))
    diff = max((resumed[k] - whole_params[k]).abs().max().item() for k in whole_params)
    norm = torch.sqrt(sum((v.double() ** 2).sum() for v in whole_params.values()))

    def rel_to_whole(params):
        return float(torch.sqrt(sum(((params[k] - whole_params[k]).double() ** 2).sum()
                                    for k in whole_params)) / norm)

    rel, control = rel_to_whole(resumed), rel_to_whole(first_run)
    row = {"phase": "trainer128", "resumed_vs_uninterrupted_max_abs": diff,
           "resumed_vs_uninterrupted_rel_l2": rel, "bar": RESUME_BAR,
           "control_first_run_vs_uninterrupted_rel_l2": control, "media": media,
           "served_final_checkpoint": {"shape": list(rec.shape), "finite": bool(np.isfinite(rec).all()),
                                       "launches": serve_counts}}
    emit(row)
    # the control is one epoch of training apart: a resume that skipped or
    # repeated batches, or lost the optimizer's moments, would lie near it
    if not (rel <= RESUME_BAR < control and np.isfinite(rec).all() and rec.shape == (8, res, res, 1)
            and serve_counts == {"attention_fwd": BASE128_SITES, "attention_bwd": 0}
            and media == want_media(res)):
        raise AssertionError(f"trainer128: {row}")
    for k in totals:
        totals[k] += serve_counts[k]
    return totals



# ------------------------------------------------------------ GAN path ---- #

# configs/experiment/multi_modal_cvae.yaml (906.3 M params, bs 24 at 224²,
# adamw betas (0.5, 0.999) on the cosine schedule, lpips_discriminator,
# PatchGAN ndf 64 x 3 layers), its gate moved to step 1: step 0 lies before
# it and every later step past it
GAN224_OVERRIDES = ["experiment=multi_modal_cvae", "training.loss.discriminator_iter_start=1"]
GAN224_BATCH, GAN224_TIMED = 24, 5
# the cosine schedule's epoch in steps (the trainer takes it from the split;
# seven steps barely move the schedule either way)
GAN224_STEPS_PER_EPOCH = 1000
# the quick GAN experiment (28², hidden 64); parity without dropout (the two
# devices' generators draw different masks), gate at step 1
GAN_QUICK_OVERRIDES = ["experiment=multi_modal_cvae_gan_quick"]
GAN_PARITY_BATCH = 4
GAN_PARITY_BARS = {"loss_rel": 1e-4, "grad_rel_l2": 1e-3, "batch_stats_rel_l2": 1e-5}


def gan224_config():
    return compose(cli_train.default_config_dir(), "config", GAN224_OVERRIDES)


def gan_parts(cfg, device, precision: str, seed: int = 0):
    """(model, discriminator, towers, loss config, optimizers) of a composed
    GAN experiment, random weights from `seed` (D from seed + 7, the towers
    from seed + 11, as the Trainer seeds them)."""
    tcfg = cfg["training"]
    loss_cfg = dict(tcfg["loss"])
    model = init_weights(build_model(cfg["model"], precision, device, train=True), seed)
    disc = build_discriminator(tcfg["discriminator"], device, seed=seed + 7)
    frozen = make_frozen(loss_cfg, device, seed=seed)
    opt = (dict(tcfg["optimizer"]), dict(tcfg["scheduler"]))
    kw = dict(steps_per_epoch=GAN224_STEPS_PER_EPOCH, gradient_clip_val=tcfg["gradient_clip_val"])
    return model, disc, frozen, loss_cfg, build_optimizer(*opt, **kw), discriminator_optimizer(*opt, **kw)


def gan_component_ms(disc, frozen, loss_cfg, batch_size: int, size: int) -> dict:
    """The card's time for the towers' and the discriminator's share of one
    GAN step, each alone on random images of the step's shape (CUDA events):
    LPIPS forward and backward twice (the adaptive weight's numerator and the
    generator loss); D in eval mode forward and backward to its input twice
    (the adaptive weight's and the generator's), then in train mode on the
    real and the fake images with the backward to its params."""
    lp = make_gan_loss(loss_cfg).perceptual_loss
    d = copy.deepcopy(disc)
    gen = torch.Generator(device=CARD).manual_seed(13)
    x = torch.rand((batch_size, size, size, 3), generator=gen, device=CARD) * 2 - 1
    rec = (torch.rand((batch_size, size, size, 3), generator=gen, device=CARD) * 2 - 1).requires_grad_(True)
    params = list(d.parameters())

    def towers():
        for _ in range(2):
            torch.autograd.grad(lp(frozen["lpips"], x, rec), rec)

    def discriminator():
        for _ in range(2):
            torch.autograd.grad(-d(rec, train=False).mean(), rec)
        loss = torch.relu(1.0 - d(x, train=True)).mean() + torch.relu(1.0 + d(rec.detach(), train=True)).mean()
        torch.autograd.grad(loss, params)

    return {"towers_ms": cuda_ms(towers, reps=5), "discriminator_ms": cuda_ms(discriminator, reps=5)}


def phase_gan224_train() -> dict:
    """2 warmup and 5 timed steps of the full-width GAN experiment
    (GAN224_OVERRIDES) with MEDVAE_FUSED_GN=1: fp32 params, bf16 compute,
    fp32 towers and discriminator, bench.py's synthetic uint8 batch at 224²,
    augment on. B6/B7 at every GroupNorm+SiLU site of the model (derived
    from it), the loss terms and d_weight each step; ms, img/s, peak memory,
    a profile with the idle share and the towers' and D's time. A batch that
    does not fit halves (never the width), and the row says why."""
    cfg = gan224_config()
    why = None
    for batch_size in (GAN224_BATCH, GAN224_BATCH // 2):
        gc.collect()  # a failed try's tensors, once its traceback is gone
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            with fused_gn(True):
                return _gan224_run(cfg, batch_size, why)
        except torch.cuda.OutOfMemoryError as e:
            why = f"bs {batch_size} did not fit the card: {str(e).splitlines()[0]}"
            emit({"phase": "gan224_train", "batch": batch_size, "out_of_memory": why})
    raise AssertionError(f"gan224_train: bs {GAN224_BATCH // 2} did not fit either ({why})")


def _gan224_run(cfg, batch_size: int, why) -> dict:
    model, disc, frozen, loss_cfg, tx, disc_tx = gan_parts(cfg, CARD, "bf16")
    state = create_train_state(model, tx, frozen, disc=disc, disc_tx=disc_tx)
    step = build_train_step(model, loss_cfg, tx, augment=True, max_channels=3, disc=disc, disc_tx=disc_tx)
    batch = bench.synthetic_batch(batch_size, int(model.resolution), CARD)
    gen = torch.Generator(device=CARD).manual_seed(0)
    sites = gn_swish_sites(model)
    want = want_launches(gn_swish_fwd=sites, gn_swish_bwd=sites)
    history = []
    state, times, totals = run_steps("gan224_train", step, state, batch, gen, WARMUP_STEPS, GAN224_TIMED,
                                     want, history)
    after = history[1:]  # step 0 lies before the gate
    if not (history[0]["d_weight"] == 0.0 and history[0]["d_loss"] == 0.0
            and all(h["d_weight"] > 0 and h["d_loss"] > 0 for h in after)):
        raise AssertionError(f"gan224_train: d_weight/d_loss {[(h['d_weight'], h['d_loss']) for h in history]}")
    median = statistics.median(times)
    emit({"phase": "gan224_train", "batch": batch_size, "resolution": int(model.resolution),
          "halved_because": why, "gn_swish_sites": sites,
          "ms_per_step_median": median, "ms_per_step_min": min(times), "ms_per_step_max": max(times),
          "samples_ms": times, "images_per_sec": batch_size / median * 1e3,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
          "params": sum(p.numel() for p in state.params.values()),
          "disc_params": sum(p.numel() for p in state.disc_params.values())})
    emit({"phase": "gan224_train", "profile": "one step",
          **device_breakdown(lambda: step(state, batch, gen), median, _conv_by_dtype)})
    emit({"phase": "gan224_train", "components": "towers and discriminator alone",
          **gan_component_ms(disc, frozen, loss_cfg, batch_size, int(model.resolution))})
    del model, disc, frozen, state, step, batch
    torch.cuda.empty_cache()
    return totals


def phase_gan_parity() -> None:
    """One fp32 GAN step past the gate (build_gan_grads at step 1) of the
    quick GAN model at 28² without dropout, bs 4, card against CPU with the
    same weights, batch and noise, augment off: each loss term relative
    1e-4 (terms under 1e-2 in size against 1e-2), the generator's and the
    discriminator's global gradients relative L2 1e-3, D's BatchNorm
    statistics after its two calls relative L2 1e-5; beside two controls,
    the card's step repeated and with the noise nudged by 1e-6."""
    cfg = compose(cli_train.default_config_dir(), "config",
                  [*GAN_QUICK_OVERRIDES, "model.dropout=0.0", "training.loss.discriminator_iter_start=1"])
    model, disc, frozen_cpu, loss_cfg, _, _ = gan_parts(cfg, "cpu", "fp32")
    weights, disc_weights = model.state_dict(), disc.state_dict()
    res = int(model.resolution)
    batch = bench.synthetic_batch(GAN_PARITY_BATCH, res, "cpu")
    r = model.encoder_out_res
    batch["noise"] = torch.from_numpy(
        np.random.RandomState(14).randn(GAN_PARITY_BATCH, r, r, model.latent_dim).astype(np.float32))
    jitter = torch.from_numpy(np.random.RandomState(15).randn(*batch["noise"].shape).astype(np.float32))

    def one_step(device, noise_jitter=0.0):
        m = build_model(cfg["model"], "fp32", device, train=True)
        m.load_state_dict(weights)
        d = build_discriminator(cfg["training"]["discriminator"], device, seed=0)
        d.load_state_dict(disc_weights)
        frozen = {k: copy.deepcopy(v).to(device) for k, v in frozen_cpu.items()}
        tx = build_optimizer(dict(cfg["training"]["optimizer"]))
        state = create_train_state(m, tx, frozen, disc=d, disc_tx=discriminator_optimizer(
            dict(cfg["training"]["optimizer"])))
        state.step = 1
        run = {k: v.to(device) for k, v in batch.items()}
        run["noise"] = run["noise"] * (1.0 + noise_jitter * jitter.to(device))
        reset_launches()
        t0 = time.perf_counter()
        g, dg, logs = build_gan_grads(m, d, loss_cfg, max_channels=3)(state, run)
        seconds = time.perf_counter() - t0
        return ({k.split("/", 1)[1]: float(v) for k, v in logs.items()}, [t.float().cpu() for t in g],
                [t.float().cpu() for t in dg], {k: v.cpu() for k, v in d.named_buffers()}, seconds,
                launches())

    def grad_rel(a_grads, b_grads):
        diff = torch.sqrt(sum(((a - b).double() ** 2).sum() for a, b in zip(a_grads, b_grads)))
        return float(diff / torch.sqrt(sum((b.double() ** 2).sum() for b in b_grads)))

    card, card_g, card_d, card_stats, card_s, card_counts = one_step(CARD)
    cpu, cpu_g, cpu_d, cpu_stats, cpu_s, _ = one_step("cpu")
    _, rep_g, rep_d, _, _, _ = one_step(CARD)
    _, jit_g, jit_d, _, _, _ = one_step(CARD, noise_jitter=1e-6)
    loss_rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-2) for k in cpu}
    stats_rel = max(torch_rel_l2(card_stats[k], cpu_stats[k]) for k in cpu_stats)
    row = {"phase": "gan_parity", "batch": GAN_PARITY_BATCH, "resolution": res,
           "card_losses": card, "cpu_losses": cpu, "loss_rel": loss_rel,
           "loss_rel_max": max(loss_rel.values()),
           "g_grad_rel_l2": grad_rel(card_g, cpu_g), "d_grad_rel_l2": grad_rel(card_d, cpu_d),
           "g_grad_rel_l2_card_repeat": grad_rel(rep_g, card_g),
           "d_grad_rel_l2_card_repeat": grad_rel(rep_d, card_d),
           "g_grad_rel_l2_card_noise_jitter_1e-6": grad_rel(jit_g, card_g),
           "d_grad_rel_l2_card_noise_jitter_1e-6": grad_rel(jit_d, card_d),
           "batch_stats_rel_l2_max": stats_rel, "bars": GAN_PARITY_BARS, "card_launches": card_counts,
           "card_seconds": card_s, "cpu_seconds": cpu_s}
    emit(row)
    bars = GAN_PARITY_BARS
    if not (row["loss_rel_max"] <= bars["loss_rel"] and row["g_grad_rel_l2"] <= bars["grad_rel_l2"]
            and row["d_grad_rel_l2"] <= bars["grad_rel_l2"] and stats_rel <= bars["batch_stats_rel_l2"]
            and card["d_weight"] > 0 and card["d_loss"] > 0):
        raise AssertionError(f"gan parity out of bars: {row}")


GAN_TRAINER_BATCHES, GAN_TRAINER_GATE = 6, 3  # a run's batches an epoch; the gate in the first


def gan_cli(work: str, epochs: int, *extra) -> tuple:
    """One `python -m medvae_tpu_torch.cli.train` run of the quick GAN
    experiment in `work` with MEDVAE_FUSED_GN=1: (stdout, metrics.jsonl
    rows, seconds, B6/B7 launches)."""
    import io

    args = [*GAN_QUICK_OVERRIDES, f"device={CARD}", f"work_dir={work}", f"training.max_epochs={epochs}",
            f"+training.limit_train_batches={GAN_TRAINER_BATCHES}", "training.log_every_n_steps=2",
            f"training.loss.discriminator_iter_start={GAN_TRAINER_GATE}", "checkpointing.save_top_k=1",
            "early_stopping.enabled=false", f"data_dir={os.path.join(WORK, 'data')}", *extra]
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with fused_gn(True), contextlib.redirect_stdout(out):
        rc = cli_train.main(args)
    seconds = time.perf_counter() - t0
    counts = {k: launches()[k] for k in gs.launches}
    if rc != 0:
        raise AssertionError(f"cli.train (GAN) returned {rc}")
    with open(os.path.join(work, "logs", "multi_modal_cvae_gan_quick", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return out.getvalue(), rows, seconds, counts


def gan_snapshot(work: str, name: str = "multi_modal_cvae_gan_quick_final") -> dict:
    """The generator's params and the discriminator's params and BatchNorm
    statistics of a snapshot, by name."""
    path = os.path.join(work, "logs", "checkpoints", "multi_modal_cvae_gan_quick", name, "checkpoint.pt")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    disc = ckpt["train_state"]["disc"]
    return {**{f"G.{k}": v for k, v in ckpt["state_dict"].items()},
            **{f"D.{k}": v for k, v in {**disc["params"], **disc["batch_stats"]}.items()}}


def phase_gan_trainer() -> dict:
    """cli/train.py on experiment=multi_modal_cvae_gan_quick with
    MEDVAE_FUSED_GN=1 (TRAINER_EPOCHS epochs of GAN_TRAINER_BATCHES batches, the gate at
    step GAN_TRAINER_GATE, validation and test on), the same command with one
    more epoch and resume=true, then TRAINER_EPOCHS + 1 epochs uninterrupted: B6/B7 launches
    (B7 at every site a train step; B6 too, plus the decoder's sites again
    for the adaptive weight's pass without dropout, and at every site an
    eval batch, and for epoch 0's media grids at every site and the decoder's
    again), the media files, d_weight and d_loss past the gate, the resumed
    generator's and discriminator's params and BatchNorm statistics against
    the uninterrupted ones (RESUME_BAR, beside the first run's as a
    control); then the final checkpoint served through InferenceEngine (one
    reconstruct, B6 at every site)."""
    cfg = compose(cli_train.default_config_dir(), "config", [*GAN_QUICK_OVERRIDES,
                                                             f"data_dir={os.path.join(WORK, 'data')}"])
    meta_model = build_model(cfg["model"], "bf16", "meta", train=True)
    sites, dec_sites = gn_swish_sites(meta_model), gn_swish_sites(meta_model.decoder)
    dm = instantiate(dict(cfg["data"]))
    dm.setup(None)
    bs = int(dm.batch_size)
    val_batches = -(-len(dm.split("val")) // bs)
    test_batches = -(-len(dm.split("test")) // bs)
    split, whole = os.path.join(WORK, "gan_split"), os.path.join(WORK, "gan_whole")
    for d in (split, whole):
        shutil.rmtree(d, ignore_errors=True)
    totals = dict.fromkeys(gs.launches, 0)

    def check(tag, text, rows, seconds, counts, epochs_run, media_epochs):
        steps = epochs_run * GAN_TRAINER_BATCHES
        evals = epochs_run * val_batches + test_batches
        # epoch 0's media: a validation batch reconstructed, 16 prior samples decoded
        want = {"gn_swish_fwd": (steps + media_epochs) * (sites + dec_sites) + evals * sites,
                "gn_swish_bwd": steps * sites}
        train = [{k: r[k] for k in ("step", "train/total_loss", "train/d_weight", "train/d_loss",
                                    "train/images_per_sec")} for r in rows if "train/d_weight" in r]
        val = [{k: r[k] for k in ("step", "val/loss", "val/psnr", "val/d_loss", "epoch_time_sec")}
               for r in rows if "val/loss" in r]
        emit({"phase": "gan_trainer", "run": tag, "seconds": seconds, "train_steps": steps,
              "launches": counts, "want_launches": want, "train_logs": train, "val_per_epoch": val,
              "printed": [line for line in text.splitlines() if line.startswith(("Resum", "Final"))]})
        finite = all(np.isfinite(v) for r in train + val for v in r.values())
        if counts != want or not finite or not val:
            raise AssertionError(f"gan_trainer {tag}: launches {counts}, want {want}; finite {finite}")
        for k in totals:
            totals[k] += counts[k]
        return train

    text, first_rows, seconds, counts = gan_cli(split, TRAINER_EPOCHS)
    train = check(f"{TRAINER_EPOCHS} epochs", text, first_rows, seconds, counts, TRAINER_EPOCHS, 1)
    past = [r for r in train if r["step"] > GAN_TRAINER_GATE]
    if not past or not all(r["train/d_weight"] > 0 and r["train/d_loss"] > 0 for r in past):
        raise AssertionError(f"gan_trainer: past the gate d_weight/d_loss {past}")
    first_run = gan_snapshot(split)
    gc.collect()
    text, rows, seconds, counts = gan_cli(split, TRAINER_EPOCHS + 1, "resume=true")
    resumed_at = TRAINER_EPOCHS * GAN_TRAINER_BATCHES
    if f"Resuming at optimizer step {resumed_at}" not in text:
        raise AssertionError(f"gan_trainer resume did not print 'Resuming at optimizer step {resumed_at}'")
    check("resume +1 epoch", text, rows[len(first_rows):], seconds, counts, 1, 0)
    resumed = gan_snapshot(split)
    final_dir = os.path.join(split, "logs", "checkpoints", "multi_modal_cvae_gan_quick",
                             "multi_modal_cvae_gan_quick_final")
    with fused_gn(True):
        engine = InferenceEngine.from_checkpoint(final_dir, buckets=(8,), device=CARD)
        res, c = int(engine.model.resolution), int(engine.model.input_channels)
        images = np.random.RandomState(16).randint(0, 256, (8, res, res, c), np.uint8)
        reset_launches()
        rec = engine.reconstruct(images, modality=np.arange(8) % 5)
        serve_counts = {k: launches()[k] for k in gs.launches}
    del engine
    gc.collect()
    shutil.rmtree(split, ignore_errors=True)
    text, rows, seconds, counts = gan_cli(whole, TRAINER_EPOCHS + 1)
    check(f"{TRAINER_EPOCHS + 1} epochs uninterrupted", text, rows, seconds, counts, TRAINER_EPOCHS + 1, 1)
    whole_params = gan_snapshot(whole)
    media = media_sizes(os.path.join(whole, "logs", "multi_modal_cvae_gan_quick"))
    shutil.rmtree(WORK, ignore_errors=True)

    def rel_to_whole(params, prefix):
        keys = [k for k in whole_params if k.startswith(prefix)]
        diff = torch.sqrt(sum(((params[k] - whole_params[k]).double() ** 2).sum() for k in keys))
        return float(diff / torch.sqrt(sum((whole_params[k].double() ** 2).sum() for k in keys)))

    row = {"phase": "gan_trainer", "bar": RESUME_BAR,
           "generator_resumed_vs_uninterrupted_rel_l2": rel_to_whole(resumed, "G."),
           "discriminator_resumed_vs_uninterrupted_rel_l2": rel_to_whole(resumed, "D."),
           "control_generator_first_run_vs_uninterrupted_rel_l2": rel_to_whole(first_run, "G."),
           "control_discriminator_first_run_vs_uninterrupted_rel_l2": rel_to_whole(first_run, "D."), "media": media,
           "served_final_checkpoint": {"shape": list(rec.shape), "finite": bool(np.isfinite(rec).all()),
                                       "launches": serve_counts}}
    emit(row)
    ok = all(row[f"{w}_resumed_vs_uninterrupted_rel_l2"] <= RESUME_BAR
             < row[f"control_{w}_first_run_vs_uninterrupted_rel_l2"] for w in ("generator", "discriminator"))
    if not (ok and np.isfinite(rec).all() and rec.shape == (8, res, res, c)
            and serve_counts == {"gn_swish_fwd": sites, "gn_swish_bwd": 0} and media == want_media(res)):
        raise AssertionError(f"gan_trainer: {row}")
    for k in totals:
        totals[k] += serve_counts[k]
    return totals


# ------------------------------------ evaluation, generation, analysis ---- #

# eval128 holds analyze on the card against the CPU on two classes (with the
# run's one dataset, the centroid distance and silhouette are 0 on any
# device): the first EVAL128_CPU_SAMPLES validation images of each of these
# gray datasets, written as MedMNIST npz files, one batch in all
EVAL128_ANALYZE_DATA = ["chestmnist", "pneumoniamnist"]
EVAL128_CPU_SAMPLES = 16
# the full-scale flagship experiment with two of its five datasets (one gray,
# one RGB), as gan_trainer cuts its data; the weights are main()'s seeded ones
EVAL224_OVERRIDES = ["experiment=disentangled_multi_modal_cvae_full", "data.dataset_names=[chestmnist,pathmnist]"]
ANALYZE_REL = 1e-2  # card bf16 vs CPU bf16, the noise-free analyze numbers


def cli_run(phase: str, tag: str, module, args) -> tuple:
    """One CLI's main(args) with its stdout captured: (row, stdout). The
    row holds the seconds, every kernel's launches (counted from 0 around
    the call), the card's peak memory and the lines that say a figure was
    not written."""
    import io

    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = module.main(args)
    torch.cuda.synchronize()
    row = {"phase": phase, "cli": tag, "seconds": time.perf_counter() - t0, "launches": launches(),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "printed": [line for line in out.getvalue().splitlines() if "not written" in line]}
    if rc != 0:
        raise AssertionError(f"{phase} {tag}: main returned {rc}")
    return row, out.getvalue()


def check_cli(row: dict, want: dict, files: list, want_files) -> None:
    """Launches equal to the derived ones, every wanted file written."""
    row.update(want_launches=want, files=files)
    emit(row)
    missing = sorted(set(want_files) - set(files))
    if row["launches"] != want or missing:
        raise AssertionError(f"{row['phase']} {row['cli']}: launches {row['launches']}, want {want}; "
                             f"missing {missing}")


def finite_numbers(path: str) -> dict:
    """A metrics.json or results.json, each number in it finite or it raises."""
    with open(path) as f:
        data = json.load(f)

    def numbers(v):
        if isinstance(v, dict):
            return [x for u in v.values() for x in numbers(u)]
        return [v] if isinstance(v, (int, float)) else []

    if not all(np.isfinite(x) for x in numbers(data)):
        raise AssertionError(f"{path}: a number is not finite: {data}")
    return data


def analyze_batches(modality_idx: np.ndarray, batch_size: int, per_modality: int) -> int:
    """The batches cli/analyze.py encodes: in split order until every
    modality of the split has `per_modality` samples."""
    have = collections.Counter()
    wanted = set(np.unique(modality_idx).tolist())
    for b, lo in enumerate(range(0, len(modality_idx), batch_size)):
        have.update(modality_idx[lo:lo + batch_size].tolist())
        if all(have[m] >= per_modality for m in wanted):
            return b + 1
    return -(-len(modality_idx) // batch_size)


def val_modalities(cfg) -> tuple:
    dm = instantiate(dict(cfg["data"]))
    return dm.split("val").modality_idx, int(dm.batch_size)


def phase_eval128() -> dict:
    """generate, evaluate and analyze on the final snapshot of trainer128's
    uninterrupted run (the 128² BaseVAE, bf16) on the card: B4 launches a
    CLI against the counts derived from the model (7 a reconstruct batch, 4
    a decode, 3 an encode), the files written, every number finite; then
    analyze on two classes (EVAL128_ANALYZE_DATA) on the card and on the
    CPU, the noise-free centroid distance and silhouette within ANALYZE_REL
    of each other. Returns the B4/B5 launches of the card's runs."""
    run = os.path.join(WORK, "whole", "logs", "checkpoints", "chest_base_vae")
    ckpt, out = os.path.join(run, "chest_base_vae_final"), os.path.join(WORK, "eval128")
    dec, enc = BASE128_PER_CHUNK["decode"], BASE128_PER_CHUNK["encode"]
    totals = dict.fromkeys(at.launches, 0)

    def add(row):
        for k in totals:
            totals[k] += row["launches"][k]

    gen_dir = os.path.join(out, "generate")
    row, _ = cli_run("eval128", "generate", cli_generate, [
        "--model_path", ckpt, "--num_samples", "16", "--num_seeds", "2", "--interpolate", "4",
        "--output_dir", gen_dir])
    # two seeds' sample grids and four interpolation rows, a decode each
    check_cli(row, want_launches(attention_fwd=dec * (2 + 4)), sorted(os.listdir(gen_dir)),
              ["samples_grid_seed42.png", "samples_grid_seed43.png", "interpolation_grid.png",
               *[f"sample_{i:03d}.png" for i in range(16)]])
    add(row)

    mig = host_package("sklearn") is not None
    emit({"phase": "eval128", "evaluate_mig": "on" if mig else "off: sklearn is not installed"})
    ev_dir = os.path.join(out, "evaluate")
    row, _ = cli_run("eval128", "evaluate", cli_evaluate, [
        "--model_path", ckpt, "--max_batches", "4", "--fid", "--output_dir", ev_dir,
        *(["--mig"] if mig else [])])
    metrics = finite_numbers(os.path.join(ev_dir, "metrics.json"))
    row["metrics"] = {k: v.get("mean", v.get("value")) for k, v in metrics.items()}
    # four test batches reconstructed, 16 prior samples decoded
    check_cli(row, want_launches(attention_fwd=4 * BASE128_SITES + dec), sorted(os.listdir(ev_dir)),
              ["metrics.json", "reconstructions.png", "prior_samples.png"])
    add(row)

    import yaml

    with open(os.path.join(run, "config.yaml")) as f:
        cfg = yaml.safe_load(f)
    an_dir = os.path.join(out, "analyze")
    row, _ = cli_run("eval128", "analyze", cli_analyze, [
        "--model_path", ckpt, "--samples_per_modality", "32", "--output_dir", an_dir])
    row["results"] = finite_numbers(os.path.join(an_dir, "results.json"))
    midx, bs = val_modalities(cfg)
    check_cli(row, want_launches(attention_fwd=enc * analyze_batches(midx, bs, 32)),
              sorted(os.listdir(an_dir)), ["results.json", "latent_analysis.npz"])
    add(row)

    n = EVAL128_CPU_SAMPLES
    root = os.path.join(out, "two_classes")
    os.makedirs(root)
    for name in EVAL128_ANALYZE_DATA:
        val = MedMNISTDataModule([name], size=int(cfg["data"]["size"]), root=cfg["data"]["root"]).split("val")
        np.savez(os.path.join(root, f"{name}_{cfg['data']['size']}.npz"),
                 val_images=val.images[:n, ..., 0], val_labels=val.labels[:n])
    cfg["data"].update(dataset_names=EVAL128_ANALYZE_DATA, root=root, batch_size=2 * n)
    config = os.path.join(root, "config.yaml")
    save_yaml(cfg, config)
    results, latents = {}, {}
    for device in (CARD, "cpu"):
        an_dir = os.path.join(out, f"analyze_two_classes_{device}")
        row, _ = cli_run("eval128", f"analyze two classes --device {device}", cli_analyze, [
            "--model_path", ckpt, "--config", config, "--samples_per_modality", str(n),
            "--output_dir", an_dir, "--device", device])
        results[device] = finite_numbers(os.path.join(an_dir, "results.json"))
        latents[device] = np.load(os.path.join(an_dir, "latent_analysis.npz"))["latents"]
        row["results"] = results[device]
        check_cli(row, want_launches(attention_fwd=enc if device == CARD else 0), sorted(os.listdir(an_dir)),
                  ["results.json", "latent_analysis.npz"])
        if device == CARD:
            add(row)
    rel = {k: abs(results[CARD][k] - results["cpu"][k]) / max(abs(results["cpu"][k]), 1e-6)
           for k in ("mean_centroid_distance", "silhouette_score")}
    row = {"phase": "eval128", "analyze_card_vs_cpu_rel": rel, "bar": ANALYZE_REL,
           "latents_card_vs_cpu_rel_l2": rel_l2(latents[CARD], latents["cpu"]),
           "card": results[CARD], "cpu": results["cpu"]}
    emit(row)
    if not (max(rel.values()) <= ANALYZE_REL and results[CARD]["mean_centroid_distance"] > 0):
        raise AssertionError(f"eval128 analyze, card vs CPU: {row}")
    return totals


def phase_eval224(state_dict) -> dict:
    """The full-width 224² flagship (main()'s seeded weights, bf16) saved as
    a port checkpoint beside a config.yaml composed from EVAL224_OVERRIDES,
    then generate (--per_modality, 8 samples, interpolation of 4), evaluate
    (2 batches of 32, --fid), analyze (32 a modality) and evaluate again with
    MEDVAE_FUSED_GN=1, on the card: B1 launches a CLI against the counts
    derived from the model (5 a reconstruct, 3 a decode, 2 an encode), B6 in
    the switched run (50 a reconstruct batch, the decoder's sites a decode),
    the files, every number finite; evaluate's eval_batch alone (ms a bs-32
    batch, img/s), generate's samples/s, analyze's seconds and the PCA's
    share, peak memory. Returns {"flash_fwd": B1 over the four runs,
    "gn_swish_fwd": B6 in the switched run}."""
    work = os.path.join(WORK, "eval224")
    shutil.rmtree(work, ignore_errors=True)
    cfg = compose(cli_train.default_config_dir(), "config",
                  [*EVAL224_OVERRIDES, f"work_dir={work}", f"data_dir={os.path.join(work, 'data')}"])
    ckpt = os.path.join(work, "checkpoints", "flagship")
    os.makedirs(ckpt)
    t0 = time.perf_counter()
    save_checkpoint(os.path.join(ckpt, "checkpoint.pt"), state_dict, cfg["model"], "bf16")
    save_yaml(cfg, os.path.join(work, "checkpoints", "config.yaml"))
    meta = build_model(cfg["model"], "bf16", "meta")
    sites, dec_sites = gn_swish_sites(meta), gn_swish_sites(meta.decoder)
    emit({"phase": "eval224", "checkpoint_seconds": time.perf_counter() - t0,
          "params": sum(p.numel() for p in meta.parameters()), "gn_swish_sites": sites,
          "decoder_gn_swish_sites": dec_sites, "data": list(cfg["data"]["dataset_names"])})
    n_mod, per = int(meta.num_modalities), PER_CHUNK
    b1 = b6 = 0

    gen_dir = os.path.join(work, "generate")
    row, _ = cli_run("eval224", "generate", cli_generate, [
        "--model_path", ckpt, "--per_modality", "--num_samples", "8", "--interpolate", "4",
        "--output_dir", gen_dir])
    names = [MODALITY_NAMES[m] for m in range(n_mod)]
    row["samples_per_sec"] = n_mod * (8 + 4) / row["seconds"]  # 8 samples and a path of 4 a modality
    check_cli(row, want_launches(flash_fwd=per["decode"] * 2 * n_mod), sorted(os.listdir(gen_dir)),
              ["interpolation_grid.png", *[f"samples_{n}.png" for n in names],
               *[f"{n}_{i:03d}.png" for n in names for i in range(8)]])
    b1 += row["launches"]["flash_fwd"]

    eval_args = ["--model_path", ckpt, "--max_batches", "2", "--fid"]
    want_eval = {"flash_fwd": per["reconstruct"] * 2 + per["decode"]}  # 2 batches, 16 prior samples
    for tag, switch, want in (("evaluate", False, want_eval),
                              ("evaluate MEDVAE_FUSED_GN=1", True,
                               {**want_eval, "gn_swish_fwd": sites * 2 + dec_sites})):
        ev_dir = os.path.join(work, tag.replace(" ", "_"))
        with fused_gn(switch):
            row, _ = cli_run("eval224", tag, cli_evaluate, [*eval_args, "--output_dir", ev_dir])
        metrics = finite_numbers(os.path.join(ev_dir, "metrics.json"))
        row["metrics"] = {k: v.get("mean", v.get("value")) for k, v in metrics.items()}
        check_cli(row, want_launches(**want), sorted(os.listdir(ev_dir)),
                  ["metrics.json", "reconstructions.png", "prior_samples.png"])
        b1 += row["launches"]["flash_fwd"]
        b6 += row["launches"]["gn_swish_fwd"]

    an_dir = os.path.join(work, "analyze")
    row, _ = cli_run("eval224", "analyze", cli_analyze, [
        "--model_path", ckpt, "--samples_per_modality", "32", "--output_dir", an_dir])
    row["results"] = finite_numbers(os.path.join(an_dir, "results.json"))
    midx, bs = val_modalities(cfg)
    z = torch.from_numpy(np.load(os.path.join(an_dir, "latent_analysis.npz"))["latents"]).to(CARD)
    pca_s = statistics.median(host_samples_ms(lambda: (pca(z, 2), torch.cuda.synchronize()), reps=3)) / 1e3
    row.update(latents=list(z.shape), pca_seconds=pca_s, pca_share=pca_s / row["seconds"])
    del z
    check_cli(row, want_launches(flash_fwd=per["encode"] * analyze_batches(midx, bs, 32)),
              sorted(os.listdir(an_dir)), ["results.json", "latent_analysis.npz"])
    b1 += row["launches"]["flash_fwd"]

    # the layers alone: evaluate's eval_batch on a bs-32 test batch (host
    # clock, synchronized), and a bs-8 conditional sample, switch off and on
    model = load_model(ckpt, CARD)
    dm = instantiate(dict(cfg["data"]))
    batch = next(iter(DeviceFeeder(dm.split("test"), bs, CARD, shuffle=False, drop_last=False).epoch(0)))
    gen = torch.Generator(device=CARD).manual_seed(0)
    midx8 = torch.zeros(8, dtype=torch.long, device=CARD)
    row = {"phase": "eval224", "layer": "eval_batch bs 32, sample_conditional 8"}
    for switch in (False, True):
        with fused_gn(switch):
            times = host_samples_ms(lambda: (cli_evaluate.eval_batch(model, batch, generator=gen),
                                             torch.cuda.synchronize()), reps=6)[1:]
            sample = host_samples_ms(lambda: (model.sample_conditional(8, midx8, generator=gen),
                                              torch.cuda.synchronize()), reps=6)[1:]
        key = "fused_gn" if switch else "plain_gn"
        row[key] = {"eval_batch_ms": statistics.median(times), "eval_samples_ms": times,
                    "eval_images_per_sec": bs / statistics.median(times) * 1e3,
                    "sample8_ms": statistics.median(sample),
                    "samples_per_sec": 8 / statistics.median(sample) * 1e3}
    emit(row)
    del model, batch
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_fwd": b1, "gn_swish_fwd": b6}


# ------------------------------------------------ import and export ---- #

# keys of a Lightning payload that are not the VAE's: the importer skips them
IMPORT224_SKIPPED = {"loss.perceptual_loss.net.lin0.weight": (1, 64, 1, 1), "loss.logvar": (1,),
                     "discriminator.main.0.weight": (64, 3, 4, 4), "discriminator.main.0.bias": (64,)}
IMPORT224_EXPERIMENT = "disentangled_multi_modal_cvae_full"
EXPORT224_BATCH = {"reconstruct": 32, "sample": 8}
EXPORT128_BATCH = 8
EXPORT_TIMED = 5


def lightning_state_dict(state_dict, model) -> dict:
    """The flagship's weights as the reference's VAELightningModule saves
    them: `model.`-prefixed reference names, the decoder heads split into
    per-modality `modality_decoders.{m}.{0,2}` convs, the projectors as 1x1
    convs (out, in, 1, 1), the unused `modality_embedding`, and the loss and
    discriminator keys of IMPORT224_SKIPPED."""
    out = {}
    for name, t in state_dict.items():
        t = t.detach().to("cpu", torch.float32)
        if name.startswith(("heads_conv1.", "heads_conv2.")):
            seq = "0" if name.startswith("heads_conv1") else "2"
            for m, part in enumerate(torch.chunk(t, model.num_modalities, dim=0)):
                out[f"model.modality_decoders.{m}.{seq}.{name.split('.')[-1]}"] = part.clone()
        elif name.startswith(("in_proj_", "out_proj_")):
            stem, leaf, m = name.rsplit("_", 2)
            group = "modality_input_projectors" if stem == "in_proj" else "modality_output_projectors"
            value = t.t().contiguous()[:, :, None, None] if leaf == "kernel" else t.clone()
            out[f"model.{group}.{m}.{'weight' if leaf == 'kernel' else 'bias'}"] = value
        else:
            out[f"model.{name}"] = t.clone()
    gen = torch.Generator().manual_seed(5)
    out["model.modality_embedding.weight"] = torch.randn((model.num_modalities, 64), generator=gen)
    for name, shape in IMPORT224_SKIPPED.items():
        out[name] = torch.randn(shape, generator=gen)
    return out


def bf16_bars(got: np.ndarray, want: np.ndarray) -> dict:
    """An artifact's output against the eager engine's: bit for bit is
    expected (one graph of the same kernels); the bar is the bf16 one."""
    tol_abs, tol_rel = TOLERANCE[torch.bfloat16]
    err, rel = float(np.abs(got - want).max()), rel_l2(got, want)
    bitwise = bool(np.array_equal(got, want))
    return {"bitwise": bitwise, "max_abs": err, "rel_l2": rel, "bar_max_abs": tol_abs, "bar_rel_l2": tol_rel,
            "held": "bitwise" if bitwise else ("bf16 bars" if err <= tol_abs and rel <= tol_rel else "none"),
            "finite": bool(np.isfinite(got).all()), "shape": list(got.shape)}


def phase_import224(engine, state_dict) -> tuple:
    """The serve phase's seeded flagship written as a reference Lightning
    `.ckpt` (lightning_state_dict, with `epoch`, `global_step` and pickled
    hyper-parameters), imported by cli/import_ckpt.py with
    --experiment disentangled_multi_modal_cvae_full: every imported tensor
    equal to the seeded one bit for bit, the skipped keys counted, then the
    imported checkpoint behind InferenceEngine (bf16, the card) against
    `engine` (built from the same weights): a bucket-32 reconstruct equal
    bit for bit, with 5 B1 launches. Returns (the imported checkpoint's
    directory, the launches of that reconstruct)."""
    work = os.path.join(WORK, "import224")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ckpt = os.path.join(work, "epoch=3-step=1234.ckpt")
    torch.save({"state_dict": lightning_state_dict(state_dict, engine.model), "epoch": 3,
                "global_step": 1234, "hyper_parameters": {"model": dict(FLAGSHIP)}}, ckpt)
    row, printed = cli_run("import224", "import_ckpt", cli_import_ckpt, [
        "--ckpt", ckpt, "--experiment", IMPORT224_EXPERIMENT, "--output_dir", os.path.join(work, "run")])
    imported = os.path.join(work, "run", "imported")
    tensors = load_checkpoint(imported)["state_dict"]
    unequal = sorted(set(tensors) ^ set(state_dict)) or sorted(
        k for k in state_dict if not torch.equal(tensors[k], state_dict[k].float().cpu()))
    row.update(ckpt_bytes=os.path.getsize(ckpt), tensors=len(tensors), tensors_unequal=unequal[:8],
               printed=[line for line in printed.splitlines() if line.startswith("Imported")])
    want_print = f"(skipped {len(IMPORT224_SKIPPED) + 1} non-model keys)"

    served = InferenceEngine.from_checkpoint(imported, buckets=(32,), device=CARD)
    rs = np.random.RandomState(13)
    res, c = int(engine.model.resolution), int(engine.model.max_channels)
    x, m = rs.randint(0, 256, (32, res, res, c), np.uint8), (np.arange(32) % 5).astype(np.int32)
    want = engine.reconstruct(x, modality=m)
    reset_launches()
    got = served.reconstruct(x, modality=m)
    counts = launches()
    row.update(reconstruct_bucket32=bf16_bars(got, want), reconstruct_launches=counts)
    emit(row)
    if unequal or want_print not in printed or not row["reconstruct_bucket32"]["bitwise"] \
            or counts != want_launches(flash_fwd=PER_CHUNK["reconstruct"]):
        raise AssertionError(f"import224: {row}")
    del served
    return imported, counts


def _artifact_bytes(out_dir: str) -> dict:
    """Bytes of each file of an artifact (the weights live in the .pt2s)."""
    return {f: os.path.getsize(os.path.join(out_dir, f)) for f in sorted(os.listdir(out_dir))}


def run_artifact(phase: str, tag: str, model, out_dir: str, batches: dict, inputs: dict, eager: dict,
                 want_ops: dict, want_counts: dict, engine_ms=None) -> dict:
    """Export `model` into out_dir (reconstruct and sample at `batches`),
    load it on the card, and hold it to the eager path: the medvae:: nodes
    of each graph (want_ops), each graph's output against `eager` (bf16
    bars, bit for bit expected) and its launches (want_counts) when run
    once; then the reconstruct artifact's ms a batch beside the engine's
    (`engine_ms`, host clock, median of EXPORT_TIMED after a warmup).
    Returns the launches of the checked runs."""
    t0 = time.perf_counter()
    meta = export_model(model, out_dir, batch_size=batches["reconstruct"],
                        sample_batch_size=batches["sample"])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = load_exported(out_dir, CARD)
    load_s = time.perf_counter() - t0
    row = {"phase": phase, "artifact": tag, "fused_gn": meta["fused_gn"], "batches": batches,
           "export_seconds": export_s, "load_seconds": load_s, "artifact_bytes": _artifact_bytes(out_dir),
           "graph_ops": {g: medvae_ops(art["programs"][g]) for g in GRAPHS}, "want_ops": want_ops}
    totals = dict.fromkeys(launches(), 0)
    ok = row["graph_ops"] == want_ops == meta["ops"]
    for g in GRAPHS:
        reset_launches()
        got = art[g](*inputs[g])
        torch.cuda.synchronize()
        counts = launches()
        row[g] = {**bf16_bars(got, eager[g]), "launches": counts, "want_launches": want_counts[g]}
        ok = ok and row[g]["held"] != "none" and row[g]["finite"] and counts == want_counts[g]
        for k in totals:
            totals[k] += counts[k]
    if engine_ms is not None:
        times = host_samples_ms(lambda: art["reconstruct"](*inputs["reconstruct"]), reps=EXPORT_TIMED + 1)[1:]
        engine_times = host_samples_ms(engine_ms, reps=EXPORT_TIMED + 1)[1:]
        row.update(artifact_ms_per_batch=statistics.median(times), artifact_samples_ms=times,
                   engine_ms_per_batch=statistics.median(engine_times), engine_samples_ms=engine_times)
    emit(row)
    if not ok:
        raise AssertionError(f"{phase} {tag}: {row}")
    del art
    shutil.rmtree(out_dir, ignore_errors=True)
    return totals


def phase_export224(ckpt_dir: str) -> dict:
    """The imported flagship (bf16, the card) exported with torch.export,
    reconstruct at bs 32 and sample at bs 8, once with MEDVAE_FUSED_GN=0 and
    once with 1, each artifact loaded and run on the card (run_artifact):
    5 / 3 medvae.flash_attention nodes and B1 launches, and with the switch
    on the GroupNorm+SiLU sites (50 / the decoder's) as medvae.gn_swish_fwd
    nodes and B6 launches; outputs against the eager engine (reconstruct)
    and the eager sample on the same noise. Returns the launches of the
    checked runs."""
    model = load_model(ckpt_dir, CARD)
    engine = InferenceEngine(model, buckets=(EXPORT224_BATCH["reconstruct"],), device=CARD)
    rs = np.random.RandomState(14)
    res, c = int(model.resolution), int(model.max_channels)
    r, zdim = model.encoder_out_res, model.total_latent_dim
    n_r, n_s = EXPORT224_BATCH["reconstruct"], EXPORT224_BATCH["sample"]
    x, m = rs.randint(0, 256, (n_r, res, res, c), np.uint8), (np.arange(n_r) % 5).astype(np.int32)
    z = rs.randn(n_s, r, r, zdim).astype(np.float32)
    inputs = {"reconstruct": (x, m), "sample": (z, m[:n_s])}
    sites = {"reconstruct": gn_swish_sites(model), "sample": gn_swish_sites(model.decoder)}
    totals = dict.fromkeys(launches(), 0)
    for switch in (False, True):
        with fused_gn(switch):
            with torch.inference_mode():
                eager = {"reconstruct": engine.reconstruct(x, modality=m),
                         "sample": sample_batch(model, n_s, torch.from_numpy(m[:n_s]).to(CARD),
                                                noise=torch.from_numpy(z).to(CARD)).cpu().numpy()}
            want_ops = {g: {"medvae.flash_attention": PER_CHUNK[g],
                            **({"medvae.gn_swish_fwd": sites[g]} if switch else {})} for g in GRAPHS}
            want_counts = {g: want_launches(flash_fwd=PER_CHUNK[g], gn_swish_fwd=sites[g] if switch else 0)
                           for g in GRAPHS}
            counts = run_artifact("export224", "fused_gn" if switch else "plain_gn", model,
                                  os.path.join(WORK, "export224"), EXPORT224_BATCH, inputs, eager, want_ops,
                                  want_counts, engine_ms=lambda: engine.reconstruct(x, modality=m))
        for k in totals:
            totals[k] += counts[k]
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def phase_export128() -> dict:
    """trainer128's final snapshot (the 128² BaseVAE eval128 reads; bf16,
    the card) exported at bs 8 and run from the artifact (run_artifact): 7 /
    4 medvae.attention_fwd nodes and B4 launches in reconstruct / sample,
    outputs against the engine's reconstruct and the eager sample. Returns
    the launches of the checked runs."""
    ckpt = os.path.join(WORK, "whole", "logs", "checkpoints", "chest_base_vae", "chest_base_vae_final")
    model = load_model(ckpt, CARD)
    engine = InferenceEngine(model, buckets=(EXPORT128_BATCH,), device=CARD)
    rs = np.random.RandomState(15)
    res, r, n = int(model.resolution), model.encoder_out_res, EXPORT128_BATCH
    x, m = rs.randint(0, 256, (n, res, res, model.input_channels), np.uint8), np.zeros(n, np.int32)
    z = rs.randn(n, r, r, model.latent_dim).astype(np.float32)
    with torch.inference_mode():
        eager = {"reconstruct": engine.reconstruct(x),
                 "sample": sample_batch(model, n, torch.from_numpy(m).to(CARD),
                                        noise=torch.from_numpy(z).to(CARD)).cpu().numpy()}
    per = {"reconstruct": BASE128_PER_CHUNK["reconstruct"], "sample": BASE128_PER_CHUNK["sample"]}
    totals = run_artifact("export128", "base128", model, os.path.join(WORK, "export128"),
                          {"reconstruct": n, "sample": n}, {"reconstruct": (x, m), "sample": (z, m)}, eager,
                          {g: {"medvae.attention_fwd": per[g]} for g in GRAPHS},
                          {g: want_launches(attention_fwd=per[g]) for g in GRAPHS},
                          engine_ms=lambda: engine.reconstruct(x))
    del engine, model
    gc.collect()
    return {k: totals[k] for k in at.launches}


# configs/model/disentangled_conditional_vae_quick.yaml with linear attention
# at its attention sites (the two mid blocks) and without dropout (the two
# devices' generators draw different masks)
FLAGSHIP28_LINEAR = {**FLAGSHIP, "latent_dim": 16, "shared_latent_dim": 8, "modality_latent_dim": 8,
                     "hidden_channels": 32, "ch_mult": [1, 2, 4], "num_res_blocks": 1,
                     "attn_resolutions": [], "dropout": 0.0, "resolution": 28, "use_linear_attn": True}
OPTIONS_PARITY = {"cvae28_film": {**CVAE_BENCH, "condition_method": "film"},
                  "cvae28_inject": {**CVAE_BENCH, "condition_method": "inject"},
                  "flagship28_linear_attn": FLAGSHIP28_LINEAR}
OPTIONS_PARITY_BARS = {"loss_rel_bar": 1e-4, "grad_rel_l2_bar": 1e-3}


def phase_options_parity() -> None:
    """The model options a reference checkpoint can carry, one fp32 step
    each card against CPU (same weights from seed 0, batch and noise, the
    vae loss, no augment, MEDVAE_FUSED_GN off): the 28² ConditionalVAE with
    `film` and with `inject`, the quick flagship with linear attention. Every
    loss term relative 1e-4, the global gradient relative L2 1e-3, and the
    card's step repeated (grad_rel_l2_card_repeat)."""
    for tag, cfg in OPTIONS_PARITY.items():
        cpu_model = init_weights(build_model(cfg, "fp32", "cpu", train=True), seed=0)
        state_dict = cpu_model.state_dict()
        batch = bench.synthetic_batch(CVAE_PARITY_BATCH, int(cfg["resolution"]), "cpu")
        r, latent = cpu_model.encoder_out_res, cpu_model.latent_dim
        batch["noise"] = torch.from_numpy(
            np.random.RandomState(9).randn(CVAE_PARITY_BATCH, r, r, latent).astype(np.float32))

        def loss_and_grads(device):
            model = build_model(cfg, "fp32", device, train=True)
            model.load_state_dict(state_dict)
            state = create_train_state(model, build_optimizer({"type": "adam", "lr": 1e-3}, {"type": "constant"}))
            fn = build_loss_and_grads(model, CVAE_LOSS, augment=False, max_channels=3)
            losses, grads = fn(state, {k: v.to(device) for k, v in batch.items()})
            return ({k: float(v) for k, v in losses.items()},
                    dict(zip(state.params, (g.float().cpu() for g in grads))))

        card, card_grads = loss_and_grads(CARD)
        _, repeat_grads = loss_and_grads(CARD)
        cpu, cpu_grads = loss_and_grads("cpu")

        def grad_rel(a, b):
            diff = torch.sqrt(sum(((a[k] - b[k]).double() ** 2).sum() for k in b))
            return float(diff / torch.sqrt(sum((v.double() ** 2).sum() for v in b.values())))

        loss_rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30) for k in cpu}
        row = {"phase": "options_parity", "model": tag, "batch": CVAE_PARITY_BATCH,
               "params": sum(v.numel() for v in state_dict.values()),
               "fp32_card_losses": card, "fp32_cpu_losses": cpu, "loss_rel": loss_rel,
               "grad_global_rel_l2": grad_rel(card_grads, cpu_grads),
               "grad_rel_l2_card_repeat": grad_rel(repeat_grads, card_grads), **OPTIONS_PARITY_BARS}
        emit(row)
        if not (max(loss_rel.values()) <= OPTIONS_PARITY_BARS["loss_rel_bar"]
                and row["grad_global_rel_l2"] <= OPTIONS_PARITY_BARS["grad_rel_l2_bar"]):
            raise AssertionError(f"options_parity {tag} out of bars: {row}")


def phase_dispatch() -> dict:
    """What binding B1, B4 and B6 as torch.library ops costs the host: the
    per-call time of each op against its raw wrapper at a tiny shape (the
    kernel short, the host setting the pace: 200 calls, then a
    synchronize; in turns raw, op, op, raw), and both at the main path's
    shape (CUDA events, median of REPS). Returns {op: row}."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def gn_args(b, c, h, w):
        return (rand(b, c, h, w), torch.rand(c, generator=gen, device="cuda") + 0.5,
                torch.randn(c, generator=gen, device="cuda"), 32, 1e-6)

    cases = {
        "flash_attention": (fa.flash_attention, lambda *a: fa.flash_attention_fwd(*a, want_lse=False)[0],
                            [rand(1, 128, 128) for _ in range(3)], [rand(32, 3136, 512) for _ in range(3)]),
        "attention_fwd": (at.attention_fwd, at.fused_attention_fwd,
                          [rand(1, 128, 64) for _ in range(3)], [rand(64, 256, 1024) for _ in range(3)]),
        "gn_swish_fwd": (gs.gn_swish_fwd, lambda *a: gs.group_norm_swish_fwd(*a)[0],
                         gn_args(1, 32, 8, 8), gn_args(4096, 32, 28, 28)),
    }

    def per_call_us(fn, args, n: int = 200) -> float:
        fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    rows = {}
    for name, (op, raw, tiny, main_args) in cases.items():
        raw_a, op_a, op_b, raw_b = (per_call_us(f, tiny) for f in (raw, op, op, raw))
        raw_us, op_us = (raw_a + raw_b) / 2, (op_a + op_b) / 2
        same = torch.equal(op(*main_args), raw(*main_args))
        rows[name] = {"phase": "dispatch", "op": f"medvae::{name}", "tiny_shape": list(tiny[0].shape),
                      "raw_us_per_call": raw_us, "op_us_per_call": op_us, "dispatch_us": op_us - raw_us,
                      "raw_us_turns": [raw_a, raw_b], "op_us_turns": [op_a, op_b],
                      "main_shape": list(main_args[0].shape), "raw_ms": cuda_ms(lambda: raw(*main_args)),
                      "op_ms": cuda_ms(lambda: op(*main_args)), "op_equals_raw": same}
        emit(rows[name])
        if not same:
            raise AssertionError(f"dispatch: {name}'s op and raw wrapper differ at {rows[name]['main_shape']}")
    return rows


# ------------------------------------------- the Trainer's fast paths ---- #

# validation is timed apart from the epoch: none inside fit (the quick
# config's mid-epoch one included)
FAST28 = ["experiment=multi_modal_cvae_quick", "training.max_epochs=1", "training.log_every_n_steps=100000",
          "training.check_val_every_n_epoch=1000", "training.val_check_interval=1.0",
          "training.log_images_every_n_epochs=0",
          "early_stopping.enabled=false", "checkpointing.save_top_k=0"]
FAST28_PREFIX = 50  # runs (a), (b) and (cpre) take the epoch's first 50 steps
IDLE_WINDOW = 30  # steps in each idle-share profile


def fast_trainer(work: str, overrides: list) -> "Trainer":
    return Trainer(compose(cli_train.default_config_dir(), "config",
                           [f"device={CARD}", f"work_dir={work}", *overrides]))


def state_tensors(state) -> dict:
    """Every tensor a step updates, by name (the state's own)."""
    out = {f"param.{k}": v for k, v in state.params.items()}
    out.update({f"ema.{k}": v for k, v in (state.ema_params or {}).items()})
    out.update({f"mu.{i}": v for i, v in enumerate(state.opt_state.mu)})
    out.update({f"nu.{i}": v for i, v in enumerate(state.opt_state.nu)})
    return out


def state_snapshot(state) -> dict:
    return {k: v.detach().clone() for k, v in state_tensors(state).items()}


def restore_state(state, snap: dict, step: int):
    """`state` with its tensors set back to `snap` in place and its counts
    to `step`."""
    with torch.no_grad():
        for k, v in state_tensors(state).items():
            v.copy_(snap[k])
    state.opt_state.count = step
    return dataclasses.replace(state, step=step)


def phase_fast28() -> dict:
    """The Trainer on experiment=multi_modal_cvae_quick at full width (28²,
    bs 16, five datasets, 10,240 synthetic train rows, 640 steps an epoch)
    with MEDVAE_FUSED_GN=1, four runs from one seed: (a) the host feeder,
    one step a call, and (b) the device-cached feeder, one step a call,
    each FAST28_PREFIX steps; (cpre) the cached feeder with fused chunks,
    FAST28_PREFIX steps; (c) the same, one epoch. Each: seconds, img/s and
    peak memory; (b) and (cpre) then validation, timed apart; (a), (b) and
    (c) then the card's idle share over IDLE_WINDOW more steps of their path
    (torch.profiler). Gates: (b) and (cpre) end with the same params, EMA,
    moments and validation metrics bit for bit; B6/B7 launch sites x steps
    (and sites x batches in validation) by the wrappers' counts in every
    run, and by the trace's kernel events in each profiled window, (c)'s
    replayed one included (`traced_launches`); the native gather assembled
    (a)'s batches; the epoch-0 order on the card is the one the port
    computes on the CPU. Returns the launches the trace shows in (c)'s
    window of IDLE_WINDOW replayed steps."""
    t_phase = time.perf_counter()
    work = os.path.join(WORK, "fast28")
    data = f"data_dir={os.path.join(work, 'data')}"
    prefix = f"+training.limit_train_batches={FAST28_PREFIX}"
    runs = {"a": ["+data.device_cache=false", "+training.fused_steps=off", prefix],
            "b": ["+data.device_cache=true", "+training.fused_steps=off", prefix],
            "cpre": ["+data.device_cache=true", "+training.fused_steps=on", prefix],
            "c": ["+data.device_cache=true", "+training.fused_steps=on"]}
    out, ends = {}, {}
    with fused_gn(True):
        for tag, extra in runs.items():
            t = fast_trainer(os.path.join(work, tag), [*FAST28, data, *extra])
            sites = gn_swish_sites(t.model)
            meta_model = build_model(t.model_cfg, "bf16", "meta", train=True)
            shapes = gn_swish_shapes(meta_model, torch.zeros((16, 28, 28, 3), device="meta"),
                                     condition=torch.zeros((16, meta_model.cond_dim), device="meta"))
            per_call = {name: gn_kernels_per_call(name, shapes) for name in ("gn_swish_fwd", "gn_swish_bwd")}
            feeder = t._feeder("train", True, True)
            steps = t.steps_per_epoch if tag == "c" else FAST28_PREFIX
            native_before = native.calls
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                t.fit()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = launches()
            want = want_launches(gn_swish_fwd=sites * steps, gn_swish_bwd=sites * steps)
            if counts != want or t.state.step != steps:
                raise AssertionError(f"fast28 ({tag}): {t.state.step} steps, launches {counts}, want {want}")
            row = {"phase": "fast28", "run": tag, "options": extra, "steps": steps, "batch": t.datamodule.batch_size,
                   "seconds": seconds, "s_per_epoch" if tag == "c" else f"s_per_{steps}_steps": seconds,
                   "images_per_sec": steps * t.datamodule.batch_size / seconds,
                   "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": counts,
                   "gn_sites": sites, "feeder": type(feeder).__name__}
            if tag == "a":
                row["native_batches"] = native.calls - native_before
                if not native.available() or row["native_batches"] < steps:
                    raise AssertionError(f"fast28 (a): the native gather assembled {row['native_batches']} "
                                         f"of {steps} batches")
            else:
                card_order = feeder.epoch_perm(0).cpu()
                cpu_order = DeviceCachedFeeder(t.datamodule.train_arrays, 16, "cpu", seed=t.seed).epoch_perm(0)
                row["epoch0_order_card_equals_cpu"] = torch.equal(card_order, cpu_order)
                if not row["epoch0_order_card_equals_cpu"]:
                    raise AssertionError(f"fast28 ({tag}): the card's epoch-0 order differs from the CPU's")
            if tag in ("b", "cpre"):  # the bitwise pair: validation too
                reset_launches()
                t0 = time.perf_counter()
                val = t.validate()
                torch.cuda.synchronize()
                row["validate_seconds"] = time.perf_counter() - t0
                val_batches = t._feeder("val", False, False).steps_per_epoch
                if launches() != want_launches(gn_swish_fwd=sites * val_batches):
                    raise AssertionError(f"fast28 ({tag}) validation: launches {launches()}")
                row.update(val_launches=launches(), val_loss=val["val/loss"], val_psnr=val["val/psnr"])
                ends[tag] = (state_snapshot(t.state), val)
            if tag != "cpre":  # the idle share over IDLE_WINDOW further steps of the same path
                if tag == "c":
                    run = build_chunk_runner(t.train_step, feeder, t._generator, lambda s: s)
                    t.state, _ = run(t.state, 1, 0, 1)  # warm-up and capture

                    def window():
                        t.state, m = run(t.state, 1, 1, IDLE_WINDOW)
                        next(iter(m.values())).item()
                elif tag == "b":
                    batches = list(itertools.islice(feeder.epoch(1), IDLE_WINDOW))

                    def window():
                        for batch in batches:
                            t.state, m = t.train_step(t.state, batch, t._generator)
                        next(iter(m.values())).item()
                else:  # the host feeder's window pays its own gather and copies
                    def window():
                        for batch in itertools.islice(feeder.epoch(1), IDLE_WINDOW):
                            t.state, m = t.train_step(t.state, batch, t._generator)
                        next(iter(m.values())).item()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                window()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                reset_launches()
                prof = device_breakdown(window, wall)
                traced = traced_launches(prof["calls_by_layer"], per_call)
                want = {name: sites * IDLE_WINDOW for name in per_call}
                if traced != want or {k: launches()[k] for k in want} != want:
                    raise AssertionError(f"fast28 ({tag}) window: the trace shows {traced} calls, the wrappers "
                                         f"counted {launches()}, want {want}: {prof['calls_by_layer']}")
                row.update(idle_window_steps=IDLE_WINDOW, idle_share=prof["idle_share"],
                           window_ms_per_step=wall / IDLE_WINDOW, device_busy_ms=prof["device_busy_ms"],
                           window_traced_launches=traced, by_layer_ms=prof["by_layer_ms"])
                out[tag] = row
            emit(row)
            del t, feeder
            gc.collect()
            torch.cuda.empty_cache()
    (b_state, b_val), (c_state, c_val) = ends["b"], ends["cpre"]
    same = [k for k in b_state if not torch.equal(b_state[k], c_state[k])]
    drop = "epoch_time_sec"
    same_val = {k: v for k, v in b_val.items() if k != drop} == {k: v for k, v in c_val.items() if k != drop}
    emit({"phase": "fast28", "b_equals_cpre_bitwise": not same, "steps": FAST28_PREFIX,
          "differing_tensors": same[:5], "validation_equal": same_val, "seconds": time.perf_counter() - t_phase})
    if same or not same_val:
        raise AssertionError(f"fast28: fused (cpre) differs from per-step (b): {same[:5]}, validation {same_val}")
    shutil.rmtree(work, ignore_errors=True)
    return out["c"]["window_traced_launches"]


FAST128 = [*["experiment=chest_base_vae", "model.resolution=128", "data.size=128"],
           "training.max_epochs=1", "training.log_images_every_n_epochs=0", "early_stopping.enabled=false"]
FAST128_CHUNK = 8
# from 128, doubling towards the cap of 512 within three probes (whether 512
# fits depends on what the run holds on the card by then)
FAST128_AUTOBATCH = ["data.batch_size=auto", "+training.autobatch_start=128", "+training.autobatch_max=512",
                     "+training.autobatch_probes=3"]
REMAT_GRAD_REL = 5e-4


def phase_fast128() -> dict:
    """The Trainer's memory planning and fused chunks on experiment=
    chest_base_vae at 128², full width (B4/B5 at 7 sites): batch_size=auto
    (the probe's trajectory, the size and its seconds; remat 'full' under
    it, as JAX); remat=auto at bs 64 (each probed rung's peak and the
    decision); one forward and backward at the rungs block and full against
    no remat (ms, peak, the gradients' relative L2 within REMAT_GRAD_REL,
    and whether bit for bit); accumulate_grad_batches=2 against 1 (ms,
    peak); and a fused chunk of FAST128_CHUNK steps against as many
    per-step calls from the same state: bit for bit, ms a step and the idle
    share both ways, 7 + 7 B4/B5 launches a step under replay."""
    t_phase = time.perf_counter()
    work = os.path.join(WORK, "fast128")
    data = f"data_dir={os.path.join(WORK, 'data')}"
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        t = fast_trainer(work, [*FAST128, data, *FAST128_AUTOBATCH])
    probe_lines = [ln for ln in log.getvalue().splitlines() if ln.startswith(("autobatch", "remat"))]
    emit({"phase": "fast128", "batch_size_auto": t.datamodule.batch_size, "trajectory": probe_lines,
          "seconds_trainer_with_probe": time.perf_counter() - t0})
    del t
    gc.collect()
    torch.cuda.empty_cache()

    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        t = fast_trainer(work, [*FAST128, data, f"data.batch_size={BASE128_BATCH}", "+model.remat=auto",
                                "+data.device_cache=true"])
    emit({"phase": "fast128", "remat_auto_batch": BASE128_BATCH, "decision": t._resolved_remat,
          "probed_peak_gib": {str(k): v / 2**30 for k, v in t.remat_peaks.items()},
          "lines": [ln for ln in log.getvalue().splitlines() if ln.startswith("autoremat")],
          "seconds_trainer_with_probe": time.perf_counter() - t0})
    feeder = t._feeder("train", True, True)
    batch = feeder.assemble(feeder.epoch_perm(0), torch.tensor(0, device=CARD))
    loss_cfg = dict(t.loss_cfg)
    grads_of = build_loss_and_grads(t.model, loss_cfg, augment=True, max_channels=1)
    rows, base = {}, None
    for rung in (False, "block", "full"):
        set_remat(t.model, rung)

        def fwd_bwd():
            return grads_of(t.state, batch, torch.Generator(device=CARD).manual_seed(5))[1]

        fwd_bwd()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(fwd_bwd, reps=3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        flat = torch.cat([g.float().reshape(-1) for g in fwd_bwd()]).cpu()  # on the host: no rung's peak holds another's
        base = flat if base is None else base
        rows[str(rung)] = {"ms": ms, "peak_gib": peak, "grad_rel_l2": torch_rel_l2(flat, base),
                           "bitwise": torch.equal(flat, base)}
    emit({"phase": "fast128", "remat_rungs": rows, "batch": BASE128_BATCH, "bar": REMAT_GRAD_REL})
    if any(r["grad_rel_l2"] > REMAT_GRAD_REL for r in rows.values()):
        raise AssertionError(f"fast128: a remat rung's gradients differ: {rows}")
    set_remat(t.model, t._resolved_remat)
    del base, flat
    torch.cuda.empty_cache()

    snap, step0 = state_snapshot(t.state), t.state.step
    acc = {}
    for k in (1, 2):
        step = build_train_step(t.model, loss_cfg, t.tx, augment=True, max_channels=1,
                                accumulate_grad_batches=k)
        gen = torch.Generator(device=CARD)

        def one():
            gen.manual_seed(3)
            t.state = restore_state(t.state, snap, step0)
            step(t.state, batch, gen)

        one()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        acc[k] = {"ms": cuda_ms(one, reps=3), "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit({"phase": "fast128", "accumulate_grad_batches": acc, "batch": BASE128_BATCH})

    seed_of = lambda s: fold_in(t.seed, 0xBEEF, s)  # noqa: E731  the Trainer's train stream
    t.state = restore_state(t.state, snap, step0)
    perm = feeder.epoch_perm(0)
    gen = torch.Generator(device=CARD)
    reset_launches()
    for i in range(FAST128_CHUNK):
        gen.manual_seed(seed_of(t.state.step))
        t.state, _ = t.train_step(t.state, feeder.assemble(perm, torch.tensor(i, device=CARD)), gen)
    torch.cuda.synchronize()
    loop_counts, loop_end = launches(), state_snapshot(t.state)
    t.state = restore_state(t.state, snap, step0)
    run = build_chunk_runner(t.train_step, feeder, torch.Generator(device=CARD), seed_of)
    reset_launches()
    t.state, _ = run(t.state, 0, 0, FAST128_CHUNK)
    torch.cuda.synchronize()
    fused_counts, fused_end = launches(), state_snapshot(t.state)
    differ = [k for k in loop_end if not torch.equal(loop_end[k], fused_end[k])]
    want = want_launches(attention_fwd=BASE128_SITES * FAST128_CHUNK, attention_bwd=BASE128_SITES * FAST128_CHUNK)
    row = {"phase": "fast128", "chunk": FAST128_CHUNK, "fused_equals_per_step_bitwise": not differ,
           "differing": differ[:5], "launches_per_step_calls": loop_counts, "launches_fused": fused_counts}
    if differ or fused_counts != want or loop_counts != want:
        emit(row)
        raise AssertionError(f"fast128: fused chunk vs per-step calls: {row}")
    # the steady state both ways: replays only, and per-step calls, each
    # window's launches read from its trace as well as from the wrappers
    per_call = {name: KERNELS_PER_CALL[name] for name in ("attention_fwd", "attention_bwd")}
    timing = {}
    for how in ("per_step", "fused"):
        if how == "fused":
            def window():
                t.state, m = run(t.state, 0, 0, FAST128_CHUNK)
                next(iter(m.values())).item()
        else:
            def window():
                for i in range(FAST128_CHUNK):
                    gen.manual_seed(seed_of(t.state.step))
                    t.state, m = t.train_step(t.state, feeder.assemble(perm, torch.tensor(i, device=CARD)),
                                              gen)
                next(iter(m.values())).item()
        window()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        reset_launches()
        prof = device_breakdown(window, wall)
        traced = traced_launches(prof["calls_by_layer"], per_call)
        want = {name: BASE128_SITES * FAST128_CHUNK for name in per_call}
        if traced != want or {k: launches()[k] for k in want} != want:
            raise AssertionError(f"fast128 ({how}): the trace shows {traced} calls, the wrappers counted "
                                 f"{launches()}, want {want}: {prof['calls_by_layer']}")
        timing[how] = {"ms_per_step": wall / FAST128_CHUNK, "idle_share": prof["idle_share"],
                       "device_busy_ms": prof["device_busy_ms"], "traced_launches": traced,
                       "images_per_sec": BASE128_BATCH * FAST128_CHUNK / wall * 1e3}
    row.update(timing=timing, seconds=time.perf_counter() - t_phase)
    emit(row)
    del t, run, feeder
    gc.collect()
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return timing["fused"]["traced_launches"]


# ------------------------------------------------ slice 14: run surface ---- #

# the quick CVAE experiment of every new phase (28², bs 16, five synthetic
# datasets, MEDVAE_FUSED_GN=1), one synthetic data directory for all of them
QUICK28 = ["experiment=multi_modal_cvae_quick", "training.log_every_n_steps=100000",
           "training.log_images_every_n_epochs=0", "early_stopping.enabled=false"]
QUICK28_NAME = "multi_modal_cvae_quick"
SWEEP_BATCHES = 8
SWEEP_LRS = ("1e-3", "2e-3", "1e-3")  # job 2 repeats job 0's overrides
RESILIENT_BATCHES, RESILIENT_EVERY = 12, 4  # 2 epochs of 12 steps, `last` every 4
PROFILE_WINDOW = 20  # debug.profile traces the steps [0, min(20, steps_per_epoch))
OPTIONS_BATCHES = 24
BENCH_SERVE_REPS = 3  # --reps, with --min-seconds 0, so the calls (and launches) are known
SERVE_MS_BAR = 0.10  # bench_serve's bucket-32 reconstruct against the serve phase's
SUMMARY: dict = {}  # numbers one phase hands a later one (the serve and train phases')


def quick_data() -> str:
    return f"data_dir={os.path.join(WORK, 'quick28_data')}"


def quick_sites() -> dict:
    """GroupNorm+SiLU sites of the quick CVAE: the whole model (a train
    step's B6 and B7 calls each), its encoder and its decoder (serving);
    and the kernels a B6 and a B7 call launch at its bs-16 shapes."""
    cfg = compose(cli_train.default_config_dir(), "config", [QUICK28[0]])
    model = build_model(dict(cfg["model"]), "bf16", "meta", train=True)
    shapes = gn_swish_shapes(model, torch.zeros((16, 28, 28, 3), device="meta"),
                             condition=torch.zeros((16, model.cond_dim), device="meta"))
    return {"model": gn_swish_sites(model), "encoder": gn_swish_sites(model.encoder),
            "decoder": gn_swish_sites(model.decoder),
            "per_call": {name: gn_kernels_per_call(name, shapes) for name in ("gn_swish_fwd", "gn_swish_bwd")}}


def quick_eval_batches(split: str) -> int:
    """Batches (bs 16) of the quick experiment's `split`, its whole split."""
    cfg = compose(cli_train.default_config_dir(), "config", [QUICK28[0], quick_data()])
    dm = instantiate(dict(cfg["data"]))
    dm.setup(None)
    return -(-len(dm.split(split)) // int(dm.batch_size))


def final_snapshot(checkpoint_dir: str) -> dict:
    path = os.path.join(checkpoint_dir, QUICK28_NAME, f"{QUICK28_NAME}_final", "checkpoint.pt")
    return torch.load(path, map_location="cpu", weights_only=True)["state_dict"]


def differing(a: dict, b: dict) -> list:
    return [k for k in a if not torch.equal(a[k], b[k])]


def phase_sweep() -> dict:
    """`cli/train.py -m` on the quick experiment, MEDVAE_FUSED_GN=1: three
    jobs of SWEEP_BATCHES steps, validation and test, swept on
    training.optimizer.lr (SWEEP_LRS: job 2 repeats job 0). Gates: three
    `ok` jobs in summary.json with JAX's keys, each job's B6/B7 launches
    sites x (steps + eval batches) and sites x steps (read at each job's end;
    the CLI zeroes the counters before each job), job 2 equal to job 0 bit
    for bit in its validation and test metrics and final params."""
    work = os.path.join(WORK, "sweep")
    args = ["-m", *QUICK28, f"device={CARD}", f"work_dir={work}", quick_data(), "training.max_epochs=1",
            f"+training.limit_train_batches={SWEEP_BATCHES}", "training.optimizer.lr=" + ",".join(SWEEP_LRS)]
    per_job = []
    run_one = cli_train._run_one

    def counted(overrides):
        out = run_one(overrides)
        torch.cuda.synchronize()
        per_job.append({k: launches()[k] for k in gs.launches})
        return out

    t0 = time.perf_counter()
    with fused_gn(True), mock.patch.object(cli_train, "_run_one", counted), \
            contextlib.redirect_stdout(io.StringIO()) as printed:
        rc = cli_train.main(args)
    seconds = time.perf_counter() - t0
    (stamp,) = os.listdir(os.path.join(work, "logs", "multirun"))
    sweep_dir = os.path.join(work, "logs", "multirun", stamp)
    with open(os.path.join(sweep_dir, "summary.json")) as f:
        summary = json.load(f)
    sites = quick_sites()["model"]
    evals = quick_eval_batches("val") + quick_eval_batches("test")
    want = {"gn_swish_fwd": sites * (SWEEP_BATCHES + evals), "gn_swish_bwd": sites * SWEEP_BATCHES}
    drop = "epoch_time_sec"
    same_val = ({k: v for k, v in summary[0]["val"].items() if k != drop}
                == {k: v for k, v in summary[2]["val"].items() if k != drop}) and summary[0]["test"] == summary[2]["test"]
    diff = differing(*(final_snapshot(os.path.join(sweep_dir, str(j), "checkpoints")) for j in (0, 2)))
    row = {"phase": "sweep", "rc": rc, "jobs": len(summary), "seconds": seconds,
           "job_seconds": [r["seconds"] for r in summary], "labels": [r["label"] for r in summary],
           "status": [r["status"] for r in summary], "keys": sorted(summary[0]),
           "val_loss": [r["val"]["val/loss"] for r in summary], "launches_by_job": per_job,
           "want_launches_a_job": want, "gn_sites": sites, "eval_batches": evals,
           "job2_equals_job0_metrics": same_val, "job2_equals_job0_params": not diff,
           "table": printed.getvalue().split("Multirun summary")[-1].strip().splitlines()}
    emit(row)
    if (rc != 0 or row["status"] != ["ok"] * 3 or row["keys"] != sorted(
            ["job", "overrides", "label", "status", "val", "test", "seconds"])
            or any(c != want for c in per_job) or not same_val or diff):
        raise AssertionError(f"sweep: {row}")
    shutil.rmtree(work, ignore_errors=True)
    return {k: sum(c[k] for c in per_job) for k in gs.launches}


# a training child of the supervised run: the train CLI, then (on a normal
# exit) the kernel wrappers' counts of this process written to argv[1]
RESILIENT_CHILD = """
import json, sys
from medvae_tpu_torch.cli import train
from medvae_tpu_torch.ops import attention, flash_attention, groupnorm_swish
code = train.main(sys.argv[2:])
if code == 0:
    with open(sys.argv[1], "w") as f:
        json.dump({**flash_attention.launches, **groupnorm_swish.launches, **attention.launches}, f)
raise SystemExit(code)
"""


def phase_resilient() -> dict:
    """`cli/train_resilient.py:supervise` on the quick experiment (2 epochs
    of RESILIENT_BATCHES steps, `last` every RESILIENT_EVERY steps, the
    test split at the end, MEDVAE_FUSED_GN=1), through an injected runner
    that starts each training child (the train CLI's `main` in a fresh
    interpreter, RESILIENT_CHILD) and SIGKILLs the first once its `last`
    exists: the supervisor relaunches it once with +resume=true. Gates: exit
    0, one restart, resume appended once, the resumed child's B6/B7 launches
    sites x (steps left after `last` + test batches) and sites x steps left,
    the final params equal an uninterrupted run's (in this process, its
    launches sites x (all steps + test batches)) bit for bit. Returns the
    resumed child's launches and the uninterrupted run's."""
    import signal

    from medvae_tpu_torch.cli import train_resilient

    work, ref = os.path.join(WORK, "resilient"), os.path.join(WORK, "resilient_ref")
    common = [*QUICK28, f"device={CARD}", quick_data(), "training.max_epochs=2",
              "training.check_val_every_n_epoch=1000", f"+training.limit_train_batches={RESILIENT_BATCHES}",
              f"+checkpointing.every_n_steps={RESILIENT_EVERY}"]
    last = os.path.join(work, "logs", "checkpoints", QUICK28_NAME, "last", "checkpoint.pt")
    env = dict(os.environ, MEDVAE_FUSED_GN="1")
    launched, killed_at, counts_at = [], [], []
    os.makedirs(WORK, exist_ok=True)
    log_path = os.path.join(WORK, "resilient_children.log")

    def runner(argv):
        launched.append(list(argv))
        counts_at.append(os.path.join(WORK, f"resilient_child{len(launched)}_launches.json"))
        with open(log_path, "a") as log:
            proc = subprocess.Popen([sys.executable, "-c", RESILIENT_CHILD, counts_at[-1], *argv], stdout=log,
                                    stderr=subprocess.STDOUT, env=env, cwd=REPO)
            if len(launched) == 1:  # the crash comes from outside the package
                while proc.poll() is None and not os.path.exists(last):
                    time.sleep(0.05)
                if proc.poll() is None:
                    proc.send_signal(signal.SIGKILL)
                    killed_at.append(time.perf_counter() - t0)
            return proc.wait()

    t0 = time.perf_counter()
    code = train_resilient.supervise([*common, f"work_dir={work}"], runner=runner, backoff_s=0.5)
    seconds = time.perf_counter() - t0
    child = [json.load(open(p)) if os.path.exists(p) else None for p in counts_at]
    reset_launches()
    t1 = time.perf_counter()
    with fused_gn(True), contextlib.redirect_stdout(io.StringIO()):
        rc = cli_train.main([*common, f"work_dir={ref}"])
    ref_seconds = time.perf_counter() - t1
    counts = {k: launches()[k] for k in gs.launches}
    with open(log_path) as f:
        resumed_line = [line.strip() for line in f if line.startswith("Resuming at optimizer step")]
    diff = differing(final_snapshot(os.path.join(work, "logs", "checkpoints")),
                     final_snapshot(os.path.join(ref, "logs", "checkpoints")))
    sites = quick_sites()["model"]
    steps, tests = 2 * RESILIENT_BATCHES, quick_eval_batches("test")
    want = {"gn_swish_fwd": sites * (steps + tests), "gn_swish_bwd": sites * steps}
    found = re.match(r"Resuming at optimizer step (\d+)", resumed_line[0]) if resumed_line else None
    resumed_at = int(found.group(1)) if found else None
    left = steps - resumed_at if resumed_at is not None else None
    want_child = (want_launches(gn_swish_fwd=sites * (left + tests), gn_swish_bwd=sites * left)
                  if left is not None else None)
    row = {"phase": "resilient", "exit_code": code, "launches_of_the_cli": len(launched),
           "restarts": len(launched) - 1, "killed_after_s": killed_at, "resume_appended": launched[-1][-1],
           "resumed": resumed_line, "resumed_at_step": resumed_at, "seconds": seconds,
           "children_launches": child, "want_resumed_child": want_child, "uninterrupted_seconds": ref_seconds,
           "final_params_equal_uninterrupted": not diff, "differing": diff[:5],
           "uninterrupted_launches": counts, "want": want}
    emit(row)
    if (code != 0 or rc != 0 or len(launched) != 2 or not killed_at or launched[1] != launched[0] + ["+resume=true"]
            or not resumed_line or diff or counts != want or child[0] is not None or child[-1] != want_child):
        raise AssertionError(f"resilient: {row}")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(ref, ignore_errors=True)
    return {"resilient": {k: child[-1][k] for k in gs.launches}, "resilient_reference": counts}


@contextlib.contextmanager
def bench_env(**values):
    before = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_bench_modes() -> dict:
    """medvae_tpu_torch.bench's BENCH_MODE=generate and pipeline (cached,
    and BENCH_CACHE=0) with MEDVAE_FUSED_GN=1 and BENCH_SECONDS=2: their
    JSON lines, and B6/B7 launches as derived (generate: the decoder's sites
    x calls, the warm-up's included; pipeline: sites x steps, the warm-up
    epoch's and the flop count's included)."""
    sites = gn_swish_sites(build_model(CVAE_BENCH, "bf16", "meta", train=True))
    dec_sites = gn_swish_sites(build_model(bench.GENERATE_MODEL, "bf16", "meta").decoder)
    epoch_steps = 8
    out, totals = {}, dict.fromkeys(gs.launches, 0)
    with fused_gn(True), bench_env(BENCH_SECONDS=2, BENCH_EPOCH_STEPS=epoch_steps):
        for tag, mode, cache in (("generate", bench.generation_bench, None),
                                 ("pipeline_cached", bench.pipeline_bench, "1"),
                                 ("pipeline_host", bench.pipeline_bench, "0")):
            with bench_env(BENCH_CACHE=cache or "1"):
                reset_launches()
                t0 = time.perf_counter()
                r = mode()
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            counts = launches()
            if tag == "generate":
                want = want_launches(gn_swish_fwd=dec_sites * (r["calls"] + 1))
            else:
                n = epoch_steps + 1 + r["steps"]  # warm-up epoch, the counted step, the timed ones
                want = want_launches(gn_swish_fwd=sites * n, gn_swish_bwd=sites * n)
            emit({"phase": "bench_modes", "mode": tag, "result": r, "launches": counts, "seconds": seconds})
            if counts != want:
                raise AssertionError(f"bench_modes {tag}: launches {counts}, want {want}")
            for k in totals:
                totals[k] += counts[k]
            out[tag] = r
            gc.collect()
            torch.cuda.empty_cache()
    return totals


def phase_bench_serve(flagship_engine) -> dict:
    """medvae_tpu_torch.cli.bench_serve's cells on both surfaces at
    --reps BENCH_SERVE_REPS --min-seconds 0: flagship224 on the serve
    phase's engine (its seeded weights), quick28 built from its experiment
    with MEDVAE_FUSED_GN=1. Every (method, bucket) ms and img/s, single-image
    p50/p99, MicroBatcher req/s and p50/p99. Gates: B1's launches on
    flagship224 and B6's on quick28 as derived from the calls; the
    MicroBatcher's a whole number of chunks, at most one a request;
    flagship224's bucket-32 reconstruct within SERVE_MS_BAR of the serve
    phase's median."""
    from medvae_tpu_torch.cli import bench_serve

    reps = BENCH_SERVE_REPS
    calls = reps + 2  # two warm calls, then reps
    single = max(reps, 50) + 2
    q = quick_sites()
    per_chunk = {"flagship224": ("flash_fwd", PER_CHUNK),
                 "quick28": ("gn_swish_fwd", {"reconstruct": q["encoder"] + q["decoder"], "encode": q["encoder"],
                                              "decode": q["decoder"], "sample": q["decoder"]})}
    results, totals = {"device": torch.cuda.get_device_name(0), "surfaces": []}, {}
    for name in ("flagship224", "quick28"):
        experiment, buckets = bench_serve.SURFACES[name]
        kernel, chunk = per_chunk[name]
        with fused_gn(name == "quick28"):
            engine = flagship_engine if name == "flagship224" else bench_serve.build_from_experiment(experiment, buckets)
            if tuple(engine.buckets) != tuple(buckets):
                raise AssertionError(f"bench_serve {name}: buckets {engine.buckets}, want {buckets}")
            reset_launches()
            t0 = time.perf_counter()
            r = bench_serve.bench_surface(name, engine, reps, 0.0)
            surface_counts = launches()
            per_bucket = sum(chunk.values()) * (1 + calls) + chunk["encode"]  # warm-up, the timed calls, the mean
            want = want_launches(**{kernel: len(buckets) * per_bucket + single * chunk["reconstruct"]})
            reset_launches()
            r["microbatcher"] = bench_serve.bench_microbatcher(engine, clients=16, per_client=8,
                                                               max_batch=bench_serve.MICROBATCH[name], max_delay_ms=2.0)
            mb = launches()[kernel]
            requests = r["microbatcher"]["requests"] + bench_serve.MICROBATCH[name]  # the warm-up's too
            r.update(experiment=experiment, seconds=time.perf_counter() - t0, launches=surface_counts,
                     microbatcher_launches={kernel: mb})
            results["surfaces"].append(r)
            emit({"phase": "bench_serve", **r})
            if surface_counts != want:
                raise AssertionError(f"bench_serve {name}: launches {surface_counts}, want {want}")
            if mb % chunk["reconstruct"] or not chunk["reconstruct"] <= mb <= requests * chunk["reconstruct"]:
                raise AssertionError(f"bench_serve {name}: the MicroBatcher launched {mb} {kernel}")
            totals[name] = surface_counts[kernel] + mb
            if name == "quick28":
                del engine
                gc.collect()
                torch.cuda.empty_cache()
    cell = next(c for c in results["surfaces"][0]["cells"] if c["method"] == "reconstruct" and c["bucket"] == 32)
    serve_ms = SUMMARY["serve_ms"][32]
    gap = abs(cell["ms_per_batch"] - serve_ms) / serve_ms
    emit({"phase": "bench_serve", "bucket32_reconstruct_ms": cell["ms_per_batch"], "serve_phase_ms": serve_ms,
          "relative_gap": gap, "bar": SERVE_MS_BAR})
    out_dir = os.path.join(REPO, "logs", "serve_bench")  # the CLI's default --out
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    if gap > SERVE_MS_BAR:
        raise AssertionError(f"bench_serve: bucket-32 reconstruct {cell['ms_per_batch']} ms against the serve "
                             f"phase's {serve_ms} ms")
    return totals


TOWERS_TIMED = 5


def phase_towers_bf16(state_dict) -> dict:
    """The flagship step of the `train` phase with loss.tower_dtype=bfloat16
    (LPIPS and the CLIP ViT in bf16, their params fp32): each loss term of
    step 0 against the fp32 towers' on the same state, batch and draws
    (relative difference), 2 warmup and TOWERS_TIMED timed steps with 5/5
    B1/flash_bwd launches each (ms, peak memory) beside the train phase's
    fp32-tower step, and the towers' own device time (torch.profiler) and
    event time, fp32 against bf16: LPIPS and CLIP forward and backward to the
    reconstruction at the step's shapes (bs 32, 224², bf16 images)."""
    from medvae_tpu_torch.losses.perceptual import BiomedCLIPLoss, LPIPSLoss

    torch.cuda.empty_cache()
    loss_bf16 = dict(FLAGSHIP_LOSS, tower_dtype="bfloat16")
    model, frozen = train_model(state_dict, "bf16", CARD)
    batch = synthetic_batch(TRAIN_BATCH, int(model.resolution), CARD)
    gen = torch.Generator(device=CARD)
    terms = {}
    for tag, cfg in (("fp32", FLAGSHIP_LOSS), ("bf16", loss_bf16)):
        model.load_state_dict(state_dict)
        tx = bench_optimizer()
        step = build_train_step(model, cfg, tx, augment=True, max_channels=3)
        _, metrics = step(create_train_state(model, tx, frozen), batch, gen.manual_seed(0))
        terms[tag] = {k.split("/", 1)[1]: float(v) for k, v in metrics.items()}
    rel = {k: abs(terms["bf16"][k] - v) / max(abs(v), 1e-30) for k, v in terms["fp32"].items()}
    model.load_state_dict(state_dict)
    tx = bench_optimizer()
    state = create_train_state(model, tx, frozen)
    step = build_train_step(model, loss_bf16, tx, augment=True, max_channels=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, times, totals = run_steps("towers_bf16", step, state, batch, gen.manual_seed(0), WARMUP_STEPS,
                                     TOWERS_TIMED, want_launches(**PER_TRAIN_STEP))
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state, step, tx
    g = torch.Generator(device=CARD).manual_seed(13)
    x = (torch.rand((TRAIN_BATCH, 224, 224, 3), generator=g, device=CARD) * 2 - 1).bfloat16()
    rec = (torch.rand((TRAIN_BATCH, 224, 224, 3), generator=g, device=CARD) * 2 - 1).bfloat16().requires_grad_(True)
    towers = {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        lp, bc = LPIPSLoss(dtype=dtype), BiomedCLIPLoss("vit", dtype=dtype)

        def both():
            torch.autograd.grad(0.1 * lp(frozen["lpips"], x, rec) + 0.1 * bc(frozen["clip"], x, rec), rec)

        device = device_kernels(both)
        towers[tag] = {"device_ms": sum(v[0] for v in device.values()), "kernels": sum(v[1] for v in device.values()),
                       "event_ms": cuda_ms(both, reps=5)}
    fp32 = SUMMARY["train"]
    row = {"phase": "towers_bf16", "batch": TRAIN_BATCH, "ms_per_step_median": statistics.median(times),
           "samples_ms": times, "peak_memory_gib": peak, "fp32_towers_ms_per_step_median": fp32["ms"],
           "fp32_towers_peak_memory_gib": fp32["peak_gib"], "loss_terms_fp32": terms["fp32"],
           "loss_terms_bf16": terms["bf16"], "loss_terms_rel_diff": rel, "towers_alone": towers}
    emit(row)
    del model, frozen, batch, x, rec
    gc.collect()
    torch.cuda.empty_cache()
    return totals


class NanFeeder:
    """A train feeder whose batch `at` carries a NaN image (a float image
    passes the step's uint8 cast); chip_smoke's own, so the NaN comes from
    outside the package."""

    def __init__(self, feeder, at: int):
        self.feeder, self.at, self.steps_per_epoch = feeder, at, feeder.steps_per_epoch

    def epoch(self, epoch: int):
        for i, batch in enumerate(self.feeder.epoch(epoch)):
            if i == self.at:
                image = batch["image_u8"].float()
                image[0] = float("nan")
                batch = dict(batch, image_u8=image)
            yield batch


def trace_kernel_calls(path: str) -> dict:
    """Kernel events of a Chrome trace by `_category`."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return dict(collections.Counter(_category(e.get("name", "")) for e in events if e.get("cat") == "kernel"))


def phase_options() -> None:
    """The Trainer's last options on the quick experiment, MEDVAE_FUSED_GN=1:
    debug.nan_checks (a clean run of OPTIONS_BATCHES/4 steps bit for bit the
    run without it; with NanFeeder's batch 2 it raises FloatingPointError
    and takes no third update); debug.profile (the trace of the first
    PROFILE_WINDOW steps holds sites x PROFILE_WINDOW B6 and B7 calls by
    its kernel events); data.normalize=false (one whole epoch, fused,
    finite losses and validation); SGD in a fused chunk of OPTIONS_BATCHES
    steps against per-step calls, bit for bit (params and the trace)."""
    work = os.path.join(WORK, "options")
    base = [*QUICK28, quick_data(), "training.max_epochs=1", "+data.device_cache=true"]
    q = quick_sites()
    sites, per_call = q["model"], q["per_call"]
    out = {}
    with fused_gn(True), contextlib.redirect_stdout(io.StringIO()):
        ends = {}
        for tag, extra in (("off", []), ("on", ["debug.nan_checks=true"])):
            t = fast_trainer(os.path.join(work, f"nan_{tag}"), [*base, "training.check_val_every_n_epoch=1000",
                                                                 f"+training.limit_train_batches={OPTIONS_BATCHES // 4}",
                                                                 "+training.fused_steps=off", *extra])
            t.fit()
            ends[tag] = state_snapshot(t.state)
        t = fast_trainer(os.path.join(work, "nan"), [*base, "training.check_val_every_n_epoch=1000",
                                                     f"+training.limit_train_batches={OPTIONS_BATCHES // 4}",
                                                     "debug.nan_checks=true"])
        t._feeders[("train", True, True)] = NanFeeder(t._feeder("train", True, True), at=2)
        try:
            t.fit()
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        out["nan_checks"] = {"clean_on_equals_off": not differing(ends["on"], ends["off"]), "raised": raised,
                             "steps_taken": t.state.step}
        t = fast_trainer(os.path.join(work, "profile"), [*base, "training.check_val_every_n_epoch=1000",
                                                         f"+training.limit_train_batches={OPTIONS_BATCHES}",
                                                         "debug.profile=true"])
        t.fit()
        calls = trace_kernel_calls(os.path.join(t.logger.dir, "profile", "trace.json"))
        out["profile"] = {"trace_calls": traced_launches(calls, per_call), "kernel_events": calls,
                          "want": {k: sites * PROFILE_WINDOW for k in per_call}}
        t = fast_trainer(os.path.join(work, "normalize"), [*base, "data.normalize=false", "+training.fused_steps=on",
                                                           "training.log_every_n_steps=64"])
        t0 = time.perf_counter()
        val = t.fit()
        with open(os.path.join(t.logger.dir, "metrics.jsonl")) as f:
            losses = [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]
        out["normalize_false"] = {"steps": t.state.step, "seconds": time.perf_counter() - t0, "train_losses": losses,
                                  "val_loss": val.get("val/loss"), "val_psnr": val.get("val/psnr")}
        sgd = {}
        for tag in ("off", "on"):
            t = fast_trainer(os.path.join(work, f"sgd_{tag}"), [*base, "training.optimizer.type=sgd",
                                                                "training.check_val_every_n_epoch=1000",
                                                                f"+training.limit_train_batches={OPTIONS_BATCHES}",
                                                                f"+training.fused_steps={tag}"])
            reset_launches()
            t.fit()
            sgd[tag] = (state_snapshot(t.state), {k: launches()[k] for k in gs.launches})
        out["sgd"] = {"fused_equals_per_step": not differing(sgd["on"][0], sgd["off"][0]),
                      "launches": {k: v[1] for k, v in sgd.items()}, "moments": len(t.state.opt_state.mu),
                      "second_moments": len(t.state.opt_state.nu)}
    emit({"phase": "options", **out})
    n = out["normalize_false"]
    if not (out["nan_checks"]["clean_on_equals_off"] and out["nan_checks"]["raised"]
            and "at train step 2" in out["nan_checks"]["raised"] and out["nan_checks"]["steps_taken"] == 2):
        raise AssertionError(f"options nan_checks: {out['nan_checks']}")
    if out["profile"]["trace_calls"] != out["profile"]["want"]:
        raise AssertionError(f"options profile: {out['profile']}")
    if not (n["steps"] > 0 and n["train_losses"] and np.isfinite(n["train_losses"]).all()
            and np.isfinite(n["val_loss"])):
        raise AssertionError(f"options normalize=false: {n}")
    want = {"gn_swish_fwd": sites * OPTIONS_BATCHES, "gn_swish_bwd": sites * OPTIONS_BATCHES}
    if not out["sgd"]["fused_equals_per_step"] or any(v != want for v in out["sgd"]["launches"].values()):
        raise AssertionError(f"options sgd: {out['sgd']}, want {want}")
    shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------ multi-device --

DP_STEPS = 3  # dp_flagship's steps each way
DP2_OVERRIDES = [*QUICK28, "mesh.data=2", "training.max_epochs=2", "+training.limit_train_batches=1",
                 "checkpointing.save_top_k=3"]
TP2_OVERRIDES = [*BASE128_OVERRIDES, "data.batch_size=8", "+model.remat=false", "early_stopping.enabled=false",
                 "training.log_images_every_n_epochs=0"]
# The parity runs of dp2_card and tp2_card, two ranks against one on the same
# global batch, each in fp32 and in bf16 compute (PARITY_PRECISIONS): SGD,
# since Adam's first step moves a param by ±lr whatever its gradient's
# size, so reduction-order noise that flips a small gradient's sign parts
# the runs by 2·lr; lr 1e-2, so that an update stands well above its
# param's fp32 spacing; dropout off, so that no draw depends on the rank;
# the noise pinned per global row (parity_batch)
PARITY = ["training.optimizer.type=sgd", "training.optimizer.lr=0.01", "model.dropout=0.0"]
PARITY_STEPS = 2
PARITY_PRECISIONS = ("fp32", "bf16")
# fp32 (no TF32): the CPU parity tests' bars, 2e-4 on outputs (the loss) and
# 5e-4 on gradients (grad_norm, and the SGD update, lr times the clipped
# gradient). bf16 rounds every activation and weight gradient, and the
# ranks round other partial sums, so its bar is bf16's own error: two ranks'
# bf16 update may stand at most PARITY_BF16_FACTOR times as far from one
# rank's fp32 update as one rank's bf16 update does
PARITY_FP32_BARS = {"train/loss": 2e-4, "train/grad_norm": 5e-4, "update": 5e-4}
PARITY_BF16_FACTOR = 2.0
DP2_PARITY = {"cvae": [*QUICK28, *PARITY],
              "flagship": ["experiment=disentangled_multi_modal_cvae_quick", *QUICK28[1:], *PARITY]}
TP2_PARITY = {"base128": [*TP2_OVERRIDES, *PARITY]}
RANK_CHILD_TIMEOUT = 300


def one_rank_group(tag: str):
    """A one-rank NCCL group of this process, on a file store under WORK."""
    store = os.path.join(WORK, f"{tag}_store")
    os.makedirs(WORK, exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    return core_mesh.init_distributed(CARD, init_method=f"file://{store}", rank=0, world_size=1)


def phase_dp_flagship(state_dict) -> dict:
    """The data-parallel step of the 224² flagship in a one-rank NCCL group
    against the plain step, bit for bit (module docstring)."""
    dist = one_rank_group("dp_flagship")
    try:
        mesh = core_mesh.create_mesh(core_mesh.MeshSpec(), dist)
        batch = synthetic_batch(TRAIN_BATCH, 224, CARD)
        want = want_launches(**PER_TRAIN_STEP)
        out, frozen = {}, None
        for kind in ("plain", "dp", "repeat"):
            model, frozen = train_model(state_dict, "bf16", CARD, frozen_from=frozen)
            tx = bench_optimizer()
            state = create_train_state(model, tx, frozen)
            step = (build_train_step(model, FLAGSHIP_LOSS, tx, augment=True, max_channels=3) if kind != "dp"
                    else shard_map_step.build_shard_map_train_step(model, FLAGSHIP_LOSS, tx, mesh, augment=True,
                                                                   max_channels=3))
            gen = torch.Generator(device=CARD).manual_seed(0)
            history: list = []
            state, times, totals = run_steps(f"dp_flagship_{kind}", step, state, batch, gen, 1, DP_STEPS - 1,
                                             want, history)
            out[kind] = {"params": {k: v.detach().clone() for k, v in state.params.items()},
                         "history": history, "ms": statistics.median(times), "launches": totals}
            del model, state, step
            torch.cuda.empty_cache()
        diff = max(float((out["dp"]["params"][k] - out["plain"]["params"][k]).abs().max())
                   for k in out["plain"]["params"])
        same = differing(out["dp"]["params"], out["plain"]["params"])
        repeat = differing(out["repeat"]["params"], out["plain"]["params"])
        row = {"phase": "dp_flagship", "world": dist.world, "backend": dist.backend, "batch": TRAIN_BATCH,
               "steps": DP_STEPS, "ms_per_step": out["dp"]["ms"], "plain_ms_per_step": out["plain"]["ms"],
               # the median of DP_STEPS - 1 steps a side: does not resolve the
               # collectives' cost at world 1 (PERF.md, PR 15)
               "ms_per_step_minus_plain": out["dp"]["ms"] - out["plain"]["ms"],
               "params_max_abs_diff": diff, "params_differing": len(same),
               "metrics_equal": out["dp"]["history"] == out["plain"]["history"],
               "card_repeat_params_differing": len(repeat),
               "card_repeat_metrics_equal": out["repeat"]["history"] == out["plain"]["history"],
               "launches": out["dp"]["launches"], "plain_launches": out["plain"]["launches"]}
        emit(row)
        if same or repeat or not row["metrics_equal"] or not row["card_repeat_metrics_equal"]:
            raise AssertionError(f"dp_flagship: the parallel step differs from the plain step: {row}")
        return out["dp"]["launches"]
    finally:
        core_mesh.shutdown()


def rank_child(argv) -> int:
    """A rank of a two-rank phase under torchrun (`chip_smoke.py --rank-child
    <kind> <out_dir> ...`): `train <overrides...>` runs cli/train.py;
    `parity <json>` runs `parity_run` for each [name, precision,
    overrides] in turn, rank 0 saving each one's params to
    <out_dir>/<name>_<precision>.pt. Each writes its
    counts, seconds and peak memory to <out_dir>/rank<r>.json."""
    kind, out_dir, rest = argv[0], argv[1], argv[2:]
    rank = int(os.environ["RANK"])
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    row = {"rank": rank}
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        if kind == "train":
            row["rc"] = cli_train.main(rest)
        else:
            row["parity"] = {}
            for name, precision, overrides in json.loads(rest[0]):
                tag = f"{name}_{precision}"
                run = parity_run(name, overrides)
                if rank == 0:
                    torch.save({k: run.pop(k) for k in ("init", "final")}, os.path.join(out_dir, f"{tag}.pt"))
                row["parity"][tag] = {k: v for k, v in run.items() if k not in ("init", "final")}
    torch.cuda.synchronize()
    row.update(seconds=time.perf_counter() - t0, launches=launches(),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, backend=core_mesh.current().backend,
               printed_tail=printed.getvalue().splitlines()[-3:])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(row, f)
    return 0 if row.get("rc", 0) == 0 else 1


def tp2_batch() -> dict:
    """tp2_card's global batch of 8 128² chest images."""
    rs = np.random.RandomState(5)
    return {"image_u8": torch.from_numpy(rs.randint(0, 255, (8, 128, 128, 1), np.uint8)),
            "modality_idx": torch.zeros((8,), dtype=torch.int32), "channels": torch.ones((8,), dtype=torch.int32)}


def parity_batch(trainer, fixed=None) -> dict:
    """This rank's rows of the run's global batch on its device, with the
    reparameterization noise pinned per global row (numpy seed 7): the
    rows of `fixed()` when given, else the first batch of the Trainer's own
    train feeder (which gives each rank its rows of JAX's global batch)."""
    model = trainer.model
    if fixed is not None:
        batch = fixed()
        n = int(batch["image_u8"].shape[0])
        rows = trainer.mesh.local_rows(n)
        batch = {k: v[rows] for k, v in batch.items()}
    else:
        n = int(trainer.datamodule.batch_size)
        rows = trainer.mesh.local_rows(n)
        batch = next(iter(trainer._feeder("train", True, True).epoch(0)))
    r, zdim = model.encoder_out_res, getattr(model, "total_latent_dim", model.latent_dim)
    noise = torch.from_numpy(np.random.RandomState(7).randn(n, r, r, zdim).astype(np.float32))
    return {**{k: v.to(trainer.device) for k, v in batch.items()}, "noise": noise[rows].to(trainer.device)}


PARITY_BATCHES = {"base128": tp2_batch}  # by run name; the others take their feeder's first batch


def parity_run(name: str, overrides: list) -> dict:
    """PARITY_STEPS of the Trainer's own step (`overrides` composed, the
    step as the Trainer built it for its mesh) on `parity_batch` (the run
    `name`'s entry of PARITY_BATCHES, if any), each step's
    generator seeded with its index: the full params before and after (CPU,
    gathered over the model group), each step's metrics, the kernels'
    counts over the steps, and this rank's bytes of params and moments."""
    t0 = time.perf_counter()
    trainer = Trainer(compose(cli_train.default_config_dir(), "config", overrides))
    batch = parity_batch(trainer, PARITY_BATCHES.get(name))
    seconds = {"setup": time.perf_counter() - t0}

    def full() -> dict:
        return {k: trainer.layout.full(p, p).detach().cpu().clone() for k, p in trainer.state.params.items()}

    t0 = time.perf_counter()
    init = full()
    seconds["gather"] = time.perf_counter() - t0
    gen = torch.Generator(device=trainer.device)
    reset_launches()
    history = []
    t0 = time.perf_counter()
    for i in range(PARITY_STEPS):
        gen.manual_seed(i)
        trainer.state, metrics = trainer.train_step(trainer.state, batch, gen)
        history.append({k: float(v) for k, v in metrics.items()})
    counts = launches()
    seconds["steps"] = time.perf_counter() - t0
    params = list(trainer.state.params.values())
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    out = {"init": init, "final": full(), "seconds": seconds, "history": history, "launches": counts,
           "param_bytes": nbytes(params),
           "moment_bytes": nbytes(trainer.state.opt_state.mu + trainer.state.opt_state.nu),
           "sharded_params": sum(trainer.layout.shard_of(p) is not None for p in params),
           "rows": int(batch["image_u8"].shape[0])}
    del trainer
    gc.collect()
    return out


def parity_update(run: dict) -> torch.Tensor:
    """A parity run's update over every leaf, final minus initial params
    (in fp32, exact where a step moved a param by less than its size), as
    fp64 on the card when there is one."""
    device = CARD if torch.cuda.is_available() else "cpu"
    return torch.cat([(run["final"][k] - run["init"][k]).reshape(-1).to(device)
                      for k in sorted(run["init"])]).double()


def parity_gate(two: dict, one: dict) -> dict:
    """Two ranks' parity runs against one rank's, `two` and `one` by
    precision (two's params are rank 0's, gathered): the same initial params
    bit for bit; in fp32 the updates' relative L2 and each step's loss and
    grad_norm within PARITY_FP32_BARS; in bf16 the two ranks' update within
    PARITY_BF16_FACTOR times one rank's bf16 distance from one rank's fp32
    update. A step that took no update, half of it or another one reads far
    past both (PERF.md, PR 15's planted faults)."""
    u = {(who, p): parity_update(r) for who, runs in (("two", two), ("one", one)) for p, r in runs.items()}

    def rel(a: torch.Tensor, b: torch.Tensor) -> float:
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    hist = {key: [abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
                  for a, b in zip(two["fp32"]["history"], one["fp32"]["history"])]
            for key in ("train/loss", "train/grad_norm")}
    row = {"init_differing": {p: len(differing(two[p]["init"], one[p]["init"])) for p in PARITY_PRECISIONS},
           "update_norm": {f"{who}_{p}": float(torch.linalg.vector_norm(v)) for (who, p), v in u.items()},
           "fp32": {"update_rel_l2": rel(u["two", "fp32"], u["one", "fp32"]),
                    **{f"{k.split('/')[1]}_rel": v for k, v in hist.items()}, "bars": PARITY_FP32_BARS},
           "bf16": {"two_from_fp32": rel(u["two", "bf16"], u["one", "fp32"]),
                    "one_from_fp32": rel(u["one", "bf16"], u["one", "fp32"]),
                    "two_from_one": rel(u["two", "bf16"], u["one", "bf16"]), "factor": PARITY_BF16_FACTOR}}
    f, b = row["fp32"], row["bf16"]
    row["ok"] = bool(not any(row["init_differing"].values()) and all(v > 0 for v in row["update_norm"].values())
                     and f["update_rel_l2"] <= PARITY_FP32_BARS["update"]
                     and all(len(r["history"]) == PARITY_STEPS for r in (*two.values(), *one.values()))
                     and all(v <= PARITY_FP32_BARS[k] for k, vs in hist.items() for v in vs)
                     and b["two_from_fp32"] <= PARITY_BF16_FACTOR * b["one_from_fp32"])
    del u
    return row


@contextlib.contextmanager
def ranks_started(tag: str, kind: str, args: list):
    """Two ranks of `rank_child` on the card under torchrun, started with
    the switch on and running while the block runs (this process goes on
    with other work); yields a function that waits for them, within
    RANK_CHILD_TIMEOUT of their start, and returns every rank's row. A
    rank's non-zero exit fails the phase; ranks still running when the
    block ends are killed with their torchrun."""
    out_dir = os.path.join(WORK, f"{tag}_ranks")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           os.path.abspath(__file__), "--rank-child", kind, out_dir, *args]
    log_path = os.path.join(out_dir, "torchrun.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
                                env=dict(os.environ, MEDVAE_FUSED_GN="1"))

    def rows() -> list:
        try:
            proc.wait(timeout=max(1.0, RANK_CHILD_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"{tag}: the ranks ran past {RANK_CHILD_TIMEOUT} s") from None
        if proc.returncode != 0:
            with open(log_path) as f:
                raise AssertionError(f"{tag}: torchrun exited {proc.returncode}:\n{f.read()[-9000:]}")
        out = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out

    try:
        yield rows
    finally:
        if proc.poll() is None:
            proc.terminate()  # torchrun stops its ranks on SIGTERM
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def torchrun_ranks(tag: str, kind: str, args: list) -> list:
    """`ranks_started`, waited for at once."""
    with ranks_started(tag, kind, args) as rows:
        return rows()


def one_rank_runs(work: str, runs: dict) -> dict:
    """Each of `runs` ({name: overrides}) in each of PARITY_PRECISIONS on
    one rank in this process, with the switch on: {name: {precision:
    parity_run's output}}."""
    one = {name: {} for name in runs}
    for name, overrides in runs.items():
        for p in PARITY_PRECISIONS:
            with fused_gn(True), contextlib.redirect_stdout(io.StringIO()):
                one[name][p] = parity_run(name, [*overrides, f"precision={p}", f"work_dir={work}/one_{name}_{p}"])
            gc.collect()
            torch.cuda.empty_cache()
    return one


def parity_results(ranks_dir: str, ranks: list, one: dict) -> dict:
    """Each run of `one` against its two-rank run (rank 0's params from
    `ranks_dir`, every rank's row from `ranks`): {name: {"ranks":
    {precision: each rank's parity row}, "one": one[name], "gate":
    parity_gate's row, "seconds": each side's}}."""
    out = {}
    for name in one:
        two, rows = {}, {}
        for p in PARITY_PRECISIONS:
            two[p] = torch.load(os.path.join(ranks_dir, f"{name}_{p}.pt"), weights_only=True)
            rows[p] = [r["parity"][f"{name}_{p}"] for r in ranks]
            two[p]["history"] = rows[p][0]["history"]
        out[name] = {"ranks": rows, "one": one[name], "gate": parity_gate(two, one[name]),
                     "seconds": {p: {"two_ranks": [r["seconds"] for r in rows[p]], "one_rank": one[name][p]["seconds"]}
                                 for p in PARITY_PRECISIONS}}
        del two
        gc.collect()
    return out


def dp2_snapshot(checkpoint_dir: str, name: str) -> dict:
    path = os.path.join(checkpoint_dir, QUICK28_NAME, name, "checkpoint.pt")
    return torch.load(path, map_location="cpu", weights_only=True)["state_dict"]


def quick_flagship_sites() -> int:
    cfg = compose(cli_train.default_config_dir(), "config", [DP2_PARITY["flagship"][0]])
    return gn_swish_sites(build_model(dict(cfg["model"]), "bf16", "meta", train=True))


def parity_losses(run: dict) -> dict:
    """Each step's loss and grad_norm of a parity run, by precision: rank 0's
    and one rank's."""
    return {f"{key.split('/')[1]}_{p}": {"two_ranks": [h[key] for h in run["ranks"][p][0]["history"]],
                                         "one_rank": [h[key] for h in run["one"][p]["history"]]}
            for p in PARITY_PRECISIONS for key in ("train/loss", "train/grad_norm")}


def phase_two_ranks() -> dict:
    """dp2_card and tp2_card (module docstring), sharing the card's time:
    one torchrun of two ranks takes every parity run (the quick CVAE and
    flagship with mesh.data=2, then the 128² BaseVAE with mesh.model=2)
    while two more ranks take the cli/train.py runs in turn and this
    process the DP runs' one-rank side; then the TP runs' one-rank side
    (after the ranks, whose fp32 128² steps hold ~21 GiB each). Emits both
    rows; returns each phase's launches."""
    work = os.path.join(WORK, "two_ranks")
    shutil.rmtree(work, ignore_errors=True)
    dp_common = [f"device={CARD}", quick_data()]
    # one data dir, so that the synthetic 128² splits are made once and read back
    tp_common = [f"device={CARD}", f"data_dir={os.path.join(WORK, 'tp2_data')}"]
    dp_runs = {name: [*o, *dp_common] for name, o in DP2_PARITY.items()}
    tp_runs = {name: [*o, *tp_common] for name, o in TP2_PARITY.items()}
    spec = [[name, p, [*o, f"precision={p}", f"work_dir={work}/two_{name}_{p}", mesh]]
            for runs, mesh in ((dp_runs, "mesh.data=2"), (tp_runs, "mesh.model=2"))
            for name, o in runs.items() for p in PARITY_PRECISIONS]
    ckpts = os.path.join(work, "full", "logs", "checkpoints")
    seconds, t_phase = {}, time.perf_counter()
    with ranks_started("parity", "parity", [json.dumps(spec)]) as parity_wait:
        t0 = time.perf_counter()
        with ranks_started("dp2_full", "train", [*DP2_OVERRIDES, *dp_common, f"work_dir={work}/full"]) as full_wait:
            dp_one = one_rank_runs(work, dp_runs)
            seconds["dp_one_rank"] = time.perf_counter() - t0
            full = full_wait()
        (step1,) = [n for n in os.listdir(os.path.join(ckpts, QUICK28_NAME)) if n.startswith("step_00000001")]
        resumed = torchrun_ranks("dp2_resume", "train", [*DP2_OVERRIDES, *dp_common, f"work_dir={work}/resume",
                                                         f"+resume_from={os.path.join(ckpts, QUICK28_NAME, step1)}"])
        seconds["cli_runs"] = time.perf_counter() - t0
        parity_ranks = parity_wait()
        seconds["parity_ranks"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    tp_one = one_rank_runs(work, tp_runs)
    seconds["tp_one_rank"] = time.perf_counter() - t0
    ranks_dir = os.path.join(WORK, "parity_ranks")
    dp = parity_results(ranks_dir, parity_ranks, dp_one)
    tp = parity_results(ranks_dir, parity_ranks, tp_one)
    seconds["total"] = time.perf_counter() - t_phase
    resumed_final = dp2_snapshot(os.path.join(work, "resume", "logs", "checkpoints"), f"{QUICK28_NAME}_final")
    full_final = dp2_snapshot(ckpts, f"{QUICK28_NAME}_final")
    common_row = {"ranks": 2, "backend": full[0]["backend"], "seconds": seconds,
                  "parity_rank_seconds": [r["seconds"] for r in parity_ranks],
                  "parity_rank_peak_gib": [r["peak_gib"] for r in parity_ranks]}

    # dp2_card
    sites = quick_sites()["model"]
    flag_sites = quick_flagship_sites()
    val, test = quick_eval_batches("val"), quick_eval_batches("test")
    want_full = {"gn_swish_fwd": sites * (2 + 2 * val + test), "gn_swish_bwd": sites * 2}
    want_resume = {"gn_swish_fwd": sites * (1 + val + test), "gn_swish_bwd": sites}
    want_parity = {name: {k: s * PARITY_STEPS for k in gs.launches}
                   for name, s in (("cvae", sites), ("flagship", flag_sites))}
    got_full = [{k: r["launches"][k] for k in gs.launches} for r in full]
    got_resume = [{k: r["launches"][k] for k in gs.launches} for r in resumed]
    # by run and precision, each rank's
    got_parity = {name: {p: [{k: r["launches"][k] for k in gs.launches} for r in rows]
                         for p, rows in run["ranks"].items()} for name, run in dp.items()}
    parity_counts = [c for by_p in got_parity.values() for cs in by_p.values() for c in cs]
    row = {"phase": "dp2_card", **common_row, "global_batch": 16,
           "rank_seconds": [[r["seconds"] for r in full], [r["seconds"] for r in resumed]],
           "rank_peak_gib": [[r["peak_gib"] for r in full], [r["peak_gib"] for r in resumed]],
           "resume_from": step1, "resume_differing": differing(resumed_final, full_final),
           "parity": {name: {"rows_by_rank": [r["rows"] for r in run["ranks"]["fp32"]], "gate": run["gate"],
                             "seconds": run["seconds"], **parity_losses(run)} for name, run in dp.items()},
           "launches_full_by_rank": got_full, "want_full": want_full,
           "launches_resume_by_rank": got_resume, "want_resume": want_resume,
           "launches_parity_by_rank": got_parity, "want_parity": want_parity,
           "gn_sites": {"cvae": sites, "flagship": flag_sites}, "eval_batches": {"val": val, "test": test}}
    emit(row)
    if (row["resume_differing"] or not all(p["gate"]["ok"] for p in row["parity"].values())
            or any(c != want_full for c in got_full) or any(c != want_resume for c in got_resume)
            or any(c != want_parity[name] for name, by_p in got_parity.items() for cs in by_p.values() for c in cs)):
        raise AssertionError(f"dp2_card: {row}")
    dp2_counts = {k: sum(c[k] for c in got_full + got_resume + parity_counts) for k in gs.launches}

    # tp2_card
    run = tp["base128"]
    sites = gn_swish_sites(build_model(dict(base128_config()["model"]), "bf16", "meta", train=True))
    want = {"attention_fwd": BASE128_SITES * PARITY_STEPS, "attention_bwd": BASE128_SITES * PARITY_STEPS,
            "gn_swish_fwd": sites * PARITY_STEPS, "gn_swish_bwd": sites * PARITY_STEPS}
    got = {p: [{k: r["launches"][k] for k in want} for r in rows] for p, rows in run["ranks"].items()}
    bf16 = run["ranks"]["bf16"]
    row = {"phase": "tp2_card", **common_row, "global_batch": 8, "steps": PARITY_STEPS, "gate": run["gate"],
           "run_seconds": run["seconds"], **parity_losses(run),
           "param_bytes_by_rank": [r["param_bytes"] for r in bf16],
           "param_bytes_one_rank": run["one"]["bf16"]["param_bytes"],
           "moment_bytes_by_rank": [r["moment_bytes"] for r in bf16],
           "moment_bytes_one_rank": run["one"]["bf16"]["moment_bytes"],
           "sharded_params": bf16[0]["sharded_params"], "launches_by_rank": got, "want_launches": want,
           "one_rank_launches": {p: {k: o["launches"][k] for k in want} for p, o in run["one"].items()},
           "gn_sites": sites}
    emit(row)
    if not run["gate"]["ok"] or any(c != want for cs in got.values() for c in cs):
        raise AssertionError(f"tp2_card: {row}")
    tp2_counts = {k: sum(c.get(k, 0) for cs in got.values() for c in cs) for k in launches()}
    for d in (work, os.path.join(WORK, "tp2_data")):
        shutil.rmtree(d, ignore_errors=True)
    return {"dp2_card": dp2_counts, "tp2_card": tp2_counts}


def dryrun_sites() -> dict:
    """B6/B7 calls of dryrun_multichip(1) with the switch on, derived from
    its models: one step each of the 28² flagship's DP step, the GAN step
    (its generator's sites, the decoder's again when its dropout makes the
    adaptive weight redecode) and the full loss surface (the towers have no
    GroupNorm), and the tiny flagship's CHUNK_STEPS steps fused and again per
    step; a step's backward calls B7 once a site (the adaptive weight's
    gradient stops at conv_out)."""
    flag = gn_swish_sites(build_model(entry_mod.ENTRY_MODEL, "bf16", "meta", train=True))
    cvae = build_model(entry_mod.GAN_CVAE, "fp32", "meta", train=True)
    gan = gn_swish_sites(cvae)
    redecode = gn_swish_sites(cvae.decoder) if any(m.dropout for m in cvae.decoder.modules()
                                                    if isinstance(m, ResnetBlock)) else 0
    tiny = gn_swish_sites(build_model(entry_mod.TINY_FLAGSHIP, "bf16", "meta", train=True))
    per_site = flag + gan + (2 * entry_mod.CHUNK_STEPS + 1) * tiny
    return {"gn_swish_fwd": per_site + redecode, "gn_swish_bwd": per_site}


def phase_dryrun_card() -> dict:
    """entry.dryrun_multichip(1) and (4) on the card with the switch on
    (module docstring)."""
    want = want_launches(**dryrun_sites())
    reset_launches()
    with fused_gn(True), contextlib.redirect_stdout(io.StringIO()):
        lines = dryrun_multichip(1)
    counts = launches()
    t0 = time.perf_counter()
    with fused_gn(True), contextlib.redirect_stdout(io.StringIO()):
        lines4 = dryrun_multichip(4, timeout=RANK_CHILD_TIMEOUT)
    row = {"phase": "dryrun_card", "lines": lines, "launches": counts, "want_launches": want,
           "lines_4_ranks": lines4, "seconds_4_ranks": time.perf_counter() - t0}
    emit(row)
    if len(lines) != 4 or not all(": ok, " in line for line in lines) or not any("captured" in l for l in lines):
        raise AssertionError(f"dryrun_card: {row}")
    if counts != want:
        raise AssertionError(f"dryrun_card: launches {counts}, want {want}")
    if len(lines4) != 5 or not all(": ok, " in line for line in lines4):
        raise AssertionError(f"dryrun_card: four ranks printed {lines4}")
    return counts


def phase_serve_mesh(state_dict) -> dict:
    """The flagship engine over a mesh of the one card against one without:
    a bucket-32 reconstruct bit for bit, 5 B1 launches each."""
    model = build_model(FLAGSHIP, "bf16", CARD)
    model.load_state_dict(state_dict)
    plain = InferenceEngine(model, buckets=(1, 8, 32), device=CARD)
    meshed = InferenceEngine(copy.deepcopy(model), buckets=(1, 8, 32), mesh=True)
    rs = np.random.RandomState(3)
    x = rs.randint(0, 255, (32, 224, 224, 3), np.uint8)
    midx = np.arange(32) % 5
    out, counts = {}, {}
    for name, engine in (("plain", plain), ("mesh", meshed)):
        engine.reconstruct(x, midx)
        torch.cuda.synchronize()
        reset_launches()
        out[name] = engine.reconstruct(x, midx)
        counts[name] = launches()
    want = want_launches(flash_fwd=PER_CHUNK["reconstruct"])
    row = {"phase": "serve_mesh", "devices": [str(d) for d in meshed.devices], "buckets": list(meshed.buckets),
           "bit_for_bit": bool(np.array_equal(out["plain"], out["mesh"])),
           "max_abs_diff": float(np.abs(out["plain"] - out["mesh"]).max()), "launches": counts["mesh"],
           "plain_launches": counts["plain"]}
    emit(row)
    if not row["bit_for_bit"] or counts["mesh"] != want or counts["plain"] != want:
        raise AssertionError(f"serve_mesh: {row}")
    del plain, meshed, model
    torch.cuda.empty_cache()
    return counts["mesh"]


# ----------------------------------------------------- the public surface ---- #

SURFACE_ATTENTION = {(32, 3136, 512): "flash", (64, 256, 1024): "fused"}  # bf16, B1 and B4's main shapes
SURFACE_GN = (32, 256, 224, 224)  # bf16, the flagship's widest GroupNorm+SiLU level
SURFACE_GN_BAR = 1e-2  # relative L2 of bf16 output and gradients, as the autograd lines of gn kernel
PENALTY_BATCH = 24
PENALTY_BAR = 2e-4  # the CPU tests' fp32 output bar
SURFACE_PACKAGES = ("", "analysis", "cli.train", "compat", "config", "core", "data", "entry", "losses", "models",
                    "nn", "ops", "parallel", "serve", "train", "utils")


def traced_window(fn, per_call: dict) -> tuple:
    """(wrappers' counts, trace's calls, the trace's kernel events in all)
    over one call of `fn`, counts from 0."""
    reset_launches()
    events = collections.Counter()
    for kernel, (_, n) in device_kernels(fn).items():
        events[_category(kernel)] += n
    return launches(), traced_launches(events, per_call), sum(events.values())


def surface_attention(shape, route: str) -> dict:
    """`ops.fused_attention_or_none` at `shape` in bf16: under autograd
    (forward and backward) and a serving call, against the kernels' plain
    versions; the launches by wrapper and by trace."""
    gen = torch.Generator(device=CARD).manual_seed(16)
    q, k, v, g = (torch.randn(shape, generator=gen, device=CARD).to(torch.bfloat16) for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = {}

    def run():
        out = port_ops.fused_attention_or_none(*leaves)
        got["grads"] = torch.autograd.grad(out, leaves, g)
        got["out"] = out.detach()
        with torch.no_grad():
            got["serve"] = port_ops.fused_attention_or_none(q, k, v)

    names = ("flash_fwd", "flash_bwd") if route == "flash" else ("attention_fwd", "attention_bwd")
    t0 = time.perf_counter()
    counts, traced, events = traced_window(run, {n: KERNELS_PER_CALL[n] for n in names})
    seconds = time.perf_counter() - t0
    if route == "flash":
        ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out_ref = fa.flash_attention_plain(*ref)
        grads_ref = torch.autograd.grad(out_ref, ref, g)
        out_ref = out_ref.detach()
        max_abs_bar, rel_bar = TOLERANCE[torch.bfloat16]
    else:
        out_ref = at.fused_attention_fwd_plain(q, k, v)
        grads_ref = at.fused_attention_bwd_plain(q, k, v, g)
        max_abs_bar, rel_bar = None, ATTN_FWD_BAR[torch.bfloat16]
    fwd = {}
    for name in ("out", "serve"):
        err = (got[name].double() - out_ref.double()).abs()
        one_rounding = bool((err <= 2.0**-7 * out_ref.double().abs() + 1e-6).all())
        fwd[name] = {"max_abs_err": err.max().item(), "rel_l2": torch_rel_l2(got[name], out_ref),
                     "within_one_rounding": one_rounding}
        fwd[name]["ok"] = (bool(torch.isfinite(got[name]).all()) and fwd[name]["rel_l2"] <= rel_bar
                           and (one_rounding if max_abs_bar is None else fwd[name]["max_abs_err"] <= max_abs_bar))
    rows = [grad_check(n, a, r, torch.bfloat16) for n, a, r in zip(("dq", "dk", "dv"), got["grads"], grads_ref)]
    want = want_launches(**{names[0]: 2, names[1]: 1})
    row = {"phase": "surface", "entry": "ops.fused_attention_or_none", "shape": list(shape), "dtype": "bfloat16",
           "route": route, "seconds": seconds, "fwd_bars": {"max_abs": max_abs_bar, "rel_l2": rel_bar},
           "fwd": fwd, "grads": rows, "launches": counts, "traced_launches": traced,
           "trace_kernel_events": events, "card": nvidia_smi_line()}
    emit(row)
    if (not all(f["ok"] for f in fwd.values()) or not all(r["ok"] for r in rows) or counts != want
            or traced != {n: want[n] for n in names}):
        raise AssertionError(f"surface: fused_attention_or_none {shape}: {row}")
    return counts


def surface_group_norm_swish() -> dict:
    """`nn.GroupNormSwish` at SURFACE_GN in bf16 with MEDVAE_FUSED_GN=1
    (B6, B7 under autograd) against the same module with the switch off
    (the plain GroupNorm -> cast -> SiLU), forward and backward."""
    gen = torch.Generator(device=CARD).manual_seed(17)
    c = SURFACE_GN[1]
    module = port_nn.GroupNormSwish(c).to(CARD)
    with torch.no_grad():
        module.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen, device=CARD))
        module.bias.copy_(0.1 * torch.randn(c, generator=gen, device=CARD))
    x = torch.randn(SURFACE_GN, generator=gen, device=CARD).to(torch.bfloat16)
    g = torch.randn(SURFACE_GN, generator=gen, device=CARD).to(torch.bfloat16)
    out = {}

    def run(key):
        leaf = x.clone().requires_grad_(True)
        y = module(leaf)
        out[key] = (y.detach(), *torch.autograd.grad(y, (leaf, module.weight, module.bias), g))

    per_call = {n: gn_kernels_per_call(n, [(SURFACE_GN, module.num_groups)])
                for n in ("gn_swish_fwd", "gn_swish_bwd")}
    t0 = time.perf_counter()
    with fused_gn(True):
        counts, traced, events = traced_window(lambda: run("fused"), per_call)
    seconds = time.perf_counter() - t0
    with fused_gn(False):
        reset_launches()
        run("plain")
        plain_counts = launches()
    rows = [{"name": n, "rel_l2": torch_rel_l2(a, r), "bar": SURFACE_GN_BAR, "finite": bool(torch.isfinite(a).all())}
            for n, a, r in zip(("y", "dx", "dgamma", "dbeta"), out["fused"], out["plain"])]
    want = want_launches(gn_swish_fwd=1, gn_swish_bwd=1)
    row = {"phase": "surface", "entry": "nn.GroupNormSwish", "shape": list(SURFACE_GN), "dtype": "bfloat16",
           **gn_instances(SURFACE_GN), "seconds": seconds, "checks": rows, "launches": counts,
           "traced_launches": traced, "trace_kernel_events": events, "plain_launches": plain_counts,
           "card": nvidia_smi_line()}
    emit(row)
    if (not all(r["finite"] and r["rel_l2"] <= SURFACE_GN_BAR for r in rows) or counts != want
            or traced != {"gn_swish_fwd": 1, "gn_swish_bwd": 1} or plain_counts != want_launches()):
        raise AssertionError(f"surface: nn.GroupNormSwish: {row}")
    return counts


def surface_gradient_penalty() -> None:
    """`utils.gradient_penalty` through multi_modal_cvae.yaml's PatchGAN at
    PENALTY_BATCH x 224² in fp32 on the card against the same call on the
    CPU (same seeded weights, images and key), and a second card call bit
    for bit the first, the penalty and the discriminator's gradients (the
    double backward through cuDNN's deterministic convolutions)."""
    configure_backends()
    disc_cfg = gan224_config()["training"].get("discriminator")
    rs = np.random.RandomState(18)
    real, fake = (torch.from_numpy(rs.uniform(-1, 1, (PENALTY_BATCH, 224, 224, 3)).astype(np.float32))
                  for _ in range(2))
    key = threefry.prng_key(18)
    t0 = time.perf_counter()
    card = []
    disc = build_discriminator(disc_cfg, CARD, seed=7).eval()
    params = list(disc.parameters())
    for _ in range(2):
        penalty = port_utils.gradient_penalty(disc, real.to(CARD), fake.to(CARD), key)
        grads = torch.autograd.grad(penalty, params, allow_unused=True)
        card.append((penalty.detach(), [torch.zeros_like(p) if gr is None else gr for p, gr in zip(params, grads)]))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = port_utils.gradient_penalty(build_discriminator(disc_cfg, "cpu", seed=7).eval(), real, fake, key).detach()
    cpu_s = time.perf_counter() - t0
    first, second = card
    rel = abs(float(first[0]) - float(cpu)) / max(abs(float(cpu)), 1e-30)
    repeat = bool(torch.equal(first[0], second[0])) and all(torch.equal(a, b) for a, b in zip(first[1], second[1]))
    row = {"phase": "surface", "entry": "utils.gradient_penalty", "batch": PENALTY_BATCH, "size": 224,
           "dtype": "float32", "disc": disc_cfg, "penalty_card": float(first[0]), "penalty_cpu": float(cpu),
           "rel_diff": rel, "bar": PENALTY_BAR, "card_repeat_bit_for_bit": repeat,
           "disc_grad_norm": float(torch.sqrt(sum(gr.double().square().sum() for gr in first[1]))),
           "card_seconds_two_calls": card_s, "cpu_seconds": cpu_s, "card": nvidia_smi_line()}
    emit(row)
    if not (rel <= PENALTY_BAR and repeat and math.isfinite(row["disc_grad_norm"]) and row["disc_grad_norm"] > 0):
        raise AssertionError(f"surface: gradient_penalty: {row}")
    del disc, card, first, second
    torch.cuda.empty_cache()


def surface_imports() -> None:
    """Every port subpackage and every name of its __all__ imported in a
    fresh process, with neither JAX nor the JAX package loaded."""
    code = ("import importlib, sys\n"
            f"for sub in {SURFACE_PACKAGES!r}:\n"
            "    m = importlib.import_module('medvae_tpu_torch' + ('.' + sub if sub else ''))\n"
            "    [getattr(m, n) for n in getattr(m, '__all__', [])]\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'medvae_tpu')))\n")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    row = {"phase": "surface", "entry": "fresh-process imports", "packages": len(SURFACE_PACKAGES),
           "rc": out.returncode, "foreign_modules": out.stdout.strip().splitlines()[-1:] or out.stderr[-2000:],
           "seconds": time.perf_counter() - t0}
    emit(row)
    if out.returncode != 0 or out.stdout.strip().splitlines()[-1] != "[]":
        raise AssertionError(f"surface: imports: {row}")


def phase_surface() -> dict:
    """The kernels reached through the package's public names, the WGAN-GP
    at full width, and the surface imported alone (module docstring)."""
    counts = collections.Counter()
    for shape, route in SURFACE_ATTENTION.items():
        counts.update(surface_attention(shape, route))
        torch.cuda.empty_cache()
    counts.update(surface_group_norm_swish())
    torch.cuda.empty_cache()
    surface_gradient_penalty()
    surface_imports()
    return dict(counts)


# ------------------------------------------- walkthroughs, notebooks, demo ---- #

WALKTHROUGHS = ("vanilla_vae_walkthrough_torch.py", "disentangled_vae_walkthrough_torch.py")


@contextlib.contextmanager
def working_directory(path: str):
    """cwd and $PWD (the configs' work_dir) at `path` for the block."""
    os.makedirs(path, exist_ok=True)
    cwd, pwd = os.getcwd(), os.environ.get("PWD")
    os.chdir(path)
    os.environ["PWD"] = path
    try:
        yield path
    finally:
        os.chdir(cwd)
        if pwd is None:
            os.environ.pop("PWD", None)
        else:
            os.environ["PWD"] = pwd


def load_file(path: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(os.path.splitext(os.path.basename(path))[0], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


GN_TRACE = {"gn_swish_fwd": 1, "gn_swish_bwd": 2}  # the 28² quick models' instances: resident or cluster


def phase_walkthroughs() -> dict:
    """Both examples/*_walkthrough_torch.py at their shipped flags on the
    card with MEDVAE_FUSED_GN=1, in this process: B6/B7 launches by wrapper
    and by trace (> 0, equal), every figure decoded, every number finite."""
    total = collections.Counter()
    for script in WALKTHROUGHS:
        work = os.path.join(WORK, "walkthroughs", script.split("_")[0])
        result = {}
        with working_directory(work), fused_gn(True):
            module = load_file(os.path.join(REPO, "examples", script))
            t0 = time.perf_counter()
            counts, traced, events = traced_window(lambda: result.update(module.main(["--out", "figs"])),
                                                   GN_TRACE)
            seconds = time.perf_counter() - t0
            sizes = {f: read_png_size(os.path.join(work, "figs", f)) for f in result["figures"]}
        numbers = {k: v for k, v in result.items() if k != "figures"}
        row = {"phase": "walkthroughs", "script": f"examples/{script}", "seconds": seconds, "numbers": numbers,
               "figures": sizes, "launches": counts, "traced_launches": traced, "trace_kernel_events": events,
               "card": nvidia_smi_line()}
        emit(row)
        if (not sizes or not all(w > 0 and h > 0 for w, h in sizes.values())
                or not all(math.isfinite(v) for v in numbers.values())
                or counts["gn_swish_fwd"] <= 0 or counts["gn_swish_bwd"] <= 0
                or traced != {n: counts[n] for n in GN_TRACE}):
            raise AssertionError(f"walkthroughs: {script}: {row}")
        total.update(counts)
    return dict(total)


def phase_notebooks() -> dict:
    """The code cells of both notebooks/*_torch.ipynb in order on the card
    (MEDVAE_NB_QUICK=1, MEDVAE_FUSED_GN=1), in this process: the figures
    decoded, the losses finite and falling, B6/B7 launches."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import build_notebooks_torch as notebooks
    finally:
        sys.path.pop(0)
    total = collections.Counter()
    before = {k: os.environ.get(k) for k in ("MEDVAE_NB_QUICK", "MEDVAE_NB_DEVICE")}
    os.environ.update(MEDVAE_NB_QUICK="1", MEDVAE_NB_DEVICE="cuda")
    try:
        for name in notebooks.NAMES:
            work = os.path.join(WORK, "notebooks", name.split(".")[0])
            with open(os.path.join(REPO, "notebooks", name)) as f:
                cells = len(json.load(f)["cells"])
            with working_directory(work), fused_gn(True):
                reset_launches()
                t0 = time.perf_counter()
                ns = notebooks.run_notebook(os.path.join(REPO, "notebooks", name))
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = launches()
                figs = sorted(f for f in os.listdir("nb_figures_torch") if f.endswith(".png"))
                sizes = {f: read_png_size(os.path.join(work, "nb_figures_torch", f)) for f in figs}
            losses = ns["losses"]
            row = {"phase": "notebooks", "notebook": f"notebooks/{name}", "seconds": seconds,
                   "cells": cells,
                   "loss_first": losses[0], "loss_last": losses[-1], "figures": sizes, "launches": counts,
                   "card": nvidia_smi_line()}
            emit(row)
            if (not sizes or not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]
                    or counts["gn_swish_fwd"] <= 0 or counts["gn_swish_bwd"] <= 0):
                raise AssertionError(f"notebooks: {name}: {row}")
            total.update(counts)
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return dict(total)


DEMO_FILES = ("serve.json", "generate", "evaluate/metrics.json", "analyze")


def phase_demo() -> None:
    """scripts/demo_torch.sh training.max_epochs=1 on the card into a
    temporary DEMO_LOG_DIR: exit 0, each stage's output present."""
    logs = os.path.join(WORK, "demo")
    shutil.rmtree(logs, ignore_errors=True)
    t0 = time.perf_counter()
    out = subprocess.run(["bash", os.path.join(REPO, "scripts", "demo_torch.sh"), "training.max_epochs=1"],
                         cwd=REPO, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "DEMO_LOG_DIR": logs})
    present = {f: os.path.exists(os.path.join(logs, f)) for f in DEMO_FILES}
    row = {"phase": "demo", "script": "scripts/demo_torch.sh", "rc": out.returncode,
           "seconds": time.perf_counter() - t0, "present": present,
           "stages": [ln for ln in out.stdout.splitlines() if ln.startswith("===")],
           "tail": out.stdout.splitlines()[-3:], "card": nvidia_smi_line()}
    emit(row)
    if out.returncode != 0 or not all(present.values()):
        raise AssertionError(f"demo: {row}\n{out.stderr[-3000:]}")


# phase_demo (90.0 s in a full run on the H100) is left out: with it the
# run took 1,146 s of its 1,200; it runs alone (module docstring)
PUBLIC_PHASES = (("surface", phase_surface), ("walkthroughs", phase_walkthroughs),
                 ("notebooks", phase_notebooks))


def public_child(argv) -> int:
    """`chip_smoke.py --public-child <out.json>`: the PUBLIC_PHASES in this
    fresh process (the parent built the kernels), their seconds and
    launches written to out.json."""
    os.environ["MEDVAE_FUSED_GN"] = "0"
    seconds, counts = {}, {}
    for name, phase in PUBLIC_PHASES:
        t0 = time.perf_counter()
        got = phase()
        seconds[name] = round(time.perf_counter() - t0, 3)
        if got is not None:
            counts[name] = got
    with open(argv[0], "w") as f:
        json.dump({"seconds": seconds, "launches": counts}, f)
    return 0


def phase_public() -> tuple:
    """The PUBLIC_PHASES in a child process: in this long-lived one, after
    the earlier phases, torch.profiler's trace of surface's first window
    held none of B1's or flash_bwd's kernel events (two full runs; the
    wrappers counted 2 and 1), while the same window in a fresh process
    traced every launch. Returns (seconds, launches) by phase."""
    os.makedirs(WORK, exist_ok=True)
    out = os.path.join(WORK, "public_child.json")
    gc.collect()
    torch.cuda.empty_cache()  # the card's memory to the child
    sys.stdout.flush()
    subprocess.run([sys.executable, os.path.abspath(__file__), "--public-child", out], check=True,
                   timeout=900)
    with open(out) as f:
        got = json.load(f)
    emit({"phase": "public (child process)", "seconds": got["seconds"]})
    return got["seconds"], got["launches"]


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--rank-child":
        return rank_child(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "--public-child":
        return public_child(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    os.environ["MEDVAE_FUSED_GN"] = "0"  # the port's default; fused phases turn it on
    seconds, t_lap = {}, [time.perf_counter()]

    def lap(name: str) -> None:  # command seconds by phase, printed before the card line
        now = time.perf_counter()
        seconds[name] = round(now - t_lap[0], 3)
        t_lap[0] = now

    smi = phase_env()
    lap("env")
    phase_build()
    lap("build")
    kernel = phase_kernel()
    lap("kernel")
    backward = phase_backward()
    lap("backward")
    gn_kernel = phase_gn_kernel()
    lap("gn_kernel")
    attn_kernel = phase_attn_kernel()
    lap("attn_kernel")
    dispatch = phase_dispatch()
    lap("dispatch")
    bf16_engine, fp32_engine, cpu_engine = build_engines()
    state_dict = cpu_engine.model.state_dict()
    serve_launches = phase_serve(bf16_engine)
    lap("engines_serve")
    phase_parity(bf16_engine, fp32_engine, cpu_engine)
    lap("parity")
    phase_http(bf16_engine)
    lap("http")
    phase_profile(bf16_engine)
    lap("profile")
    fused_serve_launches = phase_flagship_fused_serve(bf16_engine)
    lap("flagship_fused_serve")
    bench_serve_launches = phase_bench_serve(bf16_engine)
    lap("bench_serve")
    imported, import224_launches = phase_import224(bf16_engine, state_dict)
    lap("import224")
    del bf16_engine, fp32_engine, cpu_engine
    gc.collect()
    export224_launches = phase_export224(imported)
    lap("export224")
    shutil.rmtree(os.path.join(WORK, "import224"), ignore_errors=True)
    train_launches = phase_train(state_dict)
    lap("train")
    fused_train_launches = phase_flagship_fused_train(state_dict)
    lap("flagship_fused_train")
    phase_train_parity(state_dict)
    lap("train_parity")
    towers_launches = phase_towers_bf16(state_dict)
    lap("towers_bf16")
    eval224_launches = phase_eval224(state_dict)
    lap("eval224")
    cvae_launches = phase_cvae28_train(True)
    lap("cvae28_train")
    phase_cvae28_train(False)
    lap("cvae28_train_off")
    phase_cvae28_parity()
    lap("cvae28_parity")
    cvae_serve_launches = phase_cvae28_serve()
    lap("cvae28_serve")
    fast28_launches = phase_fast28()
    lap("fast28")
    cfg = base128_config()
    base128_weights = init_weights(build_model(cfg["model"], "fp32", "cpu", train=True), seed=0).state_dict()
    attn_launches = {"base128_train": phase_base128_train(cfg, base128_weights),
                     "base128_serve": phase_base128_serve(cfg["model"], base128_weights)}
    lap("base128_train_serve")
    phase_base128_parity(cfg, base128_weights)
    lap("base128_parity")
    attn_launches["fast128"] = phase_fast128()
    lap("fast128")
    attn_launches["trainer128"] = phase_trainer128()
    lap("trainer128")
    attn_launches["eval128"] = phase_eval128()
    lap("eval128")
    attn_launches["export128"] = phase_export128()
    lap("export128")
    shutil.rmtree(WORK, ignore_errors=True)
    gan_launches = {"gan224_train": phase_gan224_train()}
    lap("gan224_train")
    phase_gan_parity()
    lap("gan_parity")
    gan_launches["gan_trainer"] = phase_gan_trainer()
    lap("gan_trainer")
    phase_options_parity()
    lap("options_parity")
    slice14 = {"sweep": phase_sweep()}
    lap("sweep")
    slice14.update(phase_resilient())
    lap("resilient")
    slice14["bench_modes"] = phase_bench_modes()
    lap("bench_modes")
    _, surface = phase_public()
    lap("surface, walkthroughs, notebooks (child process)")
    phase_options()
    lap("options")
    multi = {"dp_flagship": phase_dp_flagship(state_dict)}
    lap("dp_flagship")
    multi.update(phase_two_ranks())
    lap("dp2_card+tp2_card")
    multi["dryrun_card"] = phase_dryrun_card()
    lap("dryrun_card")
    multi["serve_mesh"] = phase_serve_mesh(state_dict)
    lap("serve_mesh")
    shutil.rmtree(WORK, ignore_errors=True)
    emit({"phase_seconds": seconds, "total": round(sum(seconds.values()), 3)})
    print(smi, flush=True)
    source = {"flash_fwd": "medvae_tpu_torch/ops/csrc/flash_fwd.cu",
              "flash_bwd (B2: dK, dV)": "medvae_tpu_torch/ops/csrc/flash_bwd.cu",
              "flash_bwd (B3: dQ)": "medvae_tpu_torch/ops/csrc/flash_bwd.cu",
              "gn_swish_fwd": "medvae_tpu_torch/ops/csrc/groupnorm_swish.cu",
              "gn_swish_bwd": "medvae_tpu_torch/ops/csrc/groupnorm_swish.cu",
              "attention_fwd": "medvae_tpu_torch/ops/csrc/attention.cu",
              "attention_bwd": "medvae_tpu_torch/ops/csrc/attention.cu"}
    replaces = {"flash_fwd": "medvae_tpu/ops/flash_attention.py:208",
                "flash_bwd (B2: dK, dV)": "medvae_tpu/ops/flash_attention.py:279",
                "flash_bwd (B3: dQ)": "medvae_tpu/ops/flash_attention.py:341",
                "gn_swish_fwd": "medvae_tpu/ops/groupnorm_swish.py:106",
                "gn_swish_bwd": "medvae_tpu/ops/groupnorm_swish.py:154",
                "attention_fwd": "medvae_tpu/ops/attention.py:94",
                "attention_bwd": "medvae_tpu/ops/attention.py:129"}
    fwd = {k: kernel[k] for k in ("instance", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")}
    fwd.update(launches=serve_launches + train_launches["flash_fwd"],
               launches_serve=serve_launches, launches_train=train_launches["flash_fwd"],
               launches_eval224=eval224_launches["flash_fwd"],
               launches_import224=import224_launches["flash_fwd"],
               launches_export224=export224_launches["flash_fwd"],
               launches_bench_serve=bench_serve_launches["flagship224"],
               launches_towers_bf16=towers_launches["flash_fwd"],
               launches_dp_flagship=multi["dp_flagship"]["flash_fwd"],
               launches_serve_mesh=multi["serve_mesh"]["flash_fwd"],
               launches_surface=surface["surface"]["flash_fwd"],
               op_ms=dispatch["flash_attention"]["op_ms"],
               dispatch_us=dispatch["flash_attention"]["dispatch_us"],
               ms_with_lse=backward["flash_fwd_lse"]["ms"],
               plain_ms_with_lse=backward["flash_fwd_lse"]["plain_ms"],
               bound_ms_with_lse=backward["flash_fwd_lse"]["bound_ms"],
               library_ms_with_lse=backward["flash_fwd_lse"]["library_ms"],
               max_abs_err_lse=backward["flash_fwd_lse"]["max_abs_err"])
    rows = [{"name": "flash_fwd", **fwd}]
    # B2 and B3 are computed by one launch of flash_bwd (the Hopper
    # instance's two passes), so both rows carry that launch's numbers
    r = backward["flash_bwd"]
    for name, err in (("flash_bwd (B2: dK, dV)", r["max_abs_err_dkv"]), ("flash_bwd (B3: dQ)", r["max_abs_err_dq"])):
        rows.append({"name": name, "launches": train_launches["flash_bwd"], "max_abs_err": err,
                     "launches_towers_bf16": towers_launches["flash_bwd"],
                     "launches_dp_flagship": multi["dp_flagship"]["flash_bwd"],
                     "launches_surface": surface["surface"]["flash_bwd"],
                     "covers": "dq, dk and dv in one launch",
                     **{k: r[k] for k in ("instance", "ms", "plain_ms", "bound_ms", "bound_by",
                                          "bound_with_planes_ms", "library_ms",
                                          "library")}})
    for name in ("gn_swish_fwd", "gn_swish_bwd"):
        r = gn_kernel[name]
        # launches: the main path's, bench.py's default step with the switch
        # on (cvae28_train); then the other paths that ran the kernel
        rows.append({"name": name, "launches": cvae_launches[name],
                     "launches_cvae28_serve": cvae_serve_launches[name],
                     "launches_fast28": fast28_launches[name],  # the trace's, 50 replayed steps
                     "launches_flagship_fused_serve": fused_serve_launches[name],
                     "launches_flagship_fused_train": fused_train_launches[name],
                     **{f"launches_{path}": c[name] for path, c in gan_launches.items()},
                     **{f"launches_{path}": c[name] for path, c in slice14.items()},
                     **{f"launches_{path}": multi[path][name] for path in ("dp2_card", "tp2_card", "dryrun_card")},
                     **{f"launches_{path}": c[name] for path, c in surface.items()},
                     **({"launches_eval224_fused": eval224_launches["gn_swish_fwd"],
                         "launches_export224": export224_launches["gn_swish_fwd"],
                         "launches_bench_serve": bench_serve_launches["quick28"],
                         "op_ms": dispatch["gn_swish_fwd"]["op_ms"],
                         "dispatch_us": dispatch["gn_swish_fwd"]["dispatch_us"]}
                        if name == "gn_swish_fwd" else {}),
                     **{k: r[k] for k in ("instance", "max_abs_err", "ms", "device_ms", "plain_ms",
                                          "bound_ms", "bound_by", "streamed_ms", "streamed_device_ms",
                                          "library_ms", "library", "shape", "at_224")}})
    for name in ("attention_fwd", "attention_bwd"):
        r = attn_kernel[name]
        # launches: the 128² slice's three paths (train step, serving, the
        # trainer through cli/train.py), each counted from 0 around its run
        rows.append({"name": name, "launches": sum(c[name] for c in attn_launches.values()),
                     **{f"launches_{path}": c[name] for path, c in attn_launches.items()},
                     "launches_tp2_card": multi["tp2_card"][name],
                     "launches_surface": surface["surface"][name],
                     **({"op_ms": dispatch["attention_fwd"]["op_ms"],
                         "dispatch_us": dispatch["attention_fwd"]["dispatch_us"]}
                        if name == "attention_fwd" else {}),
                     **{k: r[k] for k in ("instance", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                          "bound_fp32_products_ms", "fma_instance_ms", "library_ms",
                                          "library", "shape")}})
    emit({"kernels": [{"name": r["name"], "route": "cuda", "source": source[r["name"]],
                       "replaces": replaces[r["name"]], **{k: v for k, v in r.items() if k != "name"}}
                      for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
