#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fedml_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH] [--profile] [--phases build,mesh,...]

Phases, in order; any failure exits non-zero:

1. build   — compile every CUDA kernel of the main paths from ``ops/csrc``
             (one nvcc per source, all at once) and print the build seconds.
2. kernels — call each kernel's wrapper at every shape its path gives it,
             hold each result against the plain PyTorch version on the same
             inputs and time kernel, plain version and the library call
             (CUDA-graph replays between CUDA events, so host overhead stays
             out):
             conv3x3_mxu at the 6 ResNet-56 shapes (N=64), fp32 (TF32 off)
             and bf16, with and without moments, plus one epilogue case,
             each case printed with the route it took (``tc``: the
             tensor-core kernel, bf16 past the stem; ``v2``: the CUDA-core
             kernel, fp32 and the 3-channel stem);
             flash_attention_fwd at the fedllm bench shape (B 8, L 1024,
             H 10, D 128, causal) in bf16 and fp32, non-causal once, the
             long-context range L 2048/4096/8192 at B*L = 8192, GPT-2
             small's head width (H 20, D 64), and the experiments/run.py
             shape (L 80, H 4, D 16) in fp32 and bf16, each case printed with the
             route it took (``wgmma``: bf16 with D 64/128; ``mma``: bf16
             with D <= 32; ``fma``: fp32).  Then conv3x3_mxu at the same six
             shapes at the ImageNet loaders' 224 px (N=16, bf16 with moments:
             ~12.5k-50k blocks a launch), each moment sum also held against the
             float64 sum of its own side's output.
3. check   — the kernel-conv ResNet-56 against the library-conv ResNet-56
             (at 32 px, batch 8, and at 224 px, batch 2),
             and the flash-kernel transformer against the plain-attention
             transformer, each with the same variables on a small batch
             (fp32, TF32 off, and the transformer once more in bf16, where
             attention takes the wgmma route, against the kernel's own
             arithmetic in plain PyTorch, p rounded to bf16 before P·V,
             at a fixed limit that a planted stale V tile must exceed);
             the flash op's dq/dk/dv
             against autograd through the plain version (fp32), and in
             bf16 against the same backward fed the plain version's O and
             LSE.  Then ResNet-56's space-to-depth (s2d_stages 1/2/3) and
             lane-padding (pad_stage1_to 32) variants on library convs
             against the library ResNet-56 (fp32, 8 images at 32 px): eval
             logits, loss and BatchNorm stats within the CPU test's
             tolerances, the gradients no further from the library model's
             float64 gradients than twice its own fp32 ones, a planted fault
             (the stem's re-scattered taps transposed) beyond the gates; one
             warm bf16 train step of 64 images per variant beside the kernel
             route's (printed).
4. main    — FedAvg over ResNet-56 (Bottleneck [6,6,6], full width, bf16
             compute, SGD lr 1e-3 momentum 0.9 wd 1e-3) on the CIFAR-10
             stand-in with Dirichlet(0.5) clients: two rounds of 4 clients x
             4 steps through ``make_multi_round_fn``, then one
             ``FedAvgSimulation.run`` round (each client's shard cut to 4
             steps) with ``evaluate_global``; the
             conv kernels must have run 19 times per forward, 18 of each
             bf16 training forward's (all but the stem) on the
             tensor-core route (evaluation runs in fp32, on v2).
5. fedllm  — FedAvg over the transformer LM at the bench width
             (``fedml_tpu_torch.bench.build_fedllm``: width 1280, 12 layers,
             10 heads, L 1024, vocab 8192, 4 clients x batch 8 x 4 steps,
             bf16, SGD 3e-4): one warm-up round, then two timed rounds
             through ``make_multi_round_fn``; then ``experiments.run.main``
             for fedllm at its defaults (one round through
             ``FedAvgSimulation``).  The flash kernel must have run once per
             layer per forward, at the bench width every time on the wgmma
             route.

6. rng     — every RNG_CASES draw (threefry bits, uniform, bernoulli,
             randint, permutation at n 1536 and 15360, cifar_augment and
             CINIC-10's augment without Cutout on 64 fixed images) on the card, held bitwise against the same call
             on the CPU and against jax 0.9.0's known answers
             (tests/threefry_known_answers.json).
7. north_star — ``fedml_tpu_torch.bench.build_north_star`` at its cut but
             12 steps a client (a warm-up round of one client, then one
             timed round; ResNet-56 on the conv kernel, 10 clients x 12
             steps x batch 64,
             bf16), one warm-up round and one timed round; 19 conv launches
             per forward, 18 of them on the tensor-core route.
8. sim     — ``FedAvgSimulation`` over the kernel ResNet-56 (bf16,
             cifar_augment, 4 of 8 clients sampled per round, dropout 0.25,
             3 rounds) run three ways, deterministically: ``run()``; a run
             that checkpoints every round, crashes before round 2 and
             resumes; ``run_fused_sampled``.  All three must end with equal
             variables, bit for bit.  Then ``experiments.run.main`` fedavg at
             a small cut with augmentation on and ``--checkpoint_every 1``.
9. init    — the seeded init (flax's variables under ``PRNGKey(0)``) of
             ResNet-56, a small transformer and the zoo's models (the
             LSTMs' orthogonal kernels: a host QR) drawn on the card,
             bitwise against the same draw on the CPU; the cross-silo
             families at full width (vgg16_bn, mobilenet, mobilenet_v3,
             efficientnet at 100 classes, 32 px) drawn on the card only,
             each leaf's sha256 against flax's (tests/silo_init_digests.json),
             with the draw's seconds and peak memory.
10. compress — [sim]'s configuration with the int8 codec and error
             feedback: ``run()``, crash + ``resume()`` and
             ``run_fused_sampled`` end bit-identical (variables and
             residuals); one round each of int4, topk0.01 + EF and bf16;
             the uplink bytes per upload against the JAX package's; the
             qsgd8 payload of a trained update on the card against the
             CPU's (sha256); the codec stage's time and kernel launches per
             client (fused, and the per-leaf plain version), and its share
             of a 4 x 4 x 64 round, timed in turns with the same round
             without a codec (twice each way).
11. pack   — the native row-gather packer must have built and loaded; the
             pack time of a 10 x 1536-image cohort, native and numpy.
12. zoo    — the cross-device zoo at full width through
             ``experiments/run.py::run_experiment`` on the card: lr on mnist,
             cnn (CNN_DropOut) on femnist, resnet18_gn on fed_cifar100, the
             2xLSTM(256) on shakespeare and fed_shakespeare, the LSTM(670)
             on stackoverflow_nwp and the multi-label lr on
             stackoverflow_lr, each with the SGD lr and batch of the JAX
             package's convergence record, 2 rounds of 5 sampled clients
             (the first a warm-up); per pair the parameter count, median
             round ms, samples/s (tokens/s for the LSTMs) and final test
             metrics (precision and recall for stackoverflow_lr), all
             finite.  Then one round of 2 clients x 2 steps per model from
             one seed on the card in fp32 (TF32 off), within 1e-4 of each
             leaf's largest magnitude of the same round on the CPU in
             float64 (the CPU's fp32 round printed beside it), and the
             dropout mask card == CPU bitwise.  No zoo path launches the
             conv or flash kernel.
13. silo   — FedML's cross-silo benchmark rows through
             ``experiments.run.main`` (FedAvg, SGD lr 1e-3 wd 1e-3, batch 64,
             LDA alpha 0.5, bf16, augmentation on) at full width: ResNet-56
             on the conv kernel on cifar100 and cinic10, mobilenet on both,
             vgg16_bn, mobilenet_v3 and efficientnet on cifar100; 4 clients
             of <= 64 samples, 2 rounds (the first a warm-up), 128 test
             samples; per pair the parameter count, median round seconds,
             samples/s, final test accuracy and loss (finite) and the conv
             kernel's launches per forward (19 for ResNet-56, 18 of them
             tensor-core in each bf16 training forward; 0 for the others,
             and no flash launch).  Then one make_round_fn round of 2
             clients x 2 steps of 8 per new family, initialized on the card
             and copied to the CPU: card fp32 (TF32 off) within the larger of
             1e-4 and twice the spread of the CPU's fp32 rounds (from the
             init and one ulp off) of the CPU's float64 round, each leaf's
             max |Δ| over max(1, its largest magnitude); EfficientNet's
             drop-connect mask
             card == CPU bitwise.  ``phase_silo(controls=True)`` adds planted
             faults (EfficientNet with symmetric padding at stride 2, VGG
             flattened in NCHW order) that the round gate must refuse.
14. algos  — the FedAvg-engine family through ``experiments.run.main`` on
             full-width ResNet-56 with ``--conv_variant kernel`` (bf16,
             CIFAR-10 stand-in, 4 clients x 1 step x 64, 1 round, a
             checkpoint every round): fedavg, FedProx (mu 0 and 0.01),
             FedOpt (sgd lr 1, adam, yogi), FedNova (momentum 0 and 0.9),
             robust FedAvg under the backdoor (norm_diff_clipping, weak_dp,
             median) and hierarchical (2 groups x 2 group rounds); per case
             the round times, 19 conv launches per forward, the final test
             accuracy and loss (and backdoor accuracy).  Held on the card:
             FedProx mu 0 == FedAvg bitwise, FedOpt sgd lr 1 == FedAvg after
             round 1 within 1e-6, FedNova momentum 0 (equal steps) == FedAvg
             after round 1 within 1e-5, and the weak-DP noise of a (seed,
             round, slot) card == CPU bitwise.
15. standalone — the drivers beside the FedAvg engine through
             ``experiments.run.main`` at [algos]' cut (no checkpoints):
             centralized (the whole 5,000-image stand-in per epoch, as the
             JAX driver trains), decentralized gossip and TurboAggregate on
             the kernel ResNet-56 in bf16, 19 conv launches per forward (18
             tensor-core per training forward); FedGKT on resnet8_56 +
             resnet56_server (``--epochs_server 1``, fp32, library convs),
             which launches neither kernel; cuDNN's deterministic
             algorithms pinned, and FedGKT run a second time, its round
             records and final variables equal to the first run's bit for
             bit.  Per driver the round (epoch)
             times and final metrics, all finite, and the gossip's
             consensus distance.  Then ``secure_weighted_sum`` of four
             ResNet-56-sized vectors card == CPU bitwise and within
             n/(2·scale) of the float64 weighted sum, ``lcc_coded_sum`` with
             worker 1 dropped == none dropped bitwise, and an int64
             ``randint`` over [0, 2^31 − 1) card == CPU bitwise.
16. family — the rest of the algorithm family through ``experiments.run.main``
             in fp32 (TF32 off, cuDNN deterministic), each number printed
             with the card's name and power limit: SplitNN's ring over 4
             CIFAR-10 stand-in clients of 256 (the McMahan CNN's halves,
             batch 64, one epoch: seconds per client epoch, samples/s,
             validation accuracy), each card step from the CPU's float64
             state within 1e-3 of the float64 step, and the card's epoch
             within twice as far from the CPU's float64 epoch as the CPU's
             fp32 epochs from an init one ulp off land (the ring is
             chaotic in fp32); VFL over a seeded 262,144 x 83
             ``loan_processed.npz`` (2 parties, batch 256, one epoch:
             steps/s, loss, AUC), the first 16 steps within 1e-5 of the
             CPU's; FedNAS search + train stage at arch_order 1 and 2 (C 8,
             4 layers, 4 clients x 16, batch 16, one round each: seconds
             per round, genotype), one order-2 search round (2 clients of 16
             and 8, 16x16, batch 8, a pad-only batch) card fp32 against the
             CPU's float64 round (run in a process of its own meanwhile):
             variables within 0.05, alphas whose gradient is not near zero
             within 0.05, with its ms and peak memory.  Neither kernel
             runs.
             ``phase_family(controls=True)`` adds planted faults (a ring
             shuffled as in epoch 1; FedNAS with equal client weights,
             the valid batch one step off, no alpha step, a pad-only
             batch that steps), which the gates must refuse.
17. imagenet — the ImageNet and Landmarks loaders at 224 px through
             ``experiments.run.main`` (FedAvg, SGD lr 1e-3 wd 1e-3, bf16, no
             augmentation, 4 clients of <= 32 samples per round, batch 16, 2
             rounds, the first a warm-up, 64 test samples) on their stand-ins:
             ResNet-56 on the conv kernel on ILSVRC2012 and gld23k,
             MobileNetV3 and EfficientNet on gld23k, vgg16_bn on ILSVRC2012;
             per pair the parameter count, median round seconds, samples/s,
             final test accuracy and loss (finite), peak memory and the conv
             kernel's launches per forward (19 for ResNet-56, 18 tensor-core
             in each bf16 training forward, counted by the model's forward
             calls; 0 for the others, and no flash launch).  Then an fp32
             eval forward of 2 images at 224 px of vgg16_bn, EfficientNet and
             the kernel ResNet-56, drawn on the card, against the CPU's
             float64 forward (ResNet-56 on library convs there) within
             [silo]'s gate (the larger of 1e-4 and 3x the spread of the CPU's
             fp32 forwards from the init and one ulp off); planted faults (VGG
             pooling a global mean, ResNet-56's stride-2 convs padded on the
             wrong side) must be refused.  Last, ``run.main --algorithm
             base_framework`` on the card: its history equal to the
             plain-Python series exactly.
18. comm   — the message core: ResNet-56's variables on the card in fp32 and
             bf16 through ``tree_to_wire`` → ``Message.to_frame`` →
             ``Message.from_frame_bytes`` → ``tree_from_wire`` back onto the
             card bit for bit, the frame's sha256 and ``wire_tree_digest``
             equal to those built from the CPU copy; a qsgd8 delta wiretree
             encoded on the card, its frame the CPU's.
19. xdevice — cross-device FedAvg through the managers of
             ``algorithms/fedavg_cross_device.py`` over the in-process bus:
             ResNet-56 at full width on the conv kernel (bf16, the CIFAR-10
             stand-in at Dirichlet 0.5, 4 clients of <= 128 samples, batch
             64, 2 rounds, the first a warm-up, cuDNN deterministic).  Sync,
             held against FedAvgSimulation on the card: round 0's aggregate
             within 1e-6, the last round (the simulation's from the
             federation's previous global) within 1e-5, a planted fault (a
             doubled sample count) beyond both; the free-running gap after 3
             rounds and the last round's one-ulp spread printed;
             round 1's sync and upload frames card == CPU by sha256; qsgd8
             + EF uploads with the delta broadcast run twice, the upload
             digests equal; async (cut 2 of 4, poly 0.5, a delayed client)
             folding stale uploads, and at cut 4 and alpha 0 equal to the
             sync run bit for bit; a ChaosBackend NaN upload rejected and
             counted, a x10 attacker clipped by the norm bound, and the
             median close equal to the host median of the decoded uploads.
             Per case the median round, uploads/s, encode/decode/fold ms per
             upload, frame bytes and conv launches per client forward (19,
             18 tensor-core), no flash launch.
20. tcp    — the TCP transport: [xdevice]'s sync federation over the port's
             TcpHub on loopback (2 rounds; server, hub and clients in one process, a
             TcpBackend each), reactor hub with the tcp lane, reactor with
             the shm lane, threaded with the tcp lane, each held against the
             same federation over the InprocBus: round 0's aggregate within
             1e-6, every round-0 upload frame equal by sha256, a planted
             fault (a doubled sample count) beyond the gate, 19 conv
             launches per client forward (18 tensor-core); per run the round
             seconds, uploads/s, encode/decode/fold ms per upload, frames and
             bytes routed and the hub's counters (shm frames, fallbacks)
             beside the in-process figures; a card tensor refused by the
             backend.  Then ``distributed_fedavg.launch()`` as processes on
             the card (hub, server, 3 clients, shm lane, 2 rounds of its LR
             problem; beside it 2 muxers behind 2 edge hubs), each within 1e-5
             of FedAvgSimulation on the card, the tree byte for byte the
             flat run; each launch's wall time and hub counters.
21. mesh   — FedAvg over a clients mesh (``fedml_tpu_torch/parallel/``):
             one ``make_spmd_round_fn`` round of ResNet-56 (full width, conv
             kernel, bf16, [main]'s optimizer, 4 clients x 2 steps of 64) on
             a 1-rank NCCL mesh, byte for byte ``make_round_fn`` on the card
             and timed beside it in turns, 19 conv launches per forward (18
             tensor-core), ``describe_mesh`` on ``cuda``; the two-tier round
             on a 1 x 1 (group, clients) mesh against
             ``HierarchicalSimulation`` and the compiled template round
             against the message form; then 2 gloo ranks sharing the card:
             a dp round within 8 float32 spacings of its one-device round
             and the gossip's dense SPMD form against the dense round, with
             the ranks' start-up seconds (in [sp]'s launch when [sp] runs).
22. tp     — tensor parallelism and rule-driven sharding
             (``fedml_tpu_torch/parallel/{tensor,gspmd,partition}.py``,
             ``compress/sharded.py``) at the fedllm bench width (L 1,024,
             bf16): one ``make_dp_tp_round_fn`` round on a 1-rank NCCL
             (clients, model) mesh and one ``make_rule_round_fn`` round under
             ``FEDLLM_RULES`` on a 1-rank (dp, mp) mesh (4 clients x 2 steps
             of 8), each byte for byte ``make_round_fn`` and timed beside it
             in turns, 12 flash launches per forward, all wgmma; then 2 gloo
             ranks sharing the card (in [sp]'s launch): tp 2, the fp32 TP
             forward within 3e-4 of the 1-rank forward and a planted fault
             (each rank's heads from the wrong columns) beyond it, the bf16
             DP×TP round within 0.05 of the 1-rank round's update, 12 flash
             launches per forward per rank on 5 heads (wgmma in bf16), each
             rank's parameter bytes equal to the count from the shapes and
             the bytes summed over the model axis per step; the rule round on
             a (1, 2) mesh and 2 int8 + EF rule rounds (1 of the 12 layers,
             a shuffled cohort whose residual rows cross the ranks) on a (2,
             1) mesh byte for byte the 1-rank ones; the int8 entries of the
             card's shards byte for byte the CPU's; ``run.main`` with
             ``--tp_degree 2`` and ``--mesh 1,2 --partition_rules fedllm``.
23. sp     — ring attention and sequence parallelism
             (``fedml_tpu_torch/parallel/{ring_attention,sequence,dp_sp}.py``)
             at the fedllm bench width, 2,048 tokens a sequence: one
             ``make_dp_sp_round_fn`` round (flash ring, bf16, 1 client x 2
             steps of 8) on a 1-rank NCCL (clients, sp) mesh, byte for byte
             ``make_round_fn`` over the plain transformer and timed beside it
             in turns, 12 flash launches per forward, all wgmma; then 2 gloo
             ranks sharing the card (one launch with [mesh]'s), 1,024 tokens
             a shard, the K/V ring staged through the host: the fp32
             ``sequence_parallel_lm`` forward within 3e-4 of the 1-rank
             forward, the bf16 round within 0.05 of part 1's update, every
             rank the same bytes, and ``run.main --sp_degree 2``; per rank
             the flash launches, the bytes staged and the seconds.  The same
             launch runs [mesh]'s, [tp]'s, [pp]'s and [ep]'s multi-rank parts.
24. pp     — pipeline parallelism (``fedml_tpu_torch/parallel/pipeline.py``)
             at the fedllm bench width, the flash kernel in every Block of
             every stage: on a 1-rank NCCL pp mesh the 12 Blocks as one
             stage (embedding, final norm and head outside), 4 microbatches
             of 2 x 1,024 tokens forward and backward in bf16 against
             ``serial_reference`` (output within 1e-3, stage gradients
             within 1e-2 of their norm), 48 flash launches a forward, all
             wgmma; then 2 gloo ranks sharing the card (6 Blocks a stage,
             in [sp]'s launch): the fp32 forward within 1e-4 of the 1-rank
             one and a planted fault (the stages swapped) beyond it, the
             bf16 output and stage gradients against the 1-rank ones, each
             rank's first flash call on a real microbatch against
             ``attention_plain`` (2e-2), 30 flash launches a forward a rank
             (bubble ticks compute, as JAX's), the ring hops' bytes staged
             through the host equal to the count from the shapes.
25. ep     — expert parallelism (``fedml_tpu_torch/parallel/expert.py``),
             fp32: the top-1 MoE at the Block's MLP width (1,280 -> 5,120)
             over the bench batch's 8,192 tokens on a 1-rank NCCL ep mesh
             against ``moe_reference`` (1e-5), timed beside it in turns;
             then 2 gloo ranks (an expert and 4,096 tokens a rank, in [sp]'s
             launch): against ``moe_reference`` at capacity 4,096, against
             the dense per-shard oracle at 2,048 (tokens dropped), the
             gradients of gate, experts and tokens against autograd through
             that oracle on one rank (1e-4), the all-to-all bytes against
             the count from the shapes.  No kernel runs in [ep].
26. mux    — the muxed cohort on a mesh of ranks (``fedavg_mux``'s
             ``mesh=``): [xdevice]'s ResNet-56 problem (conv kernel, bf16, 4
             virtual clients, 2 rounds) as a muxer federation over an
             in-process reactor TcpHub, on a 1-rank NCCL (1, 1) mesh beside
             the mesh-free muxer: every upload frame equal by sha256, the
             final models equal, 19 conv launches per forward, a planted
             fault (two rows' slots swapped) beyond the gate; then 2 gloo
             ranks (rank 0 the hub, server and muxer, rank 1 its resident
             worker; in [sp]'s launch): the (2, 1) federation byte for byte
             part 1's with each rank's conv launches, a 3-client cohort on
             the indivisible fallback, the fedllm transformer at the bench
             width cut to 2 layers on a (1, 2) mesh under FEDLLM_RULES byte
             for byte the mesh-free muxer's with each rank's flash launches
             on the wgmma route (deterministic algorithms; once more without
             them, printed).

``--phases a,b,...`` runs only the named phases, in this order; every
phase prints its seconds.

Every kernel's launch counter is zeroed just before each path and read just
after it.  The line before the last is the kernels' JSON record, the line
before that the card's name and power limit; the last line is the device
record.  ``--out`` also writes every per-case number as JSON;
``--profile`` adds a ``torch.profiler`` trace of one round of each main
path (device busy time, idle share, top kernels).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time
import warnings
from typing import Any, Callable, NamedTuple, Optional

N = 64
# (name, spatial, Cin, Cout, stride, convs of this shape per ResNet-56 forward)
CONV_SHAPES = [
    ("stem", 32, 3, 16, 1, 1),
    ("stage1_body", 32, 16, 16, 1, 6),
    ("stage1to2", 32, 32, 32, 2, 1),
    ("stage2_body", 16, 32, 32, 1, 5),
    ("stage2to3", 16, 64, 64, 2, 1),
    ("stage3_body", 8, 64, 64, 1, 5),
]
# the same six shapes at the ImageNet and Landmarks loaders' 224 px ([imagenet]),
# where a launch runs ~12.5k-50k blocks and the moment reduce folds as many
# partial rows: bf16 with moments, as in a training forward
N_224 = 16
CONV_SHAPES_224 = [
    ("stem_224", 224, 3, 16, 1, 1),
    ("stage1_body_224", 224, 16, 16, 1, 6),
    ("stage1to2_224", 224, 32, 32, 2, 1),
    ("stage2_body_224", 112, 32, 32, 1, 5),
    ("stage2to3_224", 112, 64, 64, 2, 1),
    ("stage3_body_224", 56, 64, 64, 1, 5),
]
# (name, B, L, H, D, dtype, causal): the fedllm bench shape first; B*L = 8192
# across the long-context range; one rank's 5 of the 10 heads under tp 2;
# run.py's fedllm defaults (width 64 / 4 heads,
# 80-char windows, batch 64), in fp32 and in bf16 (the mma route)
FLASH_CASES = [
    ("bench", 8, 1024, 10, 128, "bf16", True),
    ("bench", 8, 1024, 10, 128, "fp32", True),
    ("bench_noncausal", 8, 1024, 10, 128, "bf16", False),
    ("long2k", 4, 2048, 10, 128, "bf16", True),
    ("long4k", 2, 4096, 10, 128, "bf16", True),
    ("long8k", 1, 8192, 10, 128, "bf16", True),
    ("bench_d64", 8, 1024, 20, 64, "bf16", True),
    # a tensor-parallel rank's heads at the bench width, tp 2 ([tp])
    ("tp2_rank", 8, 1024, 5, 128, "bf16", True),
    ("run_py", 64, 80, 4, 16, "fp32", True),
    ("run_py_bf16", 64, 80, 4, 16, "bf16", True),
]
BENCH_LAYERS = 12  # flash launches per forward at the bench width
# [north_star]'s steps per client (the bench's 24, cut to make room for
# [mesh]; the timed round's per-step time is the measure)
NORTH_STAR_STEPS = 12
TC_PER_FORWARD = 18  # tensor-core launches per bf16 ResNet-56 forward: every 3x3 conv but the stem
TOL = {"fp32": 1e-4, "bf16": 2e-2}
MOMENT_RTOL = 1e-3
LSE_TOL = 1e-3
# bf16 transformer logits, flash kernel vs the kernel's arithmetic in plain
# PyTorch (attention_as_kernel): at most this many bf16 spacings at the
# largest logit (the card read one; PERF.md)
BF16_LOGITS_ULPS = 2


# threefry and augment draws held bitwise against the CPU and against the
# known answers of jax 0.9.0 in tests/threefry_known_answers.json:
# (name, draw, seed of PRNGKey, arguments)
RNG_CASES = [
    ("bits_s0_4x257", "random_bits", 0, {"shape": (4, 257)}),
    ("bits_s42_3x5x7", "random_bits", 42, {"shape": (3, 5, 7)}),
    ("uniform_s1_1000", "uniform", 1, {"shape": (1000,)}),
    ("bernoulli_s2_p05", "bernoulli", 2, {"p": 0.5, "shape": (1000,)}),
    ("bernoulli_s2_p09", "bernoulli", 2, {"p": 0.9, "shape": (1000,)}),
    ("randint_s3_64x2_9", "randint", 3, {"shape": (64, 2), "lo": 0, "hi": 9}),
    ("randint_s3_1000_33", "randint", 3, {"shape": (1000,), "lo": 0, "hi": 33}),
    ("permutation_s4_1536", "permutation", 4, {"n": 1536}),      # one sort pass
    ("permutation_s5_15360", "permutation", 5, {"n": 15360}),    # two sort passes
    ("cifar_augment_s6_64", "cifar_augment", 6, {"images": 64}),
    ("cinic_augment_s7_64", "cinic_augment", 7, {"images": 64}),   # cutout=None
]
RNG_ANSWERS = "tests/threefry_known_answers.json"

# the cross-device zoo through experiments/run.py: (dataset, model, batch, lr,
# samples per client, tokens per sample or None, number of classes, one
# example's shape).  SGD with no weight decay at the batch and lr of the JAX
# package's convergence record for the pair (CONVERGENCE_r04_mnist_lr,
# _r04_femnist_cnn, _r05_fed_cifar100, _r04_shakespeare_rnn,
# _r05_stackoverflow_nwp); stackoverflow_lr has no record and takes
# mnist-lr's.  Shards are cut to the samples column.
ZOO = [
    ("mnist", "lr", 10, 0.03, 100, None, 10, (784,)),
    ("femnist", "cnn", 20, 0.03, 100, None, 62, (28, 28, 1)),
    ("fed_cifar100", "resnet18_gn", 20, 0.1, 100, None, 100, (24, 24, 3)),
    ("shakespeare", "rnn", 4, 1.0, 32, 80, 90, (80,)),
    ("fed_shakespeare", "rnn", 4, 1.0, 32, 80, 90, (80,)),
    ("stackoverflow_nwp", "rnn", 16, 0.31622776601683794, 64, 20, 10004, (20,)),
    ("stackoverflow_lr", "lr", 10, 0.03, 64, None, 500, (10000,)),
]
# (5 clients a round and 256 test samples, cut from 10 and 512 to make room
# for [mesh])
ZOO_CLIENTS, ZOO_PER_ROUND, ZOO_ROUNDS, ZOO_TEST = 100, 5, 2, 256
# [compress]: the codec stage's share of a round, the plain and
# int8 + EF rounds timed in turns (plain, int8, int8, plain) this many times
COMPRESS_TURNS = 1
# ... of a 4 x COMPRESS_STEPS x 64 round (cut from 8 steps to make room for
# [mesh]), and its host ops profiled over COMPRESS_PROFILED clients of one
# step each (cut from 4)
COMPRESS_STEPS, COMPRESS_PROFILED = 4, 2

# [silo]: FedML's cross-silo benchmark rows (BASELINE.md, "Cross-silo DNNs":
# FedAvg, LDA alpha 0.5, SGD lr 1e-3, wd 1e-3, batch 64) through
# experiments/run.py's main at full width, bf16, augmentation on (crop, flip
# and Cutout(16) on cifar100, crop and flip on cinic10): 4 clients of <= 64
# samples (1 step of 64; cut from 128 to make room for [mesh]), 2 rounds (the
# first a warm-up), 128 test samples (cut from 256).
# (dataset, model, extra flags); ResNet-56 runs its 3x3 convs on the kernel
SILO_PAIRS = [
    ("cifar100", "resnet56", ["--conv_variant", "kernel"]),
    ("cinic10", "resnet56", ["--conv_variant", "kernel"]),
    ("cifar100", "mobilenet", []),
    ("cinic10", "mobilenet", []),
    ("cifar100", "vgg16_bn", []),
    ("cifar100", "mobilenet_v3", []),
    ("cifar100", "efficientnet", []),
]
SILO_CLIENTS, SILO_SAMPLES, SILO_BATCH, SILO_ROUNDS, SILO_TEST = 4, 64, 64, 2, 128
SILO_COMMON = [
    "--algorithm", "fedavg", "--client_num_in_total", str(SILO_CLIENTS),
    "--client_num_per_round", str(SILO_CLIENTS), "--partition_method", "hetero",
    "--partition_alpha", "0.5", "--batch_size", str(SILO_BATCH),
    "--max_samples_per_client", str(SILO_SAMPLES), "--max_test_samples", str(SILO_TEST),
    "--comm_round", str(SILO_ROUNDS), "--lr", "0.001", "--wd", "0.001",
    "--compute_dtype", "bf16", "--seed", "0"]
# the new families at their registry widths (cifar100: 100 classes, 32 px):
# their seeded inits are held to tests/silo_init_digests.json ([init]) and
# one make_round_fn round each (2 clients x 2 steps of SILO_ROUND_BATCH, SGD
# lr 1e-3, dropout and drop-connect on) card fp32 to the CPU's float64
SILO_FAMILIES = ["vgg16_bn", "mobilenet", "mobilenet_v3", "efficientnet"]
SILO_ROUND_BATCH, SILO_ROUND_LR = 8, 1e-3
# these BatchNorm nets end at 1x1 maps, where the statistics are over the
# batch alone, and at batch 8 an fp32 round can land further from float64
# than ZOO_ROUND_RTOL (MobileNet 1.4e-3-1.7e-3 on an 8-core x86 CPU, from the
# init and from it one ulp up and down): the card's round is held within
# the larger of ZOO_ROUND_RTOL and SILO_CHAOS x that spread, measured in
# the run; the planted faults of phase_silo(controls=True) land beyond it
# (readings: PERF.md §6)
SILO_CHAOS = 3.0
SILO_DIGESTS = "tests/silo_init_digests.json"

# [imagenet]: the ImageNet and Landmarks loaders at their 224 px through
# experiments/run.py's main (FedAvg, SGD lr 1e-3, wd 1e-3, bf16, no
# augmentation: the reference's ImageNet and Landmarks loaders train
# unaugmented in the JAX package too) on their stand-ins (ILSVRC2012: 1000
# classes, 16 images per client; gld23k: 203 classes over the power-law
# stand-in's 50 clients): 4 clients per round of <= 32 samples, 2 rounds (the
# first a warm-up), batch 16, 64 test samples.  ResNet-56 runs its 3x3
# convs on the kernel, at ~12.5k-50k blocks per launch.
IMAGENET_PAIRS = [
    ("ILSVRC2012", "resnet56", ["--conv_variant", "kernel"]),
    ("gld23k", "resnet56", ["--conv_variant", "kernel"]),
    ("gld23k", "mobilenet_v3", []),
    ("gld23k", "efficientnet", []),
    ("ILSVRC2012", "vgg16_bn", []),
]
IMAGENET_CLIENTS, IMAGENET_SAMPLES, IMAGENET_BATCH, IMAGENET_ROUNDS, IMAGENET_TEST = (
    4, 32, 16, 2, 64)
IMAGENET_COMMON = [
    "--algorithm", "fedavg", "--client_num_in_total", str(IMAGENET_CLIENTS),
    "--client_num_per_round", str(IMAGENET_CLIENTS), "--batch_size", str(IMAGENET_BATCH),
    "--max_samples_per_client", str(IMAGENET_SAMPLES), "--max_test_samples",
    str(IMAGENET_TEST), "--comm_round", str(IMAGENET_ROUNDS), "--lr", "0.001", "--wd",
    "0.001", "--compute_dtype", "bf16", "--seed", "0"]
# the models whose 224-px code paths have run only at 32 px before (VGG's
# 7x7 pool bins, EfficientNet's SAME padding from 224 down to 7, ResNet-56's
# kernel convs at 224/112/56): an fp32 eval forward of 2 images, the card's
# against the CPU's float64 forward of the same variables, (model, dataset,
# classes); ResNet-56 runs on the kernel on the card and on library convs on
# the CPU.  The gate is [silo]'s: the larger of ZOO_ROUND_RTOL and SILO_CHAOS x
# the spread of the CPU's fp32 forwards (from the init, one ulp up and one ulp
# down) from float64, each gap max |Δlogit| over max |logit| of float64's
IMAGENET_FORWARDS = [("vgg16_bn", "ILSVRC2012", 1000), ("efficientnet", "gld23k", 203),
                     ("resnet56", "ILSVRC2012", 1000)]
IMAGENET_SIDE = 224  # the loaders' image_size

# [algos]: the FedAvg-engine family through experiments/run.py's main on
# full-width ResNet-56 (every 3x3 conv on the kernel, bf16 compute) over the
# CIFAR-10 stand-in: 4 clients of 64 samples (an equal split: 1 full step of
# 64 each per round; cut from 128 to make room for [mesh]), 1 round (cut
# from 2 to make room for [tcp]: the
# identities below are held after round 1), 256 test samples, SGD lr 0.01,
# no decay
ALGO_CLIENTS, ALGO_SAMPLES, ALGO_BATCH, ALGO_ROUNDS, ALGO_TEST = 4, 64, 64, 1, 256
ALGO_COMMON = [
    "--dataset", "cifar10", "--model", "resnet56", "--conv_variant", "kernel",
    "--client_num_in_total", str(ALGO_CLIENTS), "--client_num_per_round",
    str(ALGO_CLIENTS), "--partition_method", "homo", "--batch_size", str(ALGO_BATCH),
    "--max_samples_per_client", str(ALGO_SAMPLES), "--max_test_samples", str(ALGO_TEST),
    "--comm_round", str(ALGO_ROUNDS), "--lr", "0.01", "--wd", "0",
    "--compute_dtype", "bf16", "--seed", "0"]
ALGO_CASES = [
    ("fedavg", ["--algorithm", "fedavg"]),
    ("fedprox_mu0", ["--algorithm", "fedprox", "--mu", "0"]),
    ("fedprox_mu0.01", ["--algorithm", "fedprox", "--mu", "0.01"]),
    ("fedopt_sgd_lr1", ["--algorithm", "fedopt", "--server_optimizer", "sgd",
                        "--server_lr", "1"]),
    ("fedopt_adam", ["--algorithm", "fedopt", "--server_optimizer", "adam",
                     "--server_lr", "0.01"]),
    ("fedopt_yogi", ["--algorithm", "fedopt", "--server_optimizer", "yogi",
                     "--server_lr", "0.01"]),
    ("fednova_m0", ["--algorithm", "fednova"]),
    ("fednova_m0.9", ["--algorithm", "fednova", "--momentum", "0.9"]),
    ("robust_norm_diff_clipping", ["--algorithm", "fedavg_robust", "--defense_type",
                                   "norm_diff_clipping"]),
    ("robust_weak_dp", ["--algorithm", "fedavg_robust", "--defense_type", "weak_dp"]),
    ("robust_median", ["--algorithm", "fedavg_robust", "--defense_type", "median"]),
    ("hierarchical", ["--algorithm", "hierarchical", "--group_num", "2",
                      "--group_comm_round", "2"]),
]
# held on the card: (case, reference case, checkpoint step, max |Δ| of any
# variable).  The entry point's server sgd keeps a 0.9 trace (the JAX
# entry point passes no server momentum), which equals FedAvg after the
# first round only.  FedNova's aggregate differs from FedAvg's by fp32
# rounding (~1e-7) after round 1; in round 2 the bf16 forward rounds those
# weights, where a 1-ulp difference can flip a bf16 rounding (2^-8
# relative), so the identity is held after round 1 (the CPU rehearsal at
# a small cut: 1.2e-7 after round 1, 1.1e-2 after round 2).
ALGO_IDENTITIES = [("fedprox_mu0", "fedavg", ALGO_ROUNDS, 0.0),
                   ("fedopt_sgd_lr1", "fedavg", 1, 1e-6),
                   ("fednova_m0", "fedavg", 1, 1e-5)]
# [standalone]: the drivers beside the FedAvg engine through experiments/run.py's
# main at [algos]' cut (ALGO_COMMON: the kernel ResNet-56, bf16, 4 clients of
# 128 CIFAR-10 stand-in samples, batch 64, ALGO_ROUNDS rounds, 256 test
# samples, seed 0); fedgkt runs its own pair (resnet8_56 clients,
# resnet56_server) in fp32 on library convs, so it drops
# --conv_variant/--compute_dtype, and FEDGKT_ROUNDS rounds: its distillation
# starts in round 1
# centralized trains on the whole 5,000-image stand-in: one epoch
CENTRAL_EPOCHS = 1
FEDGKT_ROUNDS = 2
STANDALONE_CASES = [
    ("centralized", ["--algorithm", "centralized", *ALGO_COMMON, "--comm_round",
                     str(CENTRAL_EPOCHS)]),
    ("decentralized", ["--algorithm", "decentralized", *ALGO_COMMON]),
    ("turboaggregate", ["--algorithm", "turboaggregate", *ALGO_COMMON]),
    ("fedgkt", ["--algorithm", "fedgkt", "--epochs_server", "1",
                *[a for flag, value in zip(ALGO_COMMON[::2], ALGO_COMMON[1::2])
                  if flag not in ("--conv_variant", "--compute_dtype", "--comm_round")
                  for a in (flag, value)], "--comm_round", str(FEDGKT_ROUNDS)]),
]
# the card's fp32 round against the CPU's float64 one: max |Δ| of every leaf,
# relative to the leaf's largest magnitude
ZOO_ROUND_RTOL = 1e-4
# [family]: the rest of the algorithm family through experiments/run.py's main,
# fp32 on library convs, over 4 clients of the CIFAR-10 stand-in (homo).
# SplitNN: 256 samples each (cut from 512 to make room for [mesh]), batch 64,
# one ring epoch (the McMahan CNN's
# halves at full width: 32/64 channels, a 512-wide dense layer) at SGD lr
# 0.003, where the loss falls (at 0.01 it rises past ln 10).  FedNAS: 16
# samples each (one step of 16 a round), one round of search (the entry
# point's darts_search(C=8, layers=4)) then one of train, at arch_order 1 and 2.
FAMILY_COMMON = ["--dataset", "cifar10", "--client_num_in_total", "4",
                 "--client_num_per_round", "4", "--partition_method", "homo", "--seed", "0"]
SPLIT_ARGV = ["--algorithm", "splitnn", *FAMILY_COMMON, "--max_samples_per_client", "256",
              "--max_test_samples", "512", "--batch_size", "64", "--comm_round", "1",
              "--lr", "0.003"]
# FedNAS's search and train rounds run NAS_CLIENTS of them (cut from 4 to make
# room for [mesh]: a DARTS step is 1.2-2.9 s on the card)
NAS_CLIENTS = 2
NAS_ARGV = ["--algorithm", "fednas", "--stage", "train", *FAMILY_COMMON,
            "--client_num_in_total", str(NAS_CLIENTS), "--client_num_per_round",
            str(NAS_CLIENTS), "--max_samples_per_client", "16", "--max_test_samples", "256",
            "--batch_size", "16", "--comm_round", "1"]
# [family] SplitNN: the fp32 ring is chaotic (a ReLU pre-activation within
# fp32's rounding of zero takes the other side in float64, and the runs
# part from there; the CPU's fp32 epoch from an init one ulp off lands as
# far from float64 as the card's).  So each card step, taken from the CPU's
# float64 state, is held to the float64 step within SPLIT_STEP_RTOL, and
# the card's epoch to SPLIT_CHAOS x how far those one-ulp epochs land; a
# ring shuffled as in epoch 1 lands far beyond (controls).  Readings:
# PERF.md §6.
SPLIT_STEP_RTOL, SPLIT_CHAOS = 1e-3, 2.0
# VFL: a seeded loan_processed.npz of 262,144 rows (about a tenth of Lending
# Club's) at the reference's 83 feature columns, a guest and a host, batch
# 256, one epoch; the card's first VFL_CHECK_STEPS steps against the CPU's
VFL_ROWS, VFL_BATCH, VFL_CHECK_STEPS, VFL_TOL = 262144, 256, 16, 1e-5
# FedNAS, card fp32 against CPU float64: one order-2 round of the entry
# point's net (C 8, 4 layers) over 2 CIFAR-10 stand-in clients of 16 and 8
# samples cropped to 16x16, batch 8 (client 1's second batch pad-only).
# Adam moves every alpha by ~arch_lr a step whatever its gradient's size,
# so an alpha whose gradient is near zero (under NAS_MASK_TAU of its
# leaf's largest at some step) follows rounding; and the float32 losses,
# BatchNorm statistics and mean (as in JAX) put fp32 rounding into a
# float64 run too.  The limits sit between the card's round and the
# planted faults of phase_family's controls (readings: PERF.md §6).
NAS_CHECK = (16, 8, 16, 8)  # clients' samples, crop, batch
NAS_VARS_RTOL, NAS_ALPHA_RTOL, NAS_MASK_TAU = 0.05, 0.05, 0.1


def augment_images(n: int):
    """The fixed NHWC image tensor of the augment case (numpy's legacy
    stream, stable across numpy versions)."""
    import numpy as np

    return np.random.RandomState(0).standard_normal((n, 32, 32, 3)).astype(np.float32)


def rng_case(draw: str, seed: int, kw: dict, device):
    """One RNG_CASES draw through the port on ``device``, as a numpy array
    in JAX's dtype (uint32 bits, float32, bool, int32)."""
    import numpy as np
    import torch

    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.data.augment import cifar_augment, make_image_augment

    key = rng.PRNGKey(seed)
    if draw == "random_bits":
        return rng.random_bits(key, kw["shape"], device).cpu().numpy().astype(np.uint32)
    if draw == "uniform":
        out = rng.uniform(key, kw["shape"], device)
    elif draw == "bernoulli":
        out = rng.bernoulli(key, kw["p"], kw["shape"], device)
    elif draw == "randint":
        out = rng.randint(key, kw["shape"], kw["lo"], kw["hi"], device)
    elif draw == "permutation":
        out = rng.permutation(key, kw["n"], device).to(torch.int32)
    elif draw in ("cifar_augment", "cinic_augment"):
        x = torch.from_numpy(augment_images(kw["images"])).to(device)
        augment = (cifar_augment() if draw == "cifar_augment"
                   else make_image_augment(pad=4, flip=True, cutout=None))
        out = augment(key, x)
    else:
        raise ValueError(f"unknown draw {draw!r}")
    return out.cpu().numpy()


def answer_of(arr) -> dict:
    """The known-answer record of a draw: dtype, shape, sha256 of its bytes
    and its first 8 values."""
    import hashlib

    import numpy as np

    arr = np.ascontiguousarray(arr)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            "head": arr.ravel()[:8].tolist()}


def init_digests(variables: dict) -> dict:
    """sha256 of each leaf's float32 bytes under its flax path
    (``params/Conv_0/kernel``), the form of tests/silo_init_digests.json."""
    import hashlib

    return {f"{c}/{k.replace('.', '/')}": hashlib.sha256(
        v.float().cpu().numpy().tobytes()).hexdigest()
        for c in variables for k, v in variables[c].items()}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def conv_bound_ms(n, hw, ci, co, stride, dtype_name, moments, epilogue):
    """(ms to move the bytes, ms to do the FLOPs): each input read once and
    each output written once over HBM; FLOPs at the card's peak for the
    type.  The bound is the larger."""
    from fedml_tpu_torch.utils.timing import HBM_BYTES_PER_S, PEAK_FLOPS

    es = 2 if dtype_name == "bf16" else 4
    ho = hw // stride
    nbytes = (n * hw * hw * ci + 9 * ci * co + n * ho * ho * co) * es
    if moments:
        nbytes += 2 * co * 4
    if epilogue:
        nbytes += 2 * co * 4
    flops = 2.0 * n * ho * ho * 9 * ci * co
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / PEAK_FLOPS[dtype_name]


def phase_build():
    from fedml_tpu_torch.ops import build

    t0 = time.perf_counter()
    reports = build.build_all(["conv_mxu", "flash_attention"])
    secs = time.perf_counter() - t0
    print(f"[build] {secs:.2f} s for {sorted(reports) or 'nothing (up to date)'}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}")
    return secs


def phase_kernels(shapes=CONV_SHAPES, n=N, variants=None):
    """Every conv case of ``shapes`` at batch ``n`` (default: fp32 and bf16,
    with and without moments, and one epilogue case) against the plain
    version; the moments' sums also against float64 sums of each side's
    own output, so a stray reduce shows which side strays."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops.conv_mxu import conv3x3_mxu, conv3x3_plain
    from fedml_tpu_torch.utils.timing import kernel_ms

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    cases = []
    default = variants is None
    if default:
        variants = [(d, mom, False) for d in ("fp32", "bf16") for mom in (False, True)]
    for name, hw, ci, co, stride, per_fwd in shapes:
        for dname, moments, epilogue in variants + (
                [("fp32", False, True)] if default and name == "stage1_body" else []):
            dtype = torch.float32 if dname == "fp32" else torch.bfloat16
            x = torch.randn(n, hw, hw, ci, generator=g).to(dev, dtype)
            w = (torch.randn(3, 3, ci, co, generator=g)
                 * math.sqrt(2.0 / (9 * ci))).to(dev, dtype)
            kw = dict(stride=stride, moments=moments)
            if epilogue:
                kw.update(mul=torch.linspace(0.5, 1.5, co, device=dev),
                          add=torch.linspace(-0.3, 0.3, co, device=dev), relu=True)
            tc_before = conv3x3_mxu.tc_launches
            got = conv3x3_mxu(x, w, **kw)
            route = "tc" if conv3x3_mxu.tc_launches > tc_before else "v2"
            ref = conv3x3_plain(x, w, **kw)
            torch.cuda.synchronize()
            gy, ry = (got[0], ref[0]) if moments else (got, ref)
            gy, ry = gy.float(), ry.float()
            abs_err = (gy - ry).abs().max().item()
            rel_err = ((gy - ry).abs() / ry.abs().clamp_min(1e-6)).max().item()
            tol = TOL[dname]
            if not torch.allclose(gy, ry, rtol=tol, atol=tol):
                fail(f"{name} {dname} moments={moments}: max abs err {abs_err}")
            rec = {"shape": name, "n": n, "hw": hw, "cin": ci, "cout": co,
                   "stride": stride, "dtype": dname, "moments": moments,
                   "epilogue": epilogue, "per_forward": per_fwd, "route": route,
                   "max_abs_err": abs_err, "max_rel_err": rel_err}
            if moments:
                # sum is compared against Σ|y| (its scale: a channel's sum
                # may cancel to ~0); sumsq is all-positive, so plainly relative
                scale = ry.abs().sum((0, 1, 2))
                s_err = ((got[1] - ref[1]).abs() / scale.clamp_min(1e-6)).max().item()
                sq_err = ((got[2] - ref[2]).abs() / ref[2].abs().clamp_min(1e-6)).max().item()
                # each side's sum against the float64 sum of its own output
                f64 = {side: ((out[1].double() - out[0].double().sum((0, 1, 2))).abs()
                              / scale.double().clamp_min(1e-6)).max().item()
                       for side, out in (("kernel", got), ("plain", ref))}
                rec.update(sum_rel_err=s_err, sumsq_rel_err=sq_err,
                           sum_vs_f64={k: v for k, v in f64.items()})
                if s_err > MOMENT_RTOL or sq_err > MOMENT_RTOL:
                    fail(f"{name} {dname} moments: rel err sum {s_err} sumsq {sq_err}; "
                         f"each side's sum against float64: {f64}")
            wn = w.permute(3, 2, 0, 1)
            xn = x.permute(0, 3, 1, 2)
            rec["ms"] = kernel_ms(lambda: conv3x3_mxu(x, w, **kw))
            rec["plain_ms"] = kernel_ms(lambda: conv3x3_plain(x, w, **kw))
            rec["library_ms"] = kernel_ms(
                lambda: F.conv2d(xn, wn, stride=stride, padding=1))
            rec["bytes_ms"], rec["ops_ms"] = conv_bound_ms(
                n, hw, ci, co, stride, dname, moments, epilogue)
            rec["bound_ms"] = max(rec["bytes_ms"], rec["ops_ms"])
            cases.append(rec)
            f64 = rec.get("sum_vs_f64")
            print(f"[kernels] {name:12s} N={n} {dname} mom={int(moments)} epi={int(epilogue)} "
                  f"{route} abs {abs_err:.3g} rel {rel_err:.3g}"
                  + (f" sum {rec['sum_rel_err']:.3g} sumsq {rec['sumsq_rel_err']:.3g} (sums vs "
                     f"float64: kernel {f64['kernel']:.3g}, plain {f64['plain']:.3g})"
                     if f64 else "")
                  + f" | kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} library "
                  f"{rec['library_ms']:.4f} bound {rec['bound_ms']:.4f} ({rec['bytes_ms']:.4f} "
                  "bytes)")
    return cases


def phase_check():
    """Kernel-conv ResNet-56 vs library-conv ResNet-56, same variables, at
    CIFAR's 32 px (batch 8) and at the ImageNet loaders' 224 px (batch 2)."""
    import torch

    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.models.resnet import resnet56
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

    kern, base = resnet56_tpu(conv_variant="kernel"), resnet56()
    variables = kern.init(PRNGKey(1))
    for batch, side in ((8, 32), (2, 224)):
        x = torch.randn(batch, side, side, 3,
                        generator=torch.Generator().manual_seed(2)).cuda()
        with torch.no_grad():
            le, lb = kern.apply_eval(variables, x), base.apply_eval(variables, x)
            te, nve = kern.apply_train(variables, x)
            tb, nvb = base.apply_train(variables, x)
        err_eval = (le - lb).abs().max().item()
        err_train = (te - tb).abs().max().item()
        err_stats = max((nve["batch_stats"][k] - nvb["batch_stats"][k]).abs().max().item()
                        for k in nvb["batch_stats"])
        print(f"[check] ResNet-56 kernel vs library convs at {side} px (batch {batch}): "
              f"eval logits {err_eval:.3g}, train logits {err_train:.3g}, batch_stats "
              f"{err_stats:.3g}")
        if not (torch.allclose(le, lb, rtol=1e-3, atol=1e-3)
                and torch.allclose(te, tb, rtol=1e-3, atol=1e-3) and err_stats < 1e-3):
            fail(f"kernel-conv ResNet-56 disagrees with the library-conv model at {side} px")


# [check]'s resnet_tpu execution variants: fp32 (TF32 off) on 8 images at 32
# px against the library ResNet-56 at the CPU test's tolerances
# (tests/test_torch_resnet.py) for the logits, loss and statistics; ResNet-56's
# fp32 gradients at batch 8 are ~1% of their largest value from float64 on the
# library model itself, so a variant's gradients are held to float64 at twice
# the library model's own fp32 gap; then one warm bf16 train step each at the
# bench's batch beside the kernel route's (printed, no gate)
CHECK_VARIANT_TOL = dict(eval=(2e-4, 2e-5), loss=1e-5, stats=(2e-4, 1e-5), grads=2.0)
CHECK_STEP_BATCH = 64


def _variant_train(bundle, variables, x, y, dtype):
    """Train loss, new BatchNorm statistics and parameter gradients of a
    softmax-CE step of ``bundle`` in ``dtype``."""
    import torch
    import torch.nn.functional as F

    cast = {c: {k: v.to(dtype) for k, v in sub.items()} for c, sub in variables.items()}
    params = {k: v.clone().requires_grad_(True) for k, v in cast["params"].items()}
    logits, new = bundle.apply_train({**cast, "params": params}, x.to(dtype))
    loss = F.cross_entropy(logits.float(), y)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach().double(), new["batch_stats"], [g.double() for g in grads]


def _variant_gaps(bundle, base, variables, x, y, ref) -> dict:
    """``bundle`` against the library model ``base`` on the same variables,
    as multiples of each gate (<= 1 passes): eval logits, train loss and
    BatchNorm statistics against ``base``'s fp32 (max of |Δ| / (atol + rtol
    |want|)); the gradients' largest |Δ| from ``base``'s float64 gradients
    over CHECK_VARIANT_TOL["grads"] times ``base``'s own fp32 one (``ref``:
    ``base``'s fp32 and float64 ``_variant_train``)."""
    import torch

    def ratio(got, want, tol):
        rtol, atol = tol
        got, want = got.detach(), want.detach()
        return float(((got - want).abs() / (atol + rtol * want.abs())).max())

    (lb, sb, gb), (_, _, g64) = ref
    with torch.no_grad():
        ev = ratio(bundle.apply_eval(variables, x), base.apply_eval(variables, x),
                   CHECK_VARIANT_TOL["eval"])
    lv, sv, gv = _variant_train(bundle, variables, x, y, torch.float32)
    own = max(float((a - b).abs().max()) for a, b in zip(gb, g64))
    got = max(float((a - b).abs().max()) for a, b in zip(gv, g64))
    return {"eval": ev,
            "loss": float((lv - lb).abs() / (CHECK_VARIANT_TOL["loss"] * lb.abs())),
            "stats": max(ratio(sv[k], sb[k], CHECK_VARIANT_TOL["stats"]) for k in sb),
            "grads": got / (CHECK_VARIANT_TOL["grads"] * own)}


def phase_check_variants(device: str = "cuda") -> dict:
    """ResNet-56's space-to-depth (``s2d_stages`` 1/2/3) and lane-padding
    (``pad_stage1_to=32``) variants (``models/resnet_tpu.py``, library
    convs, as in JAX) against the library ResNet-56 (``models/resnet.py``)
    on the same variables, fp32 with TF32 off, 8 images at 32 px: eval
    logits, train loss, BatchNorm statistics and gradients within the CPU
    test's tolerances; a planted fault (the stem's re-scattered kernel with
    its taps transposed) beyond them.  Then one warm bf16 local-update step
    at batch 64 per variant beside the kernel route's and the library's,
    printed with no gate (no kernel of the port runs in the variants)."""
    import torch

    import fedml_tpu_torch.models.resnet_tpu as rt
    from fedml_tpu_torch.bench import TPU_VARIANTS
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.models.resnet import resnet56

    card = smi_line() if device == "cuda" else "cpu"
    base = resnet56(device=device)
    variables = base.init(PRNGKey(1))
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(8, 32, 32, 3, generator=gen).to(device)
    y = torch.randint(0, 10, (8,), generator=gen).to(device)
    bundles = {k: rt.resnet56_tpu(conv_variant="xla", device=device, **kw)
               for k, kw in TPU_VARIANTS.items()}
    ref = (_variant_train(base, variables, x, y, torch.float32),
           _variant_train(base, variables, x, y, torch.float64))
    rec: dict = {"gpu": card, "gaps": {}, "library_fp32_grad_gap": max(
        float((a - b).abs().max()) for a, b in zip(ref[0][2], ref[1][2]))}
    for name, bundle in bundles.items():
        gaps = _variant_gaps(bundle, base, variables, x, y, ref)
        rec["gaps"][name] = gaps
        print(f"[check] ResNet-56 {name} ({TPU_VARIANTS[name]}, library convs) vs the library "
              f"ResNet-56, fp32, 8 x 32 px, as multiples of the gates {CHECK_VARIANT_TOL}: "
              f"eval logits {gaps['eval']:.3g}, train loss {gaps['loss']:.3g}, BatchNorm stats "
              f"{gaps['stats']:.3g}, gradients' gap from float64 over 2x the library model's "
              f"({rec['library_fp32_grad_gap']:.3g}) {gaps['grads']:.3g} (gate 1) ({card})")
        if not max(gaps.values()) <= 1.0:
            fail(f"check: the {name} variant of ResNet-56 is not the library model's function")
    scatter = rt.s2d_kernel_stride1

    def transposed(w):  # the stem's (its only kernel with 3 input channels)
        out = scatter(w)
        return out.transpose(0, 1) if w.shape[2] == 3 else out

    rt.s2d_kernel_stride1 = transposed
    try:
        fault = _variant_gaps(bundles["s2d1"], base, variables, x, y, ref)
    finally:
        rt.s2d_kernel_stride1 = scatter
    rec["fault"] = fault
    print(f"[check] planted fault (s2d1's stem kernel with its taps transposed): eval logits "
          f"{fault['eval']:.3g}, gradients {fault['grads']:.3g} times the tolerance ({card})")
    if not max(fault.values()) > 1.0:
        fail("check: the planted fault (transposed s2d taps) passed the variant gates")
    opt = make_client_optimizer("sgd", 0.001, momentum=0.9, weight_decay=1e-3)
    steps = {"kernel": rt.resnet56_tpu(conv_variant="kernel", device=device),
             "library": base, **bundles}
    xs = torch.randn(1, CHECK_STEP_BATCH, 32, 32, 3, generator=gen).to(device)
    ys = torch.randint(0, 10, (1, CHECK_STEP_BATCH), generator=gen).to(device)
    mask = torch.ones(1, CHECK_STEP_BATCH, device=device)
    rec["step_ms"] = {}
    for name, bundle in steps.items():
        lu = make_local_update(bundle, opt, 1, compute_dtype=torch.bfloat16)
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            new, _ = lu(variables, xs, ys, mask, PRNGKey(0))
            float(next(iter(new["params"].values())).sum())  # waits for the card
            times.append(1e3 * (time.perf_counter() - t0))
        rec["step_ms"][name] = times[-1]
    print(f"[check] one warm bf16 train step of {CHECK_STEP_BATCH} images at 32 px, ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in rec["step_ms"].items())
          + f" (no gate; the variants run library convs) ({card})")
    return rec


def phase_flash_kernels():
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops.flash_attention import (
        _flash_plan, attention_plain, flash_attention_fwd)
    from fedml_tpu_torch.utils.timing import flash_bound_ms, kernel_ms

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    cases = []
    for name, b, L, h, d, dname, causal in FLASH_CASES:
        dtype = torch.float32 if dname == "fp32" else torch.bfloat16
        # the strided column blocks of one fused QKV projection, as the
        # transformer hands them to the kernel
        qkv = torch.randn(b, L, 3, h, d, generator=g).to(dev, dtype)
        q, k, v = qkv.unbind(2)
        wg_before = flash_attention_fwd.wgmma_launches
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        route = ("wgmma" if flash_attention_fwd.wgmma_launches > wg_before
                 else "mma" if dname == "bf16" else "fma")
        if route != _flash_plan(dtype, d, L, L, causal).route:
            fail(f"flash {name} {dname}: took the {route} route")
        ro, rlse = attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        tol = TOL[dname]
        if not (torch.allclose(o.float(), ro.float(), rtol=tol, atol=tol)
                and torch.allclose(lse, rlse, rtol=LSE_TOL, atol=LSE_TOL)):
            fail(f"flash {name} {dname}: max abs err O {err}, LSE {lse_err}")
        del ro, rlse
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rec = {"case": name, "b": b, "l": L, "h": h, "d": d, "dtype": dname,
               "causal": causal, "route": route, "max_abs_err": err,
               "lse_max_abs_err": lse_err,
               "ms": kernel_ms(lambda: flash_attention_fwd(q, k, v, causal=causal)),
               "plain_ms": kernel_ms(lambda: attention_plain(q, k, v, causal), reps=5),
               "library_ms": kernel_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal))}
        rec["bytes_ms"], rec["ops_ms"] = flash_bound_ms(b, L, L, h, d, dname, causal)
        rec["bound_ms"] = max(rec["bytes_ms"], rec["ops_ms"])
        cases.append(rec)
        print(f"[kernels] flash {name:15s} B{b} L{L} H{h} D{d} {dname} causal={int(causal)} "
              f"{route} O abs {err:.3g} LSE abs {lse_err:.3g} | kernel {rec['ms']:.4f} ms "
              f"plain {rec['plain_ms']:.4f} library {rec['library_ms']:.4f} "
              f"bound {rec['bound_ms']:.4f} ({'bytes' if rec['bytes_ms'] >= rec['ops_ms'] else 'ops'})")
        del qkv, q, k, v, o, lse
        torch.cuda.empty_cache()
    return cases


def attention_as_kernel(q, k, v, causal, bn: int = 128):
    """The wgmma kernel's arithmetic in plain PyTorch over [B, L, H, D]:
    fp32 scores in the log2 domain, a running row max per ``bn``-key tile,
    p = 2^(s·log2(e)/√D − m) rounded to bf16 before P·V while the row sum
    takes fp32 p, acc rescaled per tile, O = acc / max(l, 1e-30) in the
    input dtype.  Only the fp32 summation order differs from the kernel's."""
    import torch

    from fedml_tpu_torch.ops.flash_attention import NEG_INF

    lq, lk, d = q.shape[1], k.shape[1], q.shape[3]
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    c = math.log2(math.e) / math.sqrt(d)
    m = torch.full(qf.shape[:3] + (1,), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    qpos = torch.arange(lq, device=q.device)[:, None]
    for j in range(0, lk, bn):
        s = qf @ kf[:, :, j:j + bn].transpose(-1, -2)
        if causal:
            s = s.masked_fill(j + torch.arange(s.shape[-1], device=q.device) > qpos, NEG_INF)
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s * c - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, j:j + bn]
        m = mn
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


def phase_flash_check():
    """The flash-kernel transformer against the plain-attention one (same
    variables, fp32), and the op's gradients against autograd through the
    plain version."""
    import torch

    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.models.transformer import transformer_lm
    from fedml_tpu_torch.ops.flash_attention import (
        _flash_bwd, attention_plain, flash_attention_fwd, flash_attention_with_lse)

    kw = dict(vocab_size=8192, embed_dim=1280, num_heads=10, num_layers=2,
              seq_len=1024)
    kern = transformer_lm(**kw)
    plain = transformer_lm(**kw, attn_fn=lambda q, k, v, c: attention_plain(q, k, v, c)[0])
    variables = kern.init(PRNGKey(3))
    x = torch.randint(0, 8192, (2, 1024), generator=torch.Generator().manual_seed(4)).cuda()
    before = flash_attention_fwd.launches
    with torch.no_grad():
        lk, lp = kern.apply_eval(variables, x), plain.apply_eval(variables, x)
    err = (lk - lp).abs().max().item()
    print(f"[check] transformer (width 1280, 2 layers, L 1024) flash kernel vs plain "
          f"attention: logits max abs err {err:.3g}")
    if flash_attention_fwd.launches - before != 2:
        fail("the kernel transformer did not launch the flash kernel once per layer")
    if not torch.allclose(lk, lp, rtol=1e-3, atol=1e-3):
        fail("the flash-kernel transformer disagrees with the plain-attention one")
    # the same model in bf16, where attention takes the wgmma route, against
    # the kernel's arithmetic in plain PyTorch (p rounded to bf16 before P·V,
    # as the TPU kernel rounds it too); the same reference with one stale V
    # tile (keys 128-255 multiplied by keys 0-127's V: a ring stage read
    # before it was refilled) must fall outside the tolerance
    def stale_v_tile(q, k, v, c):
        v = v.clone()
        v[:, 128:256] = v[:, :128]
        return attention_as_kernel(q, k, v, c)

    as_kernel = transformer_lm(**kw, attn_fn=attention_as_kernel)
    faulty = transformer_lm(**kw, attn_fn=stale_v_tile)
    half = {"params": {n: t.to(torch.bfloat16) for n, t in variables["params"].items()}}
    before = flash_attention_fwd.wgmma_launches
    with torch.no_grad():
        lkh = kern.apply_eval(half, x).float()
        lrh, lfh, lph = (m.apply_eval(half, x).float() for m in (as_kernel, faulty, plain))
    err, fault_err, p_err = ((a - lrh).abs().max().item() for a in (lkh, lfh, lph))
    top = lrh.abs().max().item()
    limit = BF16_LOGITS_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
    print(f"[check] transformer bf16 logits (max |logit| {top:.4g}) max abs err: flash "
          f"kernel (wgmma) vs its arithmetic in plain PyTorch {err:.4g} (limit {limit:.4g}, "
          f"{BF16_LOGITS_ULPS} bf16 spacings); a stale V tile {fault_err:.4g}; plain "
          f"attention (fp32 p) {p_err:.4g}; flash kernel vs plain attention "
          f"{(lkh - lph).abs().max().item():.4g}")
    if flash_attention_fwd.wgmma_launches - before != 2:
        fail("the bf16 transformer did not take the wgmma route once per layer")
    if not err <= limit:
        fail("the bf16 flash-kernel transformer disagrees with the kernel's arithmetic")
    if not fault_err > limit:
        fail("the bf16 transformer check cannot tell a stale V tile from the kernel")

    g = torch.Generator().manual_seed(5)
    q, k, v, cot = (torch.randn(2, 1024, 10, 128, generator=g).cuda() for _ in range(4))
    w = torch.randn(2, 10, 1024, generator=g).cuda()
    for causal in (True, False):
        def grads(fn):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o, lse = fn(*leaves)
            return torch.autograd.grad((o * cot).sum() + (lse * w).sum(), leaves)

        got = grads(lambda a, b, c: flash_attention_with_lse(a, b, c, causal, 1024, 1024))
        want = grads(lambda a, b, c: attention_plain(a, b, c, causal))
        errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
        print(f"[check] flash dq/dk/dv vs autograd through plain (B2 L1024 H10 D128 fp32, "
              f"causal={int(causal)}, loss uses O and LSE): max abs err "
              + " ".join(f"{e:.3g}" for e in errs))
        if not all(torch.allclose(a, b, rtol=1e-3, atol=1e-3) for a, b in zip(got, want)):
            fail("flash backward disagrees with autograd through the plain version")
        # bf16: the wgmma forward's O and LSE through the backward, against
        # the same backward fed the plain version's O and LSE
        qb, kb, vb, cotb = (t.to(torch.bfloat16) for t in (q, k, v, cot))
        before = flash_attention_fwd.wgmma_launches
        leaves = [t.clone().requires_grad_(True) for t in (qb, kb, vb)]
        o, lse = flash_attention_with_lse(*leaves, causal, 1024, 1024)
        got = torch.autograd.grad((o * cotb).sum() + (lse * w).sum(), leaves)
        ro, rlse = attention_plain(qb, kb, vb, causal)
        want = _flash_bwd(qb, kb, vb, ro, rlse, cotb, w, causal, 1024)
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
        print(f"[check] flash dq/dk/dv from the wgmma forward vs the plain forward (bf16, "
              f"causal={int(causal)}): max abs err " + " ".join(f"{e:.3g}" for e in errs))
        if flash_attention_fwd.wgmma_launches - before != 1:
            fail("the bf16 flash op did not take the wgmma route")
        if not all(torch.allclose(a.float(), b.float(), rtol=TOL["bf16"], atol=TOL["bf16"])
                   for a, b in zip(got, want)):
            fail("the backward of the wgmma forward disagrees with that of the plain one")


def reset_launches():
    from fedml_tpu_torch.ops.conv_mxu import conv3x3_mxu
    from fedml_tpu_torch.ops.flash_attention import flash_attention_fwd

    conv3x3_mxu.launches = 0
    conv3x3_mxu.tc_launches = 0
    flash_attention_fwd.launches = 0
    flash_attention_fwd.wgmma_launches = 0


def read_launches() -> dict:
    from fedml_tpu_torch.ops.conv_mxu import conv3x3_mxu
    from fedml_tpu_torch.ops.flash_attention import flash_attention_fwd

    return {"conv3x3_mxu": conv3x3_mxu.launches,
            "conv3x3_mxu_tc": conv3x3_mxu.tc_launches,
            "flash_attention_fwd": flash_attention_fwd.launches,
            "flash_attention_fwd_wgmma": flash_attention_fwd.wgmma_launches}


def profile_round(fn, state, args):
    """One round under ``torch.profiler``: wall time, the device time of
    every CUDA kernel, the device's idle share, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = fn(state, *args)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    own = {}  # this repo's kernels, by kernel name prefix
    for e in kernels:
        for name in ("conv3x3_tc_kernel", "conv3x3_kernel", "moments_reduce_kernel",
                     "flash_fwd"):
            if name in e.key:
                own[name] = own.get(name, 0.0) + e.self_device_time_total / 1e3
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms, "own_kernels_ms": own,
           "kernel_launches": sum(e.count for e in kernels),
           "top_kernels": [{"name": e.key[:120], "count": e.count,
                            "device_ms": e.self_device_time_total / 1e3}
                           for e in top]}
    print(f"[profile] one round: wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, idle share {rec['device_idle_share']:.3f}, "
          f"{rec['kernel_launches']} kernel launches; this repo's kernels (ms): {own}")
    for t in rec["top_kernels"]:
        print(f"[profile]   {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['name']}")
    return rec


def phase_main(profile: bool):
    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.fedavg import (
        FedAvgConfig, FedAvgSimulation, ServerState, make_multi_round_fn)
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.core.types import device_resident_pack
    from fedml_tpu_torch.data.cifar import load_cifar10
    from fedml_tpu_torch.experiments.registry import shrink_dataset
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

    clients, steps, rounds, batch = 4, 4, 2, 64
    ds = load_cifar10(num_clients=clients, partition="hetero",
                      partition_alpha=0.5, seed=0)
    bundle = resnet56_tpu(conv_variant="kernel")
    opt = make_client_optimizer("sgd", 0.001, momentum=0.9, weight_decay=1e-3)
    lu = make_local_update(bundle, opt, epochs=1, compute_dtype=torch.bfloat16)
    ids = np.arange(clients)
    (x, y, m, ns), _ = device_resident_pack(
        ds, ids, batch, steps_per_epoch=steps, seed=0, device=torch.device("cuda"))
    part = torch.ones(clients, device="cuda")
    state = ServerState(bundle.init(PRNGKey(0)), (), 0, PRNGKey(0))
    before = {k: v.clone() for k, v in state.variables["params"].items()}
    fused = make_multi_round_fn(lu, rounds)
    state, _ = make_multi_round_fn(lu, 1)(state, x, y, m, ns, part, ids)  # warm-up
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    state, metrics = fused(state, x, y, m, ns, part, ids)
    loss = metrics["loss_sum"].cpu().numpy() / metrics["count"].cpu().numpy()
    secs = time.perf_counter() - t0
    seen1 = read_launches()
    run1, tc1 = seen1["conv3x3_mxu"], seen1["conv3x3_mxu_tc"]
    fwd1 = clients * steps * rounds
    changed = max((state.variables["params"][k] - before[k]).abs().max().item()
                  for k in before)
    sps = clients * steps * batch * rounds / secs
    print(f"[main] make_multi_round_fn: {rounds} rounds x {clients} clients x {steps} "
          f"steps x {batch}: {secs:.3f} s, {sps:.1f} samples/s, loss per round "
          f"{loss.tolist()}, max |param change| {changed:.3g}, "
          f"conv3x3_mxu launches {run1} ({tc1} tensor-core) for {fwd1} forwards")
    if not np.all(np.isfinite(loss)):
        fail(f"non-finite training loss {loss}")
    if not changed > 0:
        fail("the model did not change")
    if run1 != 19 * fwd1:
        fail(f"conv3x3_mxu launched {run1} times, expected {19 * fwd1}")
    if tc1 != TC_PER_FORWARD * fwd1:
        fail(f"conv3x3_mxu took the tensor-core route {tc1} times, "
             f"expected {TC_PER_FORWARD * fwd1}")
    prof = (profile_round(make_multi_round_fn(lu, 1), state,
                          (x, y, m, ns, part, ids)) if profile else None)

    cfg = FedAvgConfig(num_clients=clients, clients_per_round=clients,
                       comm_rounds=1, epochs=1, batch_size=batch, lr=0.001,
                       momentum=0.9, weight_decay=1e-3, frequency_of_the_test=1,
                       seed=0, compute_dtype="bf16")
    # each client's shard cut to `steps` steps (from 23, to make room for [mesh])
    sim_ds = shrink_dataset(ds, steps * batch, 0)
    sim = FedAvgSimulation(bundle, sim_ds, cfg)
    reset_launches()
    t0 = time.perf_counter()
    row = sim.run(1)[-1]
    secs2 = time.perf_counter() - t0
    seen2 = read_launches()
    run2, tc2 = seen2["conv3x3_mxu"], seen2["conv3x3_mxu_tc"]
    eval_steps = math.ceil(ds.test_data_num / max(batch, 64))
    train2 = clients * sim.steps_per_epoch
    fwd2 = train2 + eval_steps
    print(f"[main] FedAvgSimulation.run: 1 round, {clients} clients x "
          f"{sim.steps_per_epoch} steps + eval {eval_steps} batches: {secs2:.3f} s; "
          f"train_loss {row['train_loss']:.4f} test_acc {row['test_acc']:.4f} "
          f"test_loss {row['test_loss']:.4f}; conv3x3_mxu launches {run2} "
          f"({tc2} tensor-core) for {fwd2} forwards")
    if not (math.isfinite(row["train_loss"]) and math.isfinite(row["test_loss"])):
        fail(f"non-finite simulation metrics {row}")
    if run2 != 19 * fwd2:
        fail(f"conv3x3_mxu launched {run2} times, expected {19 * fwd2}")
    if tc2 != TC_PER_FORWARD * train2:
        fail(f"conv3x3_mxu took the tensor-core route {tc2} times, "
             f"expected {TC_PER_FORWARD * train2}")
    if seen1["flash_attention_fwd"] or seen2["flash_attention_fwd"]:
        fail("the ResNet-56 path launched the flash kernel")
    return {"launches": run1 + run2, "tc_launches": tc1 + tc2, "samples_per_s": sps,
            "multi_round_s": secs, "simulation_round_s": secs2, "profile": prof}


def phase_fedllm(profile: bool):
    import tempfile

    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.fedavg import make_multi_round_fn
    from fedml_tpu_torch.bench import build_fedllm
    from fedml_tpu_torch.core.types import cohort_steps_per_epoch
    from fedml_tpu_torch.experiments import run
    from fedml_tpu_torch.experiments.registry import load_data

    clients, steps, rounds = 4, 4, 2
    t0 = time.perf_counter()
    warm, state, args, tokens_per_round, flops_per_token = build_fedllm(
        clients=clients, steps=steps, rounds_per_call=1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    before = {k: v.clone() for k, v in state.variables["params"].items()}
    state, _ = warm(state, *args)  # warm-up round
    torch.cuda.synchronize()
    fused = make_multi_round_fn(None, rounds, round_fn=warm, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    state, metrics = fused(state, *args)
    loss = (metrics["loss_sum"] / metrics["count"]).cpu().numpy().ravel()
    secs = time.perf_counter() - t0
    seen = read_launches()
    fwd = clients * steps * rounds
    changed = max((state.variables["params"][k] - before[k]).abs().max().item()
                  for k in before)
    del before
    tokens = tokens_per_round * rounds
    rec = {"setup_s": setup_s, "rounds_s": secs, "tokens": tokens,
           "tokens_per_s": tokens / secs,
           "model_tflops": tokens * flops_per_token / secs / 1e12,
           "flops_per_token": flops_per_token, "loss": loss.tolist(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": seen}
    print(f"[fedllm] build_fedllm (width 1280, 12 layers, 10 heads, L 1024, vocab 8192, "
          f"bf16): setup {setup_s:.2f} s; {rounds} rounds x {clients} clients x {steps} "
          f"steps x batch 8: {secs:.3f} s, {rec['tokens_per_s']:.1f} tokens/s, model "
          f"TFLOP/s {rec['model_tflops']:.2f}, loss per round {rec['loss']}, max |param "
          f"change| {changed:.3g}, peak memory {rec['peak_mem_gb']:.2f} GB, launches {seen} "
          f"for {fwd} forwards")
    if not np.all(np.isfinite(loss)):
        fail(f"non-finite fedllm training loss {loss}")
    if not changed > 0:
        fail("the transformer did not change")
    if seen["flash_attention_fwd"] != BENCH_LAYERS * fwd:
        fail(f"flash_attention_fwd launched {seen['flash_attention_fwd']} times, "
             f"expected {BENCH_LAYERS * fwd}")
    if seen["flash_attention_fwd_wgmma"] != BENCH_LAYERS * fwd:
        fail(f"flash_attention_fwd took the wgmma route "
             f"{seen['flash_attention_fwd_wgmma']} times, expected {BENCH_LAYERS * fwd}")
    if seen["conv3x3_mxu"]:
        fail("the fedllm path launched the conv kernel")
    rec["profile"] = profile_round(warm, state, args) if profile else None
    del state, warm, fused, args
    torch.cuda.empty_cache()

    # experiments/run.py at its fedllm defaults: the expected launches follow
    # from its data (train forwards of the sampled clients + eval batches)
    cfg = run.ExperimentConfig(algorithm="fedllm", dataset="fed_shakespeare")
    ds = load_data(cfg.dataset, cfg.data_dir, cfg.client_num_in_total,
                   cfg.partition_method, cfg.partition_alpha, cfg.seed)
    fwd2 = (cfg.client_num_per_round * cfg.epochs
            * cohort_steps_per_epoch(ds, cfg.batch_size)
            + math.ceil(ds.test_data_num / max(cfg.batch_size, 64)))
    with tempfile.TemporaryDirectory() as run_dir:
        reset_launches()
        t0 = time.perf_counter()
        out = run.main(["--algorithm", "fedllm", "--dataset", "fed_shakespeare",
                        "--comm_round", "1", "--run_dir", run_dir])
        secs2 = time.perf_counter() - t0
        seen2 = read_launches()
    final = out["final"]
    print(f"[fedllm] experiments.run.main fedllm (width {cfg.embed_dim}, {cfg.num_layers} "
          f"layers, {cfg.num_heads} heads, L {ds.train_x.shape[1]}): 1 round {secs2:.3f} s; "
          f"train_loss {final['train_loss']:.4f} test_loss {final['test_loss']:.4f}; "
          f"launches {seen2} for {fwd2} forwards")
    if not (math.isfinite(final["train_loss"]) and math.isfinite(final["test_loss"])):
        fail(f"non-finite run.main fedllm metrics {final}")
    if seen2["flash_attention_fwd"] != cfg.num_layers * fwd2:
        fail(f"run.main launched flash {seen2['flash_attention_fwd']} times, "
             f"expected {cfg.num_layers * fwd2}")
    rec.update(run_main_s=secs2, run_main_launches=seen2)
    rec["flash_launches"] = seen["flash_attention_fwd"] + seen2["flash_attention_fwd"]
    rec["flash_wgmma_launches"] = (seen["flash_attention_fwd_wgmma"]
                                   + seen2["flash_attention_fwd_wgmma"])
    return rec


def phase_rng():
    """RNG_CASES on the card against the CPU and the known answers."""
    import os

    import torch

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), RNG_ANSWERS)) as f:
        answers = json.load(f)["answers"]
    recs = []
    for name, draw, seed, kw in RNG_CASES:
        t0 = time.perf_counter()
        got = rng_case(draw, seed, kw, torch.device("cuda"))
        card_ms = 1e3 * (time.perf_counter() - t0)
        cpu = rng_case(draw, seed, kw, "cpu")
        same_cpu = got.dtype == cpu.dtype and got.tobytes() == cpu.tobytes()
        same_jax = answer_of(got) == answers[name]
        print(f"[rng] {name:22s} {draw:13s} {got.dtype} {tuple(got.shape)}: card == cpu "
              f"{same_cpu}, == jax 0.9.0 known answer {same_jax} ({card_ms:.2f} ms incl. copy)")
        if not (same_cpu and same_jax):
            fail(f"rng case {name}: the card's draw is not the CPU's and jax's bits")
        recs.append({"case": name, "draw": draw, "card_ms": card_ms})
    return recs


def phase_north_star(profile: bool):
    """build_north_star at its own cut but NORTH_STAR_STEPS steps a client:
    a warm-up round of one client (the same steps), then one timed round of
    the whole cohort."""
    import numpy as np
    import torch

    from fedml_tpu_torch.bench import build_north_star

    clients, steps, batch = 10, NORTH_STAR_STEPS, 64
    t0 = time.perf_counter()
    round_fn, state, args, samples = build_north_star(
        clients=clients, steps=steps, batch=batch, rounds_per_call=1,
        conv_variant="kernel")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # warm-up round: one client of the cohort, the same 24 steps
    state, m = round_fn(state, *(a[:1] for a in args))
    float(m["loss_sum"].sum())
    warm_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    state, m = round_fn(state, *args)
    loss = (m["loss_sum"] / m["count"]).cpu().numpy()
    secs = time.perf_counter() - t0
    seen = read_launches()
    fwd = clients * steps
    sps = samples / secs
    rec = {"setup_s": setup_s, "warmup_round_s": warm_s, "round_s": secs,
           "samples_per_s": sps, "step_ms": 1e3 * secs / fwd, "loss": loss.tolist(),
           "launches": seen["conv3x3_mxu"], "tc_launches": seen["conv3x3_mxu_tc"],
           "forwards": fwd}
    print(f"[north_star] build_north_star(conv_variant='kernel'): {clients} clients x "
          f"{steps} steps x batch {batch}, bf16: setup {setup_s:.2f} s, one-client warm-up round "
          f"{warm_s:.3f} s, timed round {secs:.3f} s = {sps:.1f} samples/s "
          f"({rec['step_ms']:.2f} ms per step), loss {loss.tolist()}, conv3x3_mxu "
          f"launches {seen['conv3x3_mxu']} ({seen['conv3x3_mxu_tc']} tensor-core) for "
          f"{fwd} forwards")
    if not np.all(np.isfinite(loss)):
        fail(f"non-finite north-star loss {loss}")
    if seen["conv3x3_mxu"] != 19 * fwd or seen["conv3x3_mxu_tc"] != TC_PER_FORWARD * fwd:
        fail(f"north star: conv launches {seen}, expected {19 * fwd} "
             f"({TC_PER_FORWARD * fwd} tensor-core)")
    if seen["flash_attention_fwd"]:
        fail("the north-star path launched the flash kernel")
    rec["profile"] = profile_round(round_fn, state, args) if profile else None
    del state, args, round_fn
    torch.cuda.empty_cache()
    return rec


def phase_sim(step_ms: Optional[float] = None):
    """FedAvgSimulation with augmentation, sampled cohorts and dropout:
    run(), crash + resume, and run_fused_sampled, bit for bit.  ``step_ms``
    is the north star's step time, which the augment and threefry costs
    per client-epoch are printed beside."""
    import tempfile

    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.fedavg import (
        FedAvgConfig, FedAvgSimulation, InjectedCrash)
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.core.checkpoint import CheckpointManager
    from fedml_tpu_torch.data.augment import cifar_augment
    from fedml_tpu_torch.data.cifar import load_cifar10
    from fedml_tpu_torch.experiments import run
    from fedml_tpu_torch.experiments.registry import shrink_dataset
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    ds = shrink_dataset(load_cifar10(num_clients=8, partition="hetero",
                                     partition_alpha=0.5, seed=0), 128, 256)
    cfg = FedAvgConfig(num_clients=8, clients_per_round=4, comm_rounds=3, epochs=1,
                       batch_size=64, lr=0.001, momentum=0.9, weight_decay=1e-3,
                       frequency_of_the_test=1, seed=0, compute_dtype="bf16",
                       drop_prob=0.25)

    def sim():
        return FedAvgSimulation(resnet56_tpu(conv_variant="kernel"), ds, cfg,
                                augment_fn=cifar_augment())

    a = sim()
    reset_launches()
    t0 = time.perf_counter()
    hist = a.run()
    run_s = time.perf_counter() - t0
    seen = read_launches()
    train_fwd = cfg.comm_rounds * cfg.clients_per_round * a.steps_per_epoch
    eval_fwd = cfg.comm_rounds * math.ceil(len(ds.test_y) / 64)
    with tempfile.TemporaryDirectory() as ck:
        b = sim()
        b.attach_checkpointing(CheckpointManager(ck), every=1)
        b.crash_at_round = 2
        try:
            b.run()
            fail("the scheduled crash did not happen")
        except InjectedCrash as crash:
            crashed_at = crash.round_idx
        saved = sorted(os.listdir(ck))
        b = sim()
        b.attach_checkpointing(CheckpointManager(ck), every=1)
        resumed_from = b.resume()
        b.run(cfg.comm_rounds - resumed_from)
    c = sim()
    c.run_fused_sampled(rounds_per_call=2)

    def max_diff(x, y):
        return max((x.state.variables[col][k].float() - y.state.variables[col][k].float())
                   .abs().max().item()
                   for col in x.state.variables for k in x.state.variables[col])

    diff_resume, diff_fused = max_diff(a, b), max_diff(a, c)
    participants = [r["participants"] for r in hist]
    # per client-epoch at the north star's cut (24 steps x 64 images): the
    # epoch's augmentation, and its threefry draws (the shuffle permutation,
    # the augment key and 24 step keys)
    n = 24 * 64
    x = torch.randn(n, 32, 32, 3, generator=torch.Generator().manual_seed(0)).cuda()
    aug = cifar_augment()
    key = rng.PRNGKey(0)

    def host_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / reps

    def draws():
        ek = rng.fold_in(key, 0)
        rng.permutation(rng.fold_in(ek, 0), n, x.device)
        rng.fold_in(ek, n + 1)
        for i in range(24):
            rng.fold_in(ek, i + 1)

    rec = {"run_s": run_s, "participants": participants,
           "final_test_acc": hist[-1]["test_acc"], "crashed_at": crashed_at,
           "checkpoints_at_crash": saved, "resumed_from": resumed_from,
           "max_abs_diff_resume": diff_resume, "max_abs_diff_fused_sampled": diff_fused,
           "launches": seen["conv3x3_mxu"], "tc_launches": seen["conv3x3_mxu_tc"],
           "augment_ms_per_client_epoch": host_ms(lambda: aug(key, x)),
           "threefry_ms_per_client_epoch": host_ms(draws)}
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    print(f"[sim] FedAvgSimulation resnet56_tpu bf16 + cifar_augment, 8 clients (4 per "
          f"round, drop_prob 0.25), {a.steps_per_epoch} steps per client, 3 rounds: run() "
          f"{run_s:.3f} s, participants {participants}, test_acc {hist[-1]['test_acc']:.4f}; "
          f"conv3x3_mxu launches {seen['conv3x3_mxu']} ({seen['conv3x3_mxu_tc']} "
          f"tensor-core) for {train_fwd} train + {eval_fwd} eval forwards")
    print(f"[sim] crash before round {crashed_at} with {saved} on disk, resume() from "
          f"round {resumed_from}: max |variable - run()| {diff_resume:.3g}; "
          f"run_fused_sampled: max |variable - run()| {diff_fused:.3g}")
    print(f"[sim] per client-epoch of 24 x 64 images (host clock, synced): augment "
          f"{rec['augment_ms_per_client_epoch']:.3f} ms, threefry draws "
          f"{rec['threefry_ms_per_client_epoch']:.3f} ms")
    if step_ms is not None:
        epoch_ms = 24 * step_ms
        print(f"[sim] beside 24 north-star steps of {step_ms:.2f} ms = {epoch_ms:.1f} ms: "
              f"augment {100 * rec['augment_ms_per_client_epoch'] / epoch_ms:.2f}%, "
              f"threefry {100 * rec['threefry_ms_per_client_epoch'] / epoch_ms:.2f}%")
    if seen["conv3x3_mxu"] != 19 * (train_fwd + eval_fwd) or \
            seen["conv3x3_mxu_tc"] != TC_PER_FORWARD * train_fwd:
        fail(f"sim: conv launches {seen}, expected {19 * (train_fwd + eval_fwd)} "
             f"({TC_PER_FORWARD * train_fwd} tensor-core)")
    if min(participants) >= cfg.clients_per_round:
        fail("sim: dropout took no client out; the phase does not test it")
    if not (crashed_at == 2 and resumed_from == 2):
        fail(f"sim: crashed at {crashed_at}, resumed from {resumed_from}")
    if diff_resume != 0.0 or diff_fused != 0.0:
        fail("sim: crash + resume or run_fused_sampled is not bit-identical to run()")

    # the experiment entry point with augmentation on and checkpointing
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        t0 = time.perf_counter()
        out = run.main(["--algorithm", "fedavg", "--dataset", "cifar10", "--ci", "1",
                        "--checkpoint_every", "1", "--checkpoint_dir",
                        os.path.join(tmp, "ck"), "--run_dir", os.path.join(tmp, "run")])
        secs = time.perf_counter() - t0
        ckpts = sorted(os.listdir(os.path.join(tmp, "ck")))
    final = out["final"]
    print(f"[sim] experiments.run.main fedavg cifar10 --ci 1 --checkpoint_every 1 "
          f"(augmentation on): {len(out['history'])} rounds {secs:.3f} s, train_loss "
          f"{final['train_loss']:.4f} test_acc {final['test_acc']:.4f}, checkpoints {ckpts}")
    if not (math.isfinite(final["train_loss"]) and ckpts == ["ckpt_1.npz", "ckpt_2.npz"]):
        fail(f"run.main fedavg: {final}, checkpoints {ckpts}")
    rec.update(run_main_s=secs, run_main_checkpoints=ckpts)
    return rec


def _zoo_bundle(dataset, model, classes, shape, device):
    from fedml_tpu_torch.experiments.registry import create_model

    return create_model(model, dataset, classes, input_shape=shape, device=device)


def _zoo_round_data(dataset, batch, classes, shape, tokens, seed=0):
    """A 2 clients x 2 steps block of the pair's geometry from a numpy seed:
    token ids, pixels or bags of words; labels, next tokens or multi-hot tags."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lead = (2, 2, batch)
    if tokens:
        x = rng.randint(0, classes, (*lead, *shape)).astype(np.int32)
    else:
        x = rng.standard_normal((*lead, *shape)).astype(np.float32)
    if dataset == "stackoverflow_lr":
        y = (rng.rand(*lead, classes) < 0.01).astype(np.float32)
    elif dataset in ("fed_shakespeare", "stackoverflow_nwp"):
        y = rng.randint(0, classes, (*lead, *shape)).astype(np.int32)
    else:
        y = rng.randint(0, classes, lead).astype(np.int32)
    mask = np.ones(lead, np.float32)
    mask[1, 1, batch // 2:] = 0.0
    return x, y, mask, mask.sum((1, 2)), np.ones(2, np.float32), np.arange(2)


def _zoo_round(dataset, model, batch, lr, classes, shape, tokens, device,
               float64=False):
    """One make_round_fn round of 2 clients x 2 steps on ``device`` from
    PRNGKey(0)'s init (cast to float64 with the float inputs, the losses
    staying float32 as in JAX, with ``float64``); returns the variables,
    the metrics, the round function, its state and arguments."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import ServerState, make_round_fn
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.experiments.registry import task_loss_for_dataset

    bundle = _zoo_bundle(dataset, model, classes, shape, device)
    lu = make_local_update(bundle, make_client_optimizer("sgd", lr), 1,
                           task_loss_for_dataset(dataset))
    round_fn = make_round_fn(lu, device=device)
    data = _zoo_round_data(dataset, batch, classes, shape, tokens)
    args = tuple(torch.from_numpy(a).to(device) for a in data[:5]) + (data[5],)
    variables = bundle.init(PRNGKey(0))
    if float64:
        variables = {c: {k: v.double() for k, v in d.items()} for c, d in variables.items()}
        if args[0].is_floating_point():
            args = (args[0].double(), *args[1:])
    state = ServerState(variables, (), 0, PRNGKey(1))
    new, metrics = round_fn(state, *args)
    return new.variables, metrics, round_fn, state, args


def _zoo_round_specs() -> list:
    """One (dataset, model, batch, lr, classes, shape, tokens) per zoo model
    (the LSTMs and the lrs once per dataset)."""
    models = {}
    for dataset, model, batch, lr, cap, tokens, classes, shape in ZOO:
        key = (model, dataset if model in ("rnn", "lr") else "")
        models.setdefault(key, (dataset, model, batch, lr, classes, shape, tokens))
    return list(models.values())


def _zoo_cpu_rounds(out_path: str) -> None:
    """The CPU's side of [zoo]'s card-against-CPU rounds, in a process of its
    own beside the card's work (``_start_zoo_cpu_rounds``): each model's
    fp32 and float64 round, saved to ``out_path``."""
    import torch

    os.nice(10)  # behind the card's host thread, whose times the phase prints
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    out = {}
    for spec in _zoo_round_specs():
        host, hm, *_ = _zoo_round(*spec, "cpu")
        ref = _zoo_round(*spec, "cpu", float64=True)[0]
        out[spec[:2]] = {"host": host, "ref": ref, "loss_sum": float(hm["loss_sum"])}
    torch.save(out, out_path)


def _start_zoo_cpu_rounds(tmp: str):
    """``_zoo_cpu_rounds`` in a new Python process; returns (the process,
    its output path)."""
    out_path = os.path.join(tmp, "zoo_cpu.pt")
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
            f"chip_smoke._zoo_cpu_rounds({out_path!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=here), out_path


def phase_zoo(profile: bool, device: str = "cuda"):
    """The cross-device zoo: every (dataset, model) pair of ZOO through
    ``experiments/run.py::run_experiment`` at full width on the default
    device (the card), ZOO_ROUNDS rounds of ZOO_PER_ROUND sampled clients
    (the first a warm-up); then per model one make_round_fn round on the
    card in fp32 (TF32 off) held within ZOO_ROUND_RTOL of the same round on
    the CPU in float64, and the dropout masks card == CPU bit for bit.  No zoo
    path may launch the conv or flash kernel.  ``device`` "cpu" rehearses
    the phase without a card (both sides then run on the CPU); the CPU's
    rounds run in a process of their own beside the pairs."""
    import tempfile

    import torch

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    with tempfile.TemporaryDirectory() as tmp:
        proc, out_path = _start_zoo_cpu_rounds(tmp)  # beside the pairs
        try:
            return _zoo_phase(profile, device, sync, (proc, out_path))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _zoo_phase(profile, device, sync, cpu_rounds):
    """phase_zoo's body; ``cpu_rounds`` is ``_start_zoo_cpu_rounds``'s
    process and output path."""
    import statistics

    import torch

    from fedml_tpu_torch.core import rng as rnglib
    from fedml_tpu_torch.experiments import run
    from fedml_tpu_torch.models.base import Dropout

    rec = {}
    reset_launches()
    for dataset, model, batch, lr, cap, tokens, classes, shape in ZOO:
        cfg = run.ExperimentConfig(
            algorithm="fedavg", dataset=dataset, model=model, batch_size=batch, lr=lr,
            wd=0.0, client_num_in_total=ZOO_CLIENTS, client_num_per_round=ZOO_PER_ROUND,
            comm_round=ZOO_ROUNDS, frequency_of_the_test=ZOO_ROUNDS,
            max_samples_per_client=cap, max_test_samples=ZOO_TEST,
            device="" if device == "cuda" else device)
        t0 = time.perf_counter()
        out = run.run_experiment(cfg, log_fn=None)
        sync()
        secs = time.perf_counter() - t0
        hist = out["history"]
        final = hist[-1]
        round_ms = statistics.median(1e3 * r["time_round"] for r in hist[1:])
        # a per-position task counts tokens, a per-sequence one samples
        per_token = dataset in ("fed_shakespeare", "stackoverflow_nwp")
        samples = statistics.median(r["count"] / (tokens if per_token else 1)
                                    for r in hist[1:])
        params = sum(p.numel() for p in
                     _zoo_bundle(dataset, model, classes, shape, "meta").module.parameters())
        tag = f"{dataset}+{model}"
        r = {"params": params, "round_ms": round_ms, "samples_per_round": samples,
             "samples_per_s": 1e3 * samples / round_ms, "run_s": secs,
             "final": {k: v for k, v in final.items() if k.startswith(("test_", "train_"))}}
        if tokens:
            r["tokens_per_s"] = r["samples_per_s"] * tokens
        finite = all(math.isfinite(v) for v in r["final"].values())
        extra = (f", {r['tokens_per_s']:.1f} tokens/s" if tokens else "")
        pr = (f" precision {final['test_precision']:.4f} recall {final['test_recall']:.4f}"
              if "test_precision" in final else "")
        print(f"[zoo] {tag}: {params} params, {len(hist)} rounds x {cfg.client_num_per_round} "
              f"clients (batch {batch}, sgd lr {lr:g}, <= {cap} samples each) in {secs:.2f} s; "
              f"median round {round_ms:.1f} ms after a warm-up, {r['samples_per_s']:.1f} "
              f"samples/s{extra}; train_loss {final['train_loss']:.4f} test_loss "
              f"{final['test_loss']:.4f} test_acc {final['test_acc']:.4f}{pr}; finite {finite}")
        if not finite or final["test_count"] <= 0:
            fail(f"zoo {tag}: {final}")
        if dataset == "stackoverflow_lr" and "test_precision" not in final:
            fail("zoo stackoverflow_lr: no precision/recall in the evaluation record")
        rec[tag] = r
    seen = read_launches()
    if any(seen.values()):
        fail(f"a zoo path launched a kernel of the JAX package's Pallas paths: {seen}")

    # the card against the CPU, one round per model, one seed: the card in
    # fp32 is held to the CPU's float64 round, which the CPU's own fp32
    # round can miss by more than the card does (resnet18_gn at lr 0.1: the
    # CPU's fp32 round ends 2.2e-3 of a leaf's largest magnitude from
    # float64 on near-zero GroupNorm biases, the card's 7.9e-5; PERF.md)
    def rel_diff(a, b):
        gaps = [leaf_gap(a[coll], b[coll]) for coll in b]
        return max(g[0] for g in gaps), max(g[2] for g in gaps)

    cards = {}
    for spec in _zoo_round_specs():
        card, cm, round_fn, state, args = _zoo_round(*spec, device)
        cards[spec[:2]] = ({c: {k: v.cpu() for k, v in d.items()} for c, d in card.items()},
                           float(cm["loss_sum"]))
        if profile and device == "cuda":
            prof = profile_round(round_fn, state, args)
            prof["launches_per_step"] = prof["kernel_launches"] / 4
            if spec[6]:
                prof["launches_per_timestep"] = prof["launches_per_step"] / spec[6]
            print(f"[zoo] {spec[1]}/{spec[0]}: {prof['launches_per_step']:.0f} kernel "
                  "launches per training step (a 2 x 2 round's launches / 4, aggregation "
                  "included)" + (f", {prof['launches_per_timestep']:.1f} per timestep"
                                 if spec[6] else ""))
            rec[f"profile {spec[1]}/{spec[0]}"] = prof
        del card, state, args, round_fn
    proc, out_path = cpu_rounds
    t0 = time.perf_counter()
    if proc.wait() != 0:
        fail(f"zoo: the CPU's reference rounds exited {proc.returncode}")
    print(f"[zoo] waited {time.perf_counter() - t0:.1f} s for the CPU's rounds")
    cpu = torch.load(out_path)
    for dataset, model, *_ in _zoo_round_specs():
        card, loss_c = cards.pop((dataset, model))
        c = cpu.pop((dataset, model))
        host, ref, loss_h = c["host"], c["ref"], c["loss_sum"]
        worst, worst_abs = rel_diff(card, ref)
        host_ref, _ = rel_diff(host, ref)
        card_host, card_host_abs = rel_diff(card, host)
        tag = f"{model}/{dataset}"
        print(f"[zoo] {tag}: one round of 2 clients x 2 steps (fp32, TF32 off): card vs "
              f"cpu float64 max |Δ| {worst_abs:.3g}, / max |leaf| {worst:.3g}; card vs cpu "
              f"fp32 max |Δ| {card_host_abs:.3g}, / max |leaf| {card_host:.3g}; cpu fp32 "
              f"vs float64 / max |leaf| {host_ref:.3g}; loss_sum {loss_c:.6f} vs {loss_h:.6f}")
        if not worst <= ZOO_ROUND_RTOL or not math.isfinite(loss_c):
            fail(f"zoo {tag}: the card's round is not the CPU's float64 one ({worst:.3g})")
        rec[f"round {tag}"] = {"card_vs_f64": worst, "card_vs_f64_abs": worst_abs,
                               "card_vs_cpu": card_host, "card_vs_cpu_abs": card_host_abs,
                               "cpu_vs_f64": host_ref, "loss_sum": [loss_c, loss_h],
                               **({"profile": rec.pop(f"profile {tag}")}
                                  if f"profile {tag}" in rec else {})}
        del card, host, ref
    # the CNN's dropout masks, card against CPU, bit for bit
    drop = Dropout(0.25)
    drop.state_prefix = "Dropout_0."  # CNNDropOut's first dropout scope
    x = torch.randn(20, 12, 12, 64, generator=torch.Generator().manual_seed(0)) + 3.0
    key = rnglib.fold_in(rnglib.PRNGKey(5), 1)
    a = drop(x.to(device), True, key).cpu()
    b = drop(x, True, key)
    same = torch.equal(a, b) and torch.equal(a == 0, b == 0)
    print(f"[zoo] dropout 0.25 over a [20, 12, 12, 64] activation: card == cpu bitwise "
          f"{same} (kept {(b != 0).float().mean().item():.4f})")
    if not same:
        fail("zoo: the card's dropout mask is not the CPU's")
    if device == "cuda":
        torch.cuda.empty_cache()
    return rec


def phase_init():
    """The seeded init (flax's model under PRNGKey(s)) drawn on the card
    against the same draw on the CPU, bit for bit: ResNet-56, a small
    transformer and the zoo's models (the LSTMs' orthogonal kernels
    included); and the cross-silo families' full-width inits drawn on the
    card against the digests of flax's (SILO_DIGESTS)."""
    import torch

    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu
    from fedml_tpu_torch.models.transformer import transformer_lm

    rec = {}
    # the zoo's models, each once (shakespeare's LSTM is fed_shakespeare's)
    zoo = [(f"{model}/{dataset}", functools.partial(_zoo_bundle, dataset, model, c, shp))
           for dataset, model, _, _, _, _, c, shp in ZOO
           if dataset not in ("shakespeare", "mnist")]
    for name, make in (
            ("resnet56_tpu", lambda dev: resnet56_tpu(device=dev)),
            ("transformer_w256_l2", lambda dev: transformer_lm(
                vocab_size=1024, embed_dim=256, num_heads=4, num_layers=2,
                seq_len=128, device=dev)), *zoo):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = make("cuda").init(PRNGKey(0))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = make("cpu").init(PRNGKey(0))
        host_s = time.perf_counter() - t0
        n = sum(v.numel() for col in host.values() for v in col.values())
        same = all(torch.equal(card[c][k].cpu(), v) for c in host for k, v in host[c].items())
        print(f"[init] {name}: {n} values, card {card_s:.3f} s, cpu {host_s:.3f} s, "
              f"card == cpu bitwise {same}")
        if not same:
            fail(f"init {name}: the card's draw is not the CPU's")
        rec[name] = {"values": n, "card_s": card_s, "cpu_s": host_s}
    # the cross-silo families at full width, drawn on the card only (VGG's
    # 134M values take minutes through the host's CPU): each leaf's sha256
    # against flax's init (tests/silo_init_digests.json)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), SILO_DIGESTS)) as f:
        digests = json.load(f)["models"]
    for model in SILO_FAMILIES:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = _silo_bundle(model, "cuda").init(PRNGKey(0))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        got = init_digests(card)
        n = sum(v.numel() for col in card.values() for v in col.values())
        same = got == digests[model]
        print(f"[init] {model}/cifar100: {n} values, card {card_s:.3f} s (peak "
              f"{peak_gib:.2f} GiB), == flax's init (sha256 per leaf, {len(got)} leaves) {same}")
        if not same:
            bad = sorted(k for k in digests[model] if got.get(k) != digests[model][k])
            fail(f"init {model}: the card's draw is not flax's init ({bad[:4]})")
        rec[model] = {"values": n, "card_s": card_s, "peak_gib": peak_gib}
        del card
        torch.cuda.empty_cache()
    return rec


def _host_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: CUDA kernels launched,
    and each host op's count and self CPU time (ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    ops = {e.key: (e.count, e.self_cpu_time_total / 1e3) for e in events
           if e.device_type == torch.autograd.DeviceType.CPU}
    return {"launches": sum(e.count for e in events
                            if e.device_type == torch.autograd.DeviceType.CUDA),
            "host_ms": sum(t for _, t in ops.values()), "ops": ops}


def _launches(fn) -> int:
    """The CUDA kernels one call of ``fn`` launches (``torch.profiler`` with
    the CUDA activity only: no host-op events to collect)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def _sync_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def phase_compress():
    """FedAvgSimulation over the kernel ResNet-56 with the int8 codec and
    error feedback, at [sim]'s cohort geometry: run(), crash + resume()
    and run_fused_sampled, bit for bit (variables and residuals); one
    round each of qsgd4, topk0.01 + EF and bf16; the qsgd8 payload on the
    card against the CPU's; the uplink bytes; the codec stage's time and
    launches per client and its share of a round."""
    import tempfile

    import numpy as np
    import torch

    from fedml_tpu_torch import compress
    from fedml_tpu_torch.algorithms.fedavg import (
        FedAvgConfig, FedAvgSimulation, InjectedCrash, ServerState, make_round_fn)
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.core.checkpoint import CheckpointManager
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.core.metrics import MetricsLogger
    from fedml_tpu_torch.core.tree import tree_map
    from fedml_tpu_torch.data.augment import cifar_augment
    from fedml_tpu_torch.data.cifar import load_cifar10
    from fedml_tpu_torch.experiments.registry import shrink_dataset
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu
    from fedml_tpu_torch.obs.telemetry import Telemetry

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    ds = shrink_dataset(load_cifar10(num_clients=8, partition="hetero",
                                     partition_alpha=0.5, seed=0), 128, 256)
    base = dict(num_clients=8, clients_per_round=4, comm_rounds=3, epochs=1,
                batch_size=64, lr=0.001, momentum=0.9, weight_decay=1e-3,
                frequency_of_the_test=1, seed=0, compute_dtype="bf16", drop_prob=0.25)

    def sim(codec="int8", ef=True, **kw):
        cfg = FedAvgConfig(**{**base, **kw}, compress_codec=codec, compress_ef=ef)
        return FedAvgSimulation(resnet56_tpu(conv_variant="kernel"), ds, cfg,
                                augment_fn=cifar_augment(),
                                metrics=MetricsLogger(telemetry=Telemetry()))

    a = sim()
    reset_launches()
    t0 = time.perf_counter()
    hist = a.run()
    run_s = time.perf_counter() - t0
    seen = read_launches()
    train_fwd = base["comm_rounds"] * base["clients_per_round"] * a.steps_per_epoch
    eval_fwd = base["comm_rounds"] * math.ceil(len(ds.test_y) / 64)
    with tempfile.TemporaryDirectory() as ck:
        b = sim()
        b.attach_checkpointing(CheckpointManager(ck), every=1)
        b.crash_at_round = 2
        try:
            b.run()
            fail("compress: the scheduled crash did not happen")
        except InjectedCrash as crash:
            crashed_at = crash.round_idx
        b = sim()
        b.attach_checkpointing(CheckpointManager(ck), every=1)
        resumed_from = b.resume()
        b.run(base["comm_rounds"] - resumed_from)
    c = sim()
    c.run_fused_sampled(rounds_per_call=2)

    def max_diff(x, y):
        pairs = [(x.state.variables, y.state.variables), (x.state.residuals, y.state.residuals)]
        return max((p[col][k].float() - q[col][k].float()).abs().max().item()
                   for p, q in pairs for col in p for k in p[col])

    diff_resume, diff_fused = max_diff(a, b), max_diff(a, c)
    res_norm = max(v.abs().max().item() for col in a.state.residuals.values()
                   for v in col.values())
    counters = a.metrics.telemetry.snapshot()["counters"]
    up = "{msg_type=C2S_SEND_MODEL}"
    raw, enc = counters["comm.raw_bytes" + up], counters["comm.compressed_bytes" + up]
    uploads = counters["comm.recv_msgs" + up]
    participants = [r["participants"] for r in hist]
    rec = {"run_s": run_s, "participants": participants, "crashed_at": crashed_at,
           "resumed_from": resumed_from, "max_abs_diff_resume": diff_resume,
           "max_abs_diff_fused_sampled": diff_fused, "max_abs_residual": res_norm,
           "launches": seen["conv3x3_mxu"], "tc_launches": seen["conv3x3_mxu_tc"],
           "uplink_bytes": {"fp32": raw / uploads, "int8": enc / uploads},
           "final_test_acc": hist[-1]["test_acc"]}
    print(f"[compress] FedAvgSimulation resnet56_tpu bf16 + cifar_augment, int8 + error "
          f"feedback, 8 clients (4 per round, drop_prob 0.25), {a.steps_per_epoch} steps "
          f"per client, 3 rounds: run() {run_s:.3f} s, participants {participants}, "
          f"test_acc {hist[-1]['test_acc']:.4f}, max |residual| {res_norm:.3g}; conv3x3_mxu "
          f"launches {seen['conv3x3_mxu']} ({seen['conv3x3_mxu_tc']} tensor-core) for "
          f"{train_fwd} train + {eval_fwd} eval forwards")
    print(f"[compress] crash before round {crashed_at}, resume() from round "
          f"{resumed_from}: max |variable or residual - run()| {diff_resume:.3g}; "
          f"run_fused_sampled: {diff_fused:.3g}")
    if seen["conv3x3_mxu"] != 19 * (train_fwd + eval_fwd) or \
            seen["conv3x3_mxu_tc"] != TC_PER_FORWARD * train_fwd:
        fail(f"compress: conv launches {seen}, expected {19 * (train_fwd + eval_fwd)} "
             f"({TC_PER_FORWARD * train_fwd} tensor-core)")
    if not (crashed_at == 2 and resumed_from == 2):
        fail(f"compress: crashed at {crashed_at}, resumed from {resumed_from}")
    if diff_resume != 0.0 or diff_fused != 0.0:
        fail("compress: crash + resume or run_fused_sampled is not bit-identical to run()")
    if not (res_norm > 0 and math.isfinite(hist[-1]["train_loss"])):
        fail(f"compress: residuals {res_norm}, metrics {hist[-1]}")

    # one round of each other codec; the uplink bytes per upload
    for name, ef in (("int4", False), ("topk0.01", True), ("bf16", False)):
        s = sim(name, ef, comm_rounds=1)
        row = s.run()[-1]
        cnt = s.metrics.telemetry.snapshot()["counters"]
        per = cnt["comm.compressed_bytes" + up] / cnt["comm.recv_msgs" + up]
        rec["uplink_bytes"][name] = per
        print(f"[compress] {name}{' + error feedback' if ef else ''}: 1 round, train_loss "
              f"{row['train_loss']:.4f}, test_acc {row['test_acc']:.4f}, {per:.0f} uplink "
              f"bytes per upload")
        if not math.isfinite(row["train_loss"]):
            fail(f"compress {name}: non-finite metrics {row}")
    ub = rec["uplink_bytes"]
    print(f"[compress] uplink bytes per ResNet-56 upload: fp32 {ub['fp32']:.0f}, int8 "
          f"{ub['int8']:.0f} ({ub['fp32'] / ub['int8']:.2f}x), int4 {ub['int4']:.0f}, "
          f"topk0.01 {ub['topk0.01']:.0f}, bf16 {ub['bf16']:.0f}")
    want = {"fp32": 2_401_256, "int8": 610_346, "int4": 312_525, "topk0.01": 48_904,
            "bf16": 1_200_628}
    if ub != want:
        fail(f"compress: uplink bytes {ub}, the JAX package's are {want}")
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False

    # the qsgd8 payload of a trained update, on the card and on the CPU
    g = resnet56_tpu(conv_variant="kernel").init(rng.PRNGKey(0))  # the run's start
    codec, key = compress.get_codec("int8"), rng.PRNGKey(2)
    delta = tree_map(lambda v, w: v.float() - w.float(), a.state.variables, g)
    card_wire = compress.wire_encode_tree(codec, delta, key)
    host_wire = compress.wire_encode_tree(codec, tree_map(lambda v: v.cpu(), delta), key)
    card_digest = compress.wire_tree_digest({"leaves": card_wire})
    host_digest = compress.wire_tree_digest({"leaves": host_wire})
    # and the update as the server decodes it, through the fused form
    host_delta = tree_map(lambda v: v.cpu(), delta)
    decoded = []
    for tree in (delta, host_delta):
        lay = compress.FlatLayout(tree, next(iter(tree["params"].values())).device)
        decoded.append(compress.roundtrip_flat(codec, lay.flatten(tree), key, lay).cpu())
    same_decoded = torch.equal(decoded[0], decoded[1])
    print(f"[compress] qsgd8 payload of a ResNet-56 update (sha256 over 292 leaves): "
          f"card {card_digest[:16]}, cpu {host_digest[:16]}, equal "
          f"{card_digest == host_digest}; decoded update card == cpu bitwise {same_decoded}")
    if card_digest != host_digest or not same_decoded:
        fail("compress: the card's qsgd8 payload or decoded update is not the CPU's")
    rec.update(payload_sha256_card=card_digest, payload_sha256_cpu=host_digest)

    # the codec stage per client: fused (what the round runs) and per leaf
    layout = compress.FlatLayout(g, torch.device("cuda"))
    gflat = layout.flatten(g)
    res = layout.flatten(delta) * 0.5

    def fused():
        return compress.uplink_roundtrip(codec, layout, gflat, a.state.variables, g,
                                         key, res)

    def per_leaf():
        return compress.roundtrip_tree(codec, delta, key)

    stage_ms, leaf_ms = _sync_ms(fused, 20), _sync_ms(per_leaf, 2)
    stage_launches, leaf_launches = _launches(fused), _launches(per_leaf)
    print(f"[compress] codec stage per client (int8 + EF, ResNet-56, host clock, synced): "
          f"fused {stage_ms:.3f} ms, {stage_launches} kernel launches; per leaf "
          f"{leaf_ms:.3f} ms, {leaf_launches} launches")

    # its share of a round: the same round with and without the codec
    # (COMPRESS_STEPS steps a client)
    clients, steps, batch = 4, COMPRESS_STEPS, 64
    bundle = resnet56_tpu(conv_variant="kernel")
    lu = make_local_update(bundle, make_client_optimizer("sgd", 0.001, momentum=0.9,
                                                         weight_decay=1e-3),
                           1, compute_dtype=torch.bfloat16)
    host_rng = np.random.RandomState(0)
    args = (torch.from_numpy(host_rng.rand(clients, steps, batch, 32, 32, 3)
                             .astype(np.float32)).cuda(),
            torch.from_numpy(host_rng.randint(0, 10, (clients, steps, batch))
                             .astype(np.int32)).cuda(),
            torch.ones((clients, steps, batch), device="cuda"),
            torch.full((clients,), float(steps * batch), device="cuda"),
            torch.ones((clients,), device="cuda"), np.arange(clients))
    variables = bundle.init(rng.PRNGKey(0))
    zeros = tree_map(lambda v: torch.zeros((clients, *v.shape), device="cuda"), variables)
    plain_state = ServerState(variables, (), 0, rng.PRNGKey(0))
    comp_state = ServerState(variables, (), 0, rng.PRNGKey(0), zeros)
    rounds = {"plain": (make_round_fn(lu), plain_state),
              "int8_ef": (make_round_fn(lu, codec=codec, error_feedback=True), comp_state)}

    def round_s(name):
        fn, state = rounds[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = fn(state, *args)
        float(m["loss_sum"])
        return time.perf_counter() - t0

    for name in rounds:  # warm-up
        round_s(name)
    times = {name: [] for name in rounds}
    for name in ("plain", "int8_ef", "int8_ef", "plain") * COMPRESS_TURNS:
        times[name].append(round_s(name))
    plain_s, comp_s = (float(np.median(times[n])) for n in ("plain", "int8_ef"))
    q1, q3 = np.percentile(times["plain"], [25, 75])
    share = (comp_s - plain_s) / comp_s
    print(f"[compress] round of {clients} clients x {steps} steps x batch {batch} (bf16, "
          f"kernel conv), {COMPRESS_TURNS} x in turns plain/int8+EF/int8+EF/plain: plain "
          f"{[round(t, 4) for t in times['plain']]} s, int8 + EF "
          f"{[round(t, 4) for t in times['int8_ef']]} s; medians {plain_s:.4f} / "
          f"{comp_s:.4f} s (the plain rounds' interquartile spread {q3 - q1:.4f} s): the "
          f"codec stage's share {100 * share:.2f}% ({1e3 * (comp_s - plain_s) / clients:.2f} "
          f"ms per client)")
    # where a round's extra host time goes: one profiled round of each,
    # ops ranked by how much more host time they took with the codec
    # (one step per client: the codec's cost does not depend on the steps)
    k = COMPRESS_PROFILED
    short = (args[0][:k, :1], args[1][:k, :1], args[2][:k, :1],
             torch.full((k,), float(batch), device="cuda"), args[4][:k], args[5][:k])
    prof = {name: _host_profile(lambda n=name: rounds[n][0](rounds[n][1], *short))
            for name in rounds}
    extra = (prof["int8_ef"]["launches"] - prof["plain"]["launches"]) / k
    grown = sorted(prof["int8_ef"]["ops"], key=lambda op: prof["plain"]["ops"].get(
        op, (0, 0.0))[1] - prof["int8_ef"]["ops"][op][1])[:5]
    print(f"[compress] profiled rounds of {k} clients x 1 step: plain "
          f"{prof['plain']['launches']} launches, "
          f"{prof['plain']['host_ms']:.1f} ms host op time; int8 + EF "
          f"{prof['int8_ef']['launches']} launches ({extra:.0f} more per client), "
          f"{prof['int8_ef']['host_ms']:.1f} ms host op time")
    for op in grown:
        (cp, tp), (cc, tc) = prof["plain"]["ops"].get(op, (0, 0.0)), prof["int8_ef"]["ops"][op]
        print(f"[compress]   {op[:48]:48s} plain x{cp} {tp:.1f} ms, int8 + EF x{cc} "
              f"{tc:.1f} ms")
    rec.update(stage_ms_per_client=stage_ms, stage_launches_per_client=stage_launches,
               round_launches_per_client_added=extra,
               per_leaf_ms_per_client=leaf_ms, per_leaf_launches_per_client=leaf_launches,
               round_plain_s=times["plain"], round_int8_ef_s=times["int8_ef"],
               stage_share_of_round=share, round_plain_spread_s=q3 - q1)
    del rounds, plain_state, comp_state, a, b, c
    torch.cuda.empty_cache()
    return rec


def phase_pack():
    """The native row-gather packer: it must be the compiled library (no
    silent numpy fallback), byte-identical to numpy; the pack time of a
    10 x 1536-image CIFAR cohort."""
    import numpy as np

    from fedml_tpu_torch.core.types import pack_clients
    from fedml_tpu_torch.data.cifar import load_cifar10
    from fedml_tpu_torch.native import native_available
    from fedml_tpu_torch.native import packer

    if not native_available():
        fail("pack: the native packer did not build or load")
    ds = load_cifar10(num_clients=10, partition="homo", seed=0)
    ids = np.arange(10)

    def pack(**kw):
        return pack_clients(ds, ids, 64, steps_per_epoch=24, seed=0, **kw)

    def ms(fn, reps=5):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps

    native = pack()
    native_ms, reuse_ms = ms(pack), ms(lambda: pack(reuse_buffers=True))
    lib = packer._lib
    packer._lib = None  # the numpy fallback, for comparison
    try:
        numpy_pack = pack()
        numpy_ms = ms(pack)
    finally:
        packer._lib = lib
    same = all(np.asarray(getattr(native, f)).tobytes() == np.asarray(getattr(numpy_pack, f))
               .tobytes() for f in ("x", "y", "mask", "num_samples"))
    mb = native.x.nbytes / 1e6
    print(f"[pack] native packer loaded ({packer._LIB.name}); a 10 x 1536-image cohort "
          f"({mb:.1f} MB of images): native {native_ms:.2f} ms, native with reused "
          f"buffers {reuse_ms:.2f} ms, numpy {numpy_ms:.2f} ms (host clock); "
          f"byte-identical {same}")
    if not same:
        fail("pack: the native pack differs from numpy's")
    return {"native_ms": native_ms, "reuse_ms": reuse_ms, "numpy_ms": numpy_ms,
            "cohort_mb": mb}


def _silo_bundle(model, device):
    from fedml_tpu_torch.experiments.registry import create_model

    return create_model(model, "cifar100", 100, input_shape=(32, 32, 3), device=device)


def _silo_round(model, variables, device, float64=False):
    """One make_round_fn round of 2 clients x 2 steps of SILO_ROUND_BATCH
    (a half-padded batch) on ``device`` from ``variables`` (cast to float64
    with the images, with ``float64``); returns the new variables, the
    round's metrics, the round function, its state and arguments."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import ServerState, make_round_fn
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.core.rng import PRNGKey

    lu = make_local_update(_silo_bundle(model, device),
                           make_client_optimizer("sgd", SILO_ROUND_LR), 1)
    data = _zoo_round_data("cifar100", SILO_ROUND_BATCH, 100, (32, 32, 3), None)
    dtype = torch.float64 if float64 else torch.float32
    args = (torch.from_numpy(data[0]).to(device, dtype),
            *(torch.from_numpy(a).to(device) for a in data[1:5]), data[5])
    state = ServerState(_tree_as(variables, dtype, device), (), 0, PRNGKey(1))
    round_fn = make_round_fn(lu, device=device)
    new, metrics = round_fn(state, *args)
    return new.variables, metrics, round_fn, state, args


def _round_gap(got: dict, want: dict) -> float:
    """The largest max |Δ| over the variables of two rounds, each leaf's over
    max(1, its largest magnitude in ``want``): relative for a large leaf,
    absolute for a small one.  A conv bias ahead of a BatchNorm gets no
    gradient in exact arithmetic (the mean cancels it): the float64 round
    leaves it ~1e-18, an fp32 round ~1e-9, so a gap relative to the leaf
    alone reads ~1e9 whatever the round did."""
    return max((got[c][k].cpu().double() - w.cpu().double()).abs().max().item()
               / max(1.0, w.abs().max().item())
               for c in want for k, w in want[c].items())


def _ulp_bumped(variables: dict, to: float) -> dict:
    """``variables`` with every parameter one ulp toward ``to`` (±inf)."""
    import torch

    return {**variables, "params": {k: torch.nextafter(v, torch.full_like(v, to))
                                    for k, v in variables["params"].items()}}


def _silo_faults():
    """The planted faults the round gate must refuse, each a patch of the
    package while in use: EfficientNet's stride-2 SAME padding made
    symmetric, and VGG's flatten in NCHW order."""
    from unittest import mock

    from fedml_tpu_torch.models import resnet, vgg

    pool = vgg.adaptive_avg_pool
    return [("efficientnet", "symmetric padding at stride 2",
             mock.patch.object(resnet, "same_pads",
                               lambda size, k, stride, dilation=1: (k // 2, k // 2))),
            ("vgg16_bn", "flatten in NCHW order",
             mock.patch.object(vgg, "adaptive_avg_pool",
                               lambda x, out: pool(x, out).permute(0, 3, 1, 2)))]


def _silo_cpu_rounds(in_path: str, out_path: str) -> None:
    """[silo]'s CPU side of the family rounds, in a process of its own
    beside the card's work (``_start_silo_cpu_rounds``): for each family's
    init in ``in_path`` (host fp32, drawn on the card), the CPU's fp32
    round (timed), its float64 round, and the fp32 rounds from the init one
    ulp up and down, saved to ``out_path``."""
    import torch

    os.nice(10)  # behind the card's host thread, whose times the phase prints
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    for model, host_vars in torch.load(in_path).items():
        (host, hm, *_), cpu_ms = _ms_of(lambda: _silo_round(model, host_vars, "cpu"), "cpu")
        ref = _silo_round(model, host_vars, "cpu", float64=True)[0]
        spread = [_round_gap(host, ref)] + [
            _round_gap(_silo_round(model, _ulp_bumped(host_vars, to), "cpu")[0], ref)
            for to in (math.inf, -math.inf)]
        out[model] = {"host": host, "ref": ref, "spread": spread, "cpu_ms": cpu_ms,
                      "loss_sum": float(hm["loss_sum"])}
    torch.save(out, out_path)


def _start_silo_cpu_rounds(device, tmp: str):
    """Draw each SILO_FAMILIES init on ``device``, save their host copies and
    start ``_silo_cpu_rounds`` on them in a new Python process; returns
    (the process, its output path)."""
    import torch

    from fedml_tpu_torch.core.rng import PRNGKey

    in_path, out_path = os.path.join(tmp, "silo_inits.pt"), os.path.join(tmp, "silo_cpu.pt")
    torch.save({m: _tree_as(_silo_bundle(m, device).init(PRNGKey(0)), torch.float32, "cpu")
                for m in SILO_FAMILIES}, in_path)
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
            f"chip_smoke._silo_cpu_rounds({in_path!r}, {out_path!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=here), out_path


def _silo_family_rounds(device, controls, card, rec, cpu_rounds, profile=False):
    """[silo]'s card against the CPU, one round per SILO_FAMILIES model from
    one init drawn on the card: the card's fp32 round held to the CPU's
    float64 round within the larger of ZOO_ROUND_RTOL and SILO_CHAOS x the
    spread of the CPU's fp32 rounds (from the init and from it one ulp up
    and down; ``cpu_rounds`` is ``_start_silo_cpu_rounds``'s process, which
    computes them); with ``controls`` the planted faults of
    ``_silo_faults`` must land beyond their family's gate; with ``profile``
    a ``torch.profiler`` trace of the card's round.  Records into ``rec``."""
    import torch

    from fedml_tpu_torch.core.rng import PRNGKey

    faults = _silo_faults() if controls else []
    refs = {}
    cards = {}
    for model in SILO_FAMILIES:
        variables = _silo_bundle(model, device).init(PRNGKey(0))
        (got, gm, *card_round), card_ms = _ms_of(
            lambda: _silo_round(model, variables, device), device)
        cards[model] = (_tree_as(got, torch.float32, "cpu"), float(gm["loss_sum"]), card_ms)
        if profile and device == "cuda":
            prof = profile_round(*card_round)
            prof["launches_per_step"] = prof["kernel_launches"] / 4
            print(f"[silo] {model}: {prof['launches_per_step']:.0f} kernel launches per "
                  "training step (a 2 x 2 round's launches / 4, aggregation included)")
            rec[f"profile {model}"] = prof
        del got, variables, card_round
        if device == "cuda":
            torch.cuda.empty_cache()
    proc, out_path = cpu_rounds
    t0 = time.perf_counter()
    if proc.wait() != 0:
        fail(f"silo: the CPU's reference rounds exited {proc.returncode}")
    waited = time.perf_counter() - t0
    cpu = torch.load(out_path)
    print(f"[silo] waited {waited:.1f} s for the CPU's rounds ({card})")
    for model in SILO_FAMILIES:
        got, loss_c, card_ms = cards.pop(model)
        c = cpu.pop(model)
        host, ref, spread, cpu_ms, loss_h = (c["host"], c["ref"], c["spread"], c["cpu_ms"],
                                             c["loss_sum"])
        gate = max(ZOO_ROUND_RTOL, SILO_CHAOS * max(spread))
        worst, card_host = _round_gap(got, ref), _round_gap(got, host)
        print(f"[silo] {model}: one round of 2 clients x 2 steps of {SILO_ROUND_BATCH} (fp32, "
              f"TF32 off, sgd lr {SILO_ROUND_LR:g}), max |Δ| / max(1, max |leaf|): card vs "
              f"cpu float64 {worst:.3g} (gate {gate:.3g}); cpu fp32 vs float64 from the init, "
              f"one ulp up, one ulp down {', '.join(f'{g:.3g}' for g in spread)}; card vs cpu "
              f"fp32 {card_host:.3g}; loss_sum {loss_c:.6f} vs {loss_h:.6f}; round "
              f"{card_ms:.1f} ms on the card, {cpu_ms:.1f} ms on the host's CPU ({card})")
        if not worst <= gate or not math.isfinite(loss_c):
            fail(f"silo {model}: the card's round is not the CPU's float64 one "
                 f"({worst:.3g} > {gate:.3g})")
        rec[f"round {model}"] = {"card_vs_f64": worst, "gate": gate, "cpu_spread": spread,
                                 "card_vs_cpu": card_host, "loss_sum": [loss_c, loss_h],
                                 "card_ms": card_ms, "cpu_ms": cpu_ms,
                                 **({"profile": rec.pop(f"profile {model}")}
                                    if f"profile {model}" in rec else {})}
        if model in {m for m, *_ in faults}:
            refs[model] = (ref, gate)
        del got, host, ref
    for model, fault, planted in faults:
        ref, gate = refs[model]
        variables = _silo_bundle(model, device).init(PRNGKey(0))
        with planted:
            got = _silo_round(model, variables, device)[0]
        g = _round_gap(got, ref)
        print(f"[silo] control, {model} with {fault}: card vs cpu float64 {g:.3g} (gate "
              f"{gate:.3g}): refused {g > gate}")
        if not g > gate:
            fail(f"silo control: the round gate passed {model} with {fault}")
        rec[f"control {model}"] = {"fault": fault, "card_vs_f64": g, "gate": gate}


def phase_silo(profile: bool = False, controls: bool = False, device: str = "cuda"):
    """The cross-silo image zoo: every pair of SILO_PAIRS through
    ``experiments.run.main`` (FedAvg, bf16, augmentation on) at full width,
    SILO_ROUNDS rounds (the first a warm-up); per pair the parameter count,
    the median round seconds and samples/s after the warm-up, the final test
    accuracy and loss (all finite) and the conv kernel's launches per
    forward (19 for ResNet-56, 18 of them tensor-core in each bf16 training
    forward; no launch of either kernel for the other models).  Then per
    new family one make_round_fn round initialized on the card and copied
    to the CPU: the card in fp32 (TF32 off) within the larger of
    ZOO_ROUND_RTOL and SILO_CHAOS x the spread of the CPU's fp32 rounds of
    the CPU's float64 round (``_round_gap``); and EfficientNet's
    drop-connect mask card == CPU bit for bit.
    ``controls`` adds the planted faults of ``_silo_faults``, which the
    round gate must refuse, ``profile`` a ``torch.profiler`` trace of each
    family's card round (launches per step, idle share); ``device`` "cpu"
    rehearses the phase without a card (both sides of the round then run on
    the CPU)."""
    import statistics
    import tempfile

    import torch

    from fedml_tpu_torch.core import rng as rnglib
    from fedml_tpu_torch.core.types import cohort_steps_per_epoch
    from fedml_tpu_torch.experiments import run
    from fedml_tpu_torch.experiments.registry import load_data, shrink_dataset
    from fedml_tpu_torch.models.efficientnet import drop_connect

    card = smi_line() if device == "cuda" else "cpu"
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rec = {"gpu": card}
    t_phase = time.perf_counter()
    launches = tc_launches = 0
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        # the family rounds' CPU side runs beside the pairs
        cpu_rounds = _start_silo_cpu_rounds(device, tmp)
        stack.callback(lambda: cpu_rounds[0].poll() is None and cpu_rounds[0].kill())
        for dataset, model, extra in SILO_PAIRS:
            ds = shrink_dataset(load_data(dataset, "", SILO_CLIENTS, "hetero", 0.5, 0),
                                SILO_SAMPLES, SILO_TEST)
            train_fwd = SILO_ROUNDS * SILO_CLIENTS * cohort_steps_per_epoch(ds, SILO_BATCH)
            # every round is evaluated at this cut (round 0 and the last)
            fwd = train_fwd + SILO_ROUNDS * math.ceil(len(ds.test_y) / SILO_BATCH)
            reset_launches()
            t0 = time.perf_counter()
            out = run.main(["--dataset", dataset, "--model", model, *extra, *SILO_COMMON,
                            "--device", device, "--run_dir", os.path.join(tmp, "runs")])
            sync()
            secs = time.perf_counter() - t0
            seen = read_launches()
            hist, final = out["history"], out["final"]
            round_s = statistics.median(r["time_round"] for r in hist[1:])
            samples = statistics.median(r["count"] for r in hist[1:])
            params = sum(p.numel() for p in
                         _zoo_bundle(dataset, model, ds.num_classes, (32, 32, 3),
                                     "meta").module.parameters())
            kernel = bool(extra)
            tag = f"{dataset}+{model}" + ("+kernel" if kernel else "")
            r = {"params": params, "run_s": secs, "round_s": [row["time_round"] for row in hist],
                 "median_round_s": round_s, "samples_per_round": samples,
                 "samples_per_s": samples / round_s, "forwards": fwd,
                 "launches": seen["conv3x3_mxu"], "tc_launches": seen["conv3x3_mxu_tc"],
                 "per_forward": seen["conv3x3_mxu"] / fwd,
                 "final": {k: v for k, v in final.items() if k.startswith(("test_", "train_"))}}
            rec[tag] = r
            launches += seen["conv3x3_mxu"]
            tc_launches += seen["conv3x3_mxu_tc"]
            finite = all(math.isfinite(v) for v in r["final"].values())
            print(f"[silo] {tag}: {params} params, {len(hist)} rounds x {SILO_CLIENTS} clients "
                  f"(batch {SILO_BATCH}, <= {SILO_SAMPLES} samples each) in {secs:.2f} s; median "
                  f"round {round_s:.4f} s after a warm-up, {r['samples_per_s']:.1f} samples/s; "
                  f"test_acc {final['test_acc']:.4f} test_loss {final['test_loss']:.4f}; finite "
                  f"{finite}; conv3x3_mxu launches {seen['conv3x3_mxu']} "
                  f"({seen['conv3x3_mxu_tc']} tensor-core) for {fwd} forwards = "
                  f"{r['per_forward']:.2f} per forward ({card})")
            if not finite or final["test_count"] <= 0:
                fail(f"silo {tag}: {final}")
            if seen["flash_attention_fwd"]:
                fail(f"silo {tag}: the flash kernel ran")
            want = ((19 * fwd, TC_PER_FORWARD * train_fwd) if kernel else (0, 0))
            if device == "cuda" and (seen["conv3x3_mxu"], seen["conv3x3_mxu_tc"]) != want:
                fail(f"silo {tag}: conv launches {seen}, expected {want[0]} ({want[1]} "
                     "tensor-core)")
        rec.update(launches=launches, tc_launches=tc_launches)

        # cuDNN's algorithms pinned, so a card's round repeats
        reset_launches()
        with deterministic():
            _silo_family_rounds(device, controls, card, rec, cpu_rounds, profile)
        seen = read_launches()
    if any(seen.values()):
        fail(f"silo: a family round launched a kernel of the JAX package's Pallas paths: {seen}")

    # EfficientNet's drop-connect mask, card against CPU, bit for bit
    x = torch.randn(64, 4, 4, 40, generator=torch.Generator().manual_seed(0))
    key = rnglib.fold_in(rnglib.PRNGKey(5), 3)
    a = drop_connect(x.to(device), 0.15, True, key).cpu()
    b = drop_connect(x, 0.15, True, key)
    same = torch.equal(a, b)
    kept = (b != 0).all((1, 2, 3)).float().mean().item()
    print(f"[silo] drop-connect 0.15 over a [64, 4, 4, 40] activation: card == cpu bitwise "
          f"{same} (kept {kept:.4f} of the samples)")
    if not same:
        fail("silo: the card's drop-connect mask is not the CPU's")
    rec["drop_connect_card_equals_cpu"] = same
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[silo] phase time: {rec['phase_s']:.1f} s ({card})")
    return rec


class _ForwardCounter:
    """Counts the calls of ``cls.forward`` while in use, training (``train``
    true) and evaluation apart."""

    def __init__(self, cls):
        self.cls, self.train, self.eval = cls, 0, 0

    def __enter__(self):
        orig = self.orig = self.cls.forward

        def counted(module, x, train=False, *a, **kw):
            if train:
                self.train += 1
            else:
                self.eval += 1
            return orig(module, x, train, *a, **kw)
        self.cls.forward = counted
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.orig


def _imagenet_bundle(model, dataset, classes, device, library=False):
    """The registry's model at 224 px; ResNet-56 on the conv kernel unless
    ``library``."""
    from fedml_tpu_torch.experiments.registry import create_model
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

    side = IMAGENET_SIDE
    if model == "resnet56" and not library:
        return resnet56_tpu(classes, side, device=device)
    return create_model(model, dataset, classes, input_shape=(side, side, 3), device=device)


def _logit_gap(got, want) -> float:
    """max |Δ| of two tensors over the largest magnitude of ``want``."""
    want = want.cpu().double()
    return ((got.cpu().double() - want).abs().max() / want.abs().max()).item()


def _imagenet_faults():
    """The planted faults the 224-px forward gate must refuse, each a patch
    of the package while in use: VGG's pool taken as a global mean instead
    of 7x7 bins, and ResNet-56's stride-2 3x3 convs padded on the wrong side
    (none above and left, two below and right: the kernel reads the input
    shifted by one pixel)."""
    from unittest import mock

    import torch.nn.functional as F

    from fedml_tpu_torch.models import resnet_tpu, vgg

    conv = resnet_tpu.conv3x3

    def wrong_side(x, w, stride):
        if stride == 2:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))[:, 1:, 1:, :].contiguous()
        return conv(x, w, stride)

    return [("vgg16_bn", "a global mean for the 7x7 pool",
             mock.patch.object(vgg, "adaptive_avg_pool",
                               lambda x, out: x.mean((1, 2), keepdim=True)
                               .expand(-1, out, out, -1))),
            ("resnet56", "stride-2 3x3 convs padded on the wrong side",
             mock.patch.object(resnet_tpu, "conv3x3", wrong_side))]


def _imagenet_forwards(device, controls, card, rec):
    """Each IMAGENET_FORWARDS model's fp32 eval forward of 2 images at 224 px:
    variables drawn on ``device``, the card's forward against the CPU's
    float64 one within the larger of ZOO_ROUND_RTOL and SILO_CHAOS x the
    spread of the CPU's fp32 forwards; with ``controls`` the planted faults of
    ``_imagenet_faults`` must land beyond their model's gate."""
    import numpy as np
    import torch

    from fedml_tpu_torch.core.rng import PRNGKey

    side = IMAGENET_SIDE
    x = np.random.RandomState(3).standard_normal((2, side, side, 3)).astype(np.float32)
    faults = {m: (f, planted) for m, f, planted in (_imagenet_faults() if controls else [])}
    for model, dataset, classes in IMAGENET_FORWARDS:
        bundle = _imagenet_bundle(model, dataset, classes, device)
        variables = bundle.init(PRNGKey(0))
        host_vars = _tree_as(variables, torch.float32, "cpu")
        ref_bundle = _imagenet_bundle(model, dataset, classes, "cpu", library=True)
        xd = torch.from_numpy(x).to(device)
        with torch.no_grad():
            got, card_ms = _ms_of(lambda: bundle.apply_eval(variables, xd), device)
            want = ref_bundle.apply_eval(_tree_as(host_vars, torch.float64),
                                         torch.from_numpy(x).double())
            spread = [_logit_gap(ref_bundle.apply_eval(v, torch.from_numpy(x)), want)
                      for v in (host_vars, _ulp_bumped(host_vars, math.inf),
                                _ulp_bumped(host_vars, -math.inf))]
        gate = max(ZOO_ROUND_RTOL, SILO_CHAOS * max(spread))
        gap = _logit_gap(got, want)
        finite = bool(torch.isfinite(got).all())
        print(f"[imagenet] {model} ({classes} classes) fp32 eval forward of 2 images at {side} "
              f"px: max |Δlogit| / max |logit|, card vs cpu float64 {gap:.3g} (gate "
              f"{gate:.3g}); cpu fp32 from the init, one ulp up, one ulp down "
              f"{', '.join(f'{g:.3g}' for g in spread)}; max |logit| "
              f"{want.abs().max().item():.4g}; finite {finite}; {card_ms:.1f} ms ({card})")
        if not (gap <= gate and finite):
            fail(f"imagenet {model}: the card's 224-px forward is not the CPU's float64 one "
                 f"({gap:.3g} > {gate:.3g})")
        r = rec[f"forward {model}"] = {"card_vs_f64": gap, "gate": gate, "cpu_spread": spread,
                                       "card_ms": card_ms}
        if model in faults:
            fault, planted = faults[model]
            with planted, torch.no_grad():
                bad = bundle.apply_eval(variables, xd)
            g = _logit_gap(bad, want)
            print(f"[imagenet] control, {model} with {fault}: card vs cpu float64 {g:.3g} "
                  f"(gate {gate:.3g}): refused {g > gate}")
            if not g > gate:
                fail(f"imagenet control: the forward gate passed {model} with {fault}")
            r["control"] = {"fault": fault, "card_vs_f64": g}
        del bundle, variables, host_vars, got
        if device == "cuda":
            torch.cuda.empty_cache()


def _base_framework_series(num_workers: int, comm_rounds: int) -> list:
    """The template's per-round sums in plain Python (the JAX package's
    ``tests/test_base_framework.py`` series)."""
    g, out = 0.0, []
    for _ in range(comm_rounds):
        g = sum(0.5 * g / (i + 1) + (i + 1) * 0.01 for i in range(num_workers))
        out.append(g)
    return out


def phase_imagenet(controls: bool = True, device: str = "cuda"):
    """The ImageNet and Landmarks loaders at 224 px: every IMAGENET_PAIRS pair
    through ``experiments.run.main`` (FedAvg, bf16, no augmentation) at full
    width, IMAGENET_ROUNDS rounds (the first a warm-up); per pair the
    parameter count, median round seconds and samples/s after the warm-up,
    the final test accuracy and loss (finite), the peak memory and the conv
    kernel's launches per forward (19 for ResNet-56, 18 of them tensor-core
    in each bf16 training forward; none for the others, and no flash
    launch).  Then the 224-px forward gates (``_imagenet_forwards``, with
    ``controls`` the planted faults), and ``run.main --algorithm
    base_framework`` on ``device``, its history equal to the plain-Python
    series exactly.  ``device`` "cpu" rehearses the phase without a card."""
    import statistics
    import tempfile

    import torch

    from fedml_tpu_torch.experiments import run
    from fedml_tpu_torch.models.resnet_tpu import CifarResNetTPU

    card = smi_line() if device == "cuda" else "cpu"
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rec = {"gpu": card}
    t_phase = time.perf_counter()
    launches = tc_launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        for dataset, model, extra in IMAGENET_PAIRS:
            reset_launches()
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _ForwardCounter(CifarResNetTPU) as fwd:
                out = run.main(["--dataset", dataset, "--model", model, *extra,
                                *IMAGENET_COMMON, "--device", device,
                                "--run_dir", os.path.join(tmp, "runs")])
            sync()
            secs = time.perf_counter() - t0
            seen = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else math.nan
            hist, final = out["history"], out["final"]
            round_s = statistics.median(r["time_round"] for r in hist[1:])
            samples = statistics.median(r["count"] for r in hist[1:])
            classes = 1000 if dataset == "ILSVRC2012" else 203
            params = sum(p.numel() for p in _imagenet_bundle(
                model, dataset, classes, "meta", library=True).module.parameters())
            kernel = bool(extra)
            tag = f"{dataset}+{model}" + ("+kernel" if kernel else "")
            forwards = fwd.train + fwd.eval
            r = {"params": params, "run_s": secs, "round_s": [row["time_round"] for row in hist],
                 "median_round_s": round_s, "samples_per_round": samples,
                 "samples_per_s": samples / round_s, "peak_gib": peak,
                 "forwards": forwards, "train_forwards": fwd.train,
                 "launches": seen["conv3x3_mxu"], "tc_launches": seen["conv3x3_mxu_tc"],
                 "per_forward": seen["conv3x3_mxu"] / max(forwards, 1),
                 "final": {k: v for k, v in final.items() if k.startswith(("test_", "train_"))}}
            rec[tag] = r
            launches += seen["conv3x3_mxu"]
            tc_launches += seen["conv3x3_mxu_tc"]
            finite = all(math.isfinite(v) for v in r["final"].values())
            print(f"[imagenet] {tag}: {params} params, {len(hist)} rounds x {IMAGENET_CLIENTS} "
                  f"clients (batch {IMAGENET_BATCH}, <= {IMAGENET_SAMPLES} samples each, "
                  f"{IMAGENET_SIDE} px) "
                  f"in {secs:.2f} s; median round {round_s:.4f} s after a warm-up, "
                  f"{r['samples_per_s']:.1f} samples/s; test_acc {final['test_acc']:.4f} "
                  f"test_loss {final['test_loss']:.4f}; finite {finite}; peak {peak:.2f} GiB; "
                  f"conv3x3_mxu launches {seen['conv3x3_mxu']} ({seen['conv3x3_mxu_tc']} "
                  f"tensor-core) for {forwards} forwards ({fwd.train} training) = "
                  f"{r['per_forward']:.2f} per forward ({card})")
            if not finite or final["test_count"] <= 0:
                fail(f"imagenet {tag}: {final}")
            if seen["flash_attention_fwd"]:
                fail(f"imagenet {tag}: the flash kernel ran")
            if kernel and not fwd.train:
                fail(f"imagenet {tag}: no training forward was counted")
            want = ((19 * forwards, TC_PER_FORWARD * fwd.train) if kernel else (0, 0))
            if device == "cuda" and (seen["conv3x3_mxu"], seen["conv3x3_mxu_tc"]) != want:
                fail(f"imagenet {tag}: conv launches {seen}, expected {want[0]} ({want[1]} "
                     "tensor-core)")
        rec.update(launches=launches, tc_launches=tc_launches)

        reset_launches()
        with deterministic():
            _imagenet_forwards(device, controls, card, rec)

        want = _base_framework_series(5, 4)
        out = run.main(["--algorithm", "base_framework", "--client_num_in_total", "5",
                        "--comm_round", "4", "--device", device,
                        "--run_dir", os.path.join(tmp, "bf")])
        same = out["history"] == want
        print(f"[imagenet] run.main --algorithm base_framework (5 workers, 4 rounds) on "
              f"{device}: history {out['history']} == the plain-Python series exactly {same}")
        if not same:
            fail(f"base_framework: {out['history']} != {want}")
        rec["base_framework"] = {"history": out["history"], "equal": same}
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[imagenet] phase time: {rec['phase_s']:.1f} s ({card})")
    return rec


def phase_comm(device: str = "cuda"):
    """The message core on the card: ResNet-56's variables on ``device``, in
    fp32 and in bf16, through ``tree_to_wire`` → ``Message.to_frame`` →
    ``Message.from_frame_bytes`` → ``tree_from_wire`` back onto ``device``,
    bit for bit, the frame's sha256 and ``wire_tree_digest`` equal to those
    of the same message built from the CPU copy; then a qsgd8 delta
    wiretree (one key) encoded on ``device``, its frame equal to the CPU's
    and its decode equal to the CPU's decode, bit for bit."""
    import hashlib

    import torch

    from fedml_tpu_torch.comm.message import (MSG_ARG_KEY_MODEL_PARAMS,
                                              MSG_ARG_KEY_NUM_SAMPLES,
                                              MSG_TYPE_C2S_SEND_MODEL, Message,
                                              tree_from_wire, tree_to_wire)
    from fedml_tpu_torch.compress import get_codec, wire_tree_digest
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

    card = smi_line() if device == "cuda" else "cpu"
    rec = {"gpu": card}
    t_phase = time.perf_counter()

    def frame_of(tree, **kw):
        wire = tree_to_wire(tree, **kw)
        msg = (Message(MSG_TYPE_C2S_SEND_MODEL, 1, 0)
               .add_params(MSG_ARG_KEY_MODEL_PARAMS, wire)
               .add_params(MSG_ARG_KEY_NUM_SAMPLES, 64))
        return wire, msg.to_frame()

    def on_cpu(tree):
        return {c: {k: v.cpu() for k, v in sub.items()} for c, sub in tree.items()}

    base = resnet56_tpu(device=device).init(PRNGKey(0))
    cases = [("fp32", base, {}), ("bf16", _tree_as(base, torch.bfloat16), {}),
             ("qsgd8 delta", base, {"codec": get_codec("qsgd8"), "key": PRNGKey(7),
                                    "delta": True})]
    for name, tree, kw in cases:
        (wire, frame), enc_ms = _ms_of(lambda: frame_of(tree, **kw), device)
        host = on_cpu(tree)
        host_wire, host_frame = frame_of(host, **kw)
        back, dec_ms = _ms_of(lambda: tree_from_wire(
            Message.from_frame_bytes(frame).get(MSG_ARG_KEY_MODEL_PARAMS), tree), device)
        sha, host_sha = (hashlib.sha256(f).hexdigest() for f in (frame, host_frame))
        digest, host_digest = wire_tree_digest(wire), wire_tree_digest(host_wire)
        if "codec" in kw:
            want = tree_from_wire(Message.from_frame_bytes(host_frame)
                                  .get(MSG_ARG_KEY_MODEL_PARAMS), host)
        else:
            want = tree
        same = _same_tensors(on_cpu(back), on_cpu(want)) and all(
            v.device == tree[c][k].device for c, sub in back.items() for k, v in sub.items())
        print(f"[comm] ResNet-56 {name}: frame {len(frame)} bytes, sha256 card == cpu "
              f"{sha == host_sha}, wire_tree_digest card == cpu {digest == host_digest}, "
              f"decoded on {device} equal bit for bit {same}; encode {enc_ms:.1f} ms, decode "
              f"{dec_ms:.1f} ms ({card})")
        if not (sha == host_sha and digest == host_digest and same):
            fail(f"comm {name}: the frame or its decode differs between the card and the CPU")
        rec[name] = {"frame_bytes": len(frame), "sha256": sha, "digest": digest,
                     "encode_ms": enc_ms, "decode_ms": dec_ms}
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[comm] phase time: {rec['phase_s']:.1f} s ({card})")
    return rec


def checkpoint_variables(path: str) -> list:
    """The model variables of a ``core/checkpoint.py`` npz of a
    ``ServerState``: its first leaves, up to where ``opt_state`` starts."""
    import numpy as np

    with np.load(path) as z:
        structure = bytes(z["__treedef__"]).decode()
        n = structure.split("opt_state=")[0].count("T:")
        return [np.array(z[f"leaf_{i}"]) for i in range(n)]


def phase_algos(device: str = "cuda"):
    """The FedAvg-engine family (ALGO_CASES) through ``experiments.run.main``
    on full-width ResNet-56 with every 3x3 conv on the kernel: per case the
    rounds' times, conv launches per forward (19), the final test accuracy
    and loss; every round's checkpoint.  Then the identities of
    ALGO_IDENTITIES between the cases' checkpoints, and the weak-DP noise
    of a (seed, round, slot) on the card against the CPU's, bit for bit.
    ``device`` "cpu" rehearses the phase without a card."""
    import tempfile

    import numpy as np
    import torch

    from fedml_tpu_torch.core import rng, robust
    from fedml_tpu_torch.core.types import cohort_steps_per_epoch
    from fedml_tpu_torch.experiments import run
    from fedml_tpu_torch.experiments.registry import load_data, shrink_dataset
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    ds = shrink_dataset(load_data("cifar10", "", ALGO_CLIENTS, "homo", 0.5, 0),
                        ALGO_SAMPLES, ALGO_TEST)
    steps = cohort_steps_per_epoch(ds, ALGO_BATCH)
    eval_fwd = math.ceil(len(ds.test_y) / max(ALGO_BATCH, 64))
    backdoor_fwd = math.ceil(int((ds.test_y != 0).sum()) / max(ALGO_BATCH, 64))
    rec, launches, tc_launches = {}, 0, 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in ALGO_CASES:
            algo = argv[1]
            group_rounds = 2 if algo == "hierarchical" else 1
            train_fwd = ALGO_ROUNDS * group_rounds * ALGO_CLIENTS * steps
            evals = ALGO_ROUNDS  # one per round: the first and the last (freq 5)
            fwd = train_fwd + evals * (eval_fwd + (backdoor_fwd if algo == "fedavg_robust"
                                                   else 0))
            reset_launches()
            t0 = time.perf_counter()
            out = run.main([*argv, *ALGO_COMMON, "--device", device,
                            "--checkpoint_every", "1", "--checkpoint_dir",
                            os.path.join(tmp, name), "--run_dir", os.path.join(tmp, "runs")])
            secs = time.perf_counter() - t0
            seen = read_launches()
            hist, final = out["history"], out["final"]
            r = {"run_s": secs, "round_s": [row["time_round"] for row in hist],
                 "forwards": fwd, "launches": seen["conv3x3_mxu"],
                 "tc_launches": seen["conv3x3_mxu_tc"],
                 "per_forward": seen["conv3x3_mxu"] / fwd,
                 "final": {k: v for k, v in final.items()
                           if k.startswith(("test_", "train_", "backdoor"))}}
            if "attacking" in final:
                r["attacking"] = [row["attacking"] for row in hist]
            rec[name] = r
            launches += seen["conv3x3_mxu"]
            tc_launches += seen["conv3x3_mxu_tc"]
            bd = (f" backdoor_acc {final['backdoor_acc']:.4f} (attacking "
                  f"{r['attacking']})" if "backdoor_acc" in final else "")
            print(f"[algos] {name}: {ALGO_ROUNDS} rounds in {secs:.2f} s, round s "
                  f"{[round(t, 4) for t in r['round_s']]}; train_loss "
                  f"{final['train_loss']:.4f} test_acc {final['test_acc']:.4f} test_loss "
                  f"{final['test_loss']:.4f}{bd}; conv3x3_mxu launches "
                  f"{seen['conv3x3_mxu']} ({seen['conv3x3_mxu_tc']} tensor-core) for {fwd} "
                  f"forwards = {r['per_forward']:.2f} per forward")
            if not all(math.isfinite(v) for v in r["final"].values()):
                fail(f"algos {name}: non-finite metrics {final}")
            if "attacking" in final and "backdoor_acc" not in final:
                fail(f"algos {name}: no backdoor_acc in the evaluation record")
            if device == "cuda" and (seen["conv3x3_mxu"] != 19 * fwd or
                                     seen["conv3x3_mxu_tc"] != TC_PER_FORWARD * train_fwd):
                fail(f"algos {name}: conv launches {seen}, expected {19 * fwd} "
                     f"({TC_PER_FORWARD * train_fwd} tensor-core)")
            if seen["flash_attention_fwd"]:
                fail(f"algos {name}: the ResNet-56 path launched the flash kernel")
        for name, ref, step, limit in ALGO_IDENTITIES:
            a, b = (checkpoint_variables(os.path.join(tmp, n, f"ckpt_{step}.npz"))
                    for n in (name, ref))
            diff = max(float(np.abs(x.astype(np.float64) - y).max()) for x, y in zip(a, b))
            rec[f"{name} vs {ref}"] = {"round": step, "max_abs_diff": diff, "limit": limit}
            print(f"[algos] {name} vs {ref} after round {step}: max |variable diff| "
                  f"{diff:.3g} over {len(a)} leaves (limit {limit:g})")
            if not (len(a) == len(b) > 0 and diff <= limit):
                fail(f"algos: {name} is not {ref} within {limit:g} ({diff:.3g})")
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False

    # weak-DP noise of (PRNGKey(0), round 1, slots 1 and 3) on ResNet-56's
    # parameters, on the card and on the CPU
    params = resnet56_tpu(device=device).init(rng.PRNGKey(0))["params"]
    stacked = {k: torch.stack([t, 0.5 * t]) for k, t in params.items()}
    keys = np.stack([robust.agg_noise_key(rng.PRNGKey(0), 1, slot) for slot in (1, 3)])
    card = robust.add_weak_dp_noise({"params": stacked}, keys, 0.025)["params"]
    host = robust.add_weak_dp_noise(
        {"params": {k: t.cpu() for k, t in stacked.items()}}, keys, 0.025)["params"]
    same = all(torch.equal(card[k].cpu(), host[k]) for k in host)
    n = sum(t.numel() for t in host.values())
    print(f"[algos] weak-DP noise (stddev 0.025) over ResNet-56's {n} stacked parameter "
          f"values, (seed 0, round 1, slots 1 and 3): card == cpu bitwise {same}")
    if not same:
        fail("algos: the card's weak-DP noise is not the CPU's")
    rec.update(launches=launches, tc_launches=tc_launches, weak_dp_card_equals_cpu=same)
    return rec


class _RoundTimer:
    """Wraps ``cls.method`` (or a module's function) while in use: the host
    seconds of each call (each ends in a metric read-back, so the device has
    finished), the last instance (first argument) it ran on and its last
    result."""

    def __init__(self, cls, method: str):
        self.cls, self.method, self.secs, self.owner, self.last = cls, method, [], None, None

    def __enter__(self):
        orig = self.orig = getattr(self.cls, self.method)

        def timed(obj, *a, **kw):
            t0 = time.perf_counter()
            out = orig(obj, *a, **kw)
            self.secs.append(time.perf_counter() - t0)
            self.owner, self.last = obj, out
            return out
        setattr(self.cls, self.method, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.method, self.orig)


def _ms_of(fn, device) -> tuple:
    """``(fn(), its host milliseconds)``, the device synchronized around it."""
    import torch

    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms without autotuning, and torch's
    deterministic algorithms (warn only), restored on the way out."""
    import torch

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def _same_tensors(a, b) -> bool:
    """Two trees of tensors equal leaf for leaf, bit for bit."""
    import torch

    from fedml_tpu_torch.core import tree as treelib

    la, lb = treelib.tree_leaves(a), treelib.tree_leaves(b)
    return len(la) == len(lb) > 0 and all(x.dtype == y.dtype and torch.equal(x, y)
                                          for x, y in zip(la, lb))


def phase_standalone(device: str = "cuda"):
    """The standalone drivers (STANDALONE_CASES) through
    ``experiments.run.main``: per driver the round (centralized: epoch)
    times, the final metrics and the conv kernel's launches against the
    forwards counted from the geometry (19 per forward, 18 tensor-core per
    bf16 training forward; none for the GKT pair).  Then, on the card
    against the CPU: ``secure_weighted_sum`` of four ResNet-56-sized
    vectors (bit for bit, and within n/(2·scale) of the float64 weighted
    sum), ``lcc_coded_sum`` with a dropped worker against the sum with none
    (bit for bit), an int64 ``randint`` over [0, 2^31 − 1) (bit for bit);
    and the gossip's consensus distance.  ``device`` "cpu" rehearses the
    phase without a card."""
    import tempfile

    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms import turboaggregate as turbo
    from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
    from fedml_tpu_torch.algorithms.decentralized import DecentralizedSimulation
    from fedml_tpu_torch.algorithms.fedgkt import FedGKT
    from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregateSimulation
    from fedml_tpu_torch.core import mpc, rng
    from fedml_tpu_torch.core import tree as treelib
    from fedml_tpu_torch.core.types import cohort_steps_per_epoch
    from fedml_tpu_torch.experiments import run
    from fedml_tpu_torch.experiments.registry import load_data, shrink_dataset
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

    ds = shrink_dataset(load_data("cifar10", "", ALGO_CLIENTS, "homo", 0.5, 0),
                        ALGO_SAMPLES, ALGO_TEST)
    steps = cohort_steps_per_epoch(ds, ALGO_BATCH)
    eval_fwd = math.ceil(len(ds.test_y) / 64)
    # centralized trains on the whole train set (the JAX driver ignores the
    # per-client cap): every epoch ceil(n / batch) steps
    train_fwd = {"centralized": CENTRAL_EPOCHS * math.ceil(len(ds.train_y) / ALGO_BATCH),
                 "decentralized": ALGO_ROUNDS * ALGO_CLIENTS * steps,
                 "turboaggregate": ALGO_ROUNDS * ALGO_CLIENTS * steps, "fedgkt": 0}
    timed = {"centralized": (CentralizedTrainer, "train"),
             "decentralized": (DecentralizedSimulation, "run_round"),
             "turboaggregate": (TurboAggregateSimulation, "run_round"),
             "fedgkt": (FedGKT, "run_round")}
    rec, launches, tc_launches = {}, 0, 0
    with tempfile.TemporaryDirectory() as tmp, deterministic():
        for name, argv in STANDALONE_CASES:
            fwd = train_fwd[name] + (eval_fwd if name != "fedgkt" else 0)
            with _RoundTimer(*timed[name]) as timer:
                reset_launches()
                t0 = time.perf_counter()
                out = run.main([*argv, "--device", device,
                                "--run_dir", os.path.join(tmp, "runs")])
                secs = time.perf_counter() - t0
                seen = read_launches()
            final = out.get("final") or out["history"][-1]
            r = {"run_s": secs, "round_s": timer.secs, "forwards": fwd,
                 "launches": seen["conv3x3_mxu"], "tc_launches": seen["conv3x3_mxu_tc"],
                 "final": {k: v for k, v in final.items() if k != "round"}}
            if name == "decentralized":
                r["consensus_distance"] = timer.owner.consensus_distance()
            rec[name] = r
            launches += seen["conv3x3_mxu"]
            tc_launches += seen["conv3x3_mxu_tc"]
            extra = (f"; consensus distance {r['consensus_distance']:.6g}"
                     if "consensus_distance" in r else "")
            print(f"[standalone] {name}: {secs:.2f} s, round s "
                  f"{[round(t, 4) for t in timer.secs]}; final "
                  f"{ {k: round(v, 4) for k, v in r['final'].items()} }{extra}; "
                  f"conv3x3_mxu launches {seen['conv3x3_mxu']} "
                  f"({seen['conv3x3_mxu_tc']} tensor-core) for {fwd} forwards")
            if not all(math.isfinite(v) for v in r["final"].values()):
                fail(f"standalone {name}: non-finite metrics {final}")
            if device == "cuda" and (seen["conv3x3_mxu"] != 19 * fwd or
                                     seen["conv3x3_mxu_tc"] != TC_PER_FORWARD * train_fwd[name]):
                fail(f"standalone {name}: conv launches {seen}, expected {19 * fwd} "
                     f"({TC_PER_FORWARD * train_fwd[name]} tensor-core)")
            if seen["flash_attention_fwd"]:
                fail(f"standalone {name}: the path launched the flash kernel")
            if name == "fedgkt":
                gkt_first = (out["history"], timer.owner)
        # FedGKT once more under the same flags: every round's record and the
        # final variables of both nets, bit for bit
        with _RoundTimer(FedGKT, "run_round") as timer:
            out = run.main([*dict(STANDALONE_CASES)["fedgkt"], "--device", device,
                            "--run_dir", os.path.join(tmp, "runs")])
        first_hist, first = gkt_first
        again = timer.owner
        same_records = out["history"] == first_hist
        same_vars = (_same_tensors(again.client_vars, first.client_vars)
                     and _same_tensors(again.server_vars, first.server_vars))
        print(f"[standalone] fedgkt run twice (deterministic cuDNN): every round's record "
              f"equal {same_records}, final client and server variables equal bitwise "
              f"{same_vars}; final {first_hist[-1]}")
        if not (same_records and same_vars):
            fail("standalone: FedGKT does not repeat on the card")
        rec["fedgkt_repeats_bitwise"] = True

    # the secure sum of four ResNet-56-sized vectors, on the device and the CPU
    d = treelib.tree_ravel(resnet56_tpu(device="cpu").init(rng.PRNGKey(0))).numel()
    r64 = np.random.RandomState(0)
    host = [torch.from_numpy(r64.normal(0, 0.1, d).astype(np.float32)) for _ in range(4)]
    vecs = [v.to(device) for v in host]
    w = np.asarray([0.1, 0.2, 0.3, 0.4])
    key = rng.PRNGKey(7)
    got, sec_ms = _ms_of(lambda: turbo.secure_weighted_sum(vecs, w, key), device)
    want, sec_cpu_ms = _ms_of(lambda: turbo.secure_weighted_sum(host, w, key), "cpu")
    exact = sum(wi * v.double() for wi, v in zip(w, host))
    err = float((want - exact).abs().max())
    same = torch.equal(got.cpu(), want)
    print(f"[standalone] secure_weighted_sum of 4 x {d} values: {device} {sec_ms:.1f} ms, "
          f"cpu {sec_cpu_ms:.1f} ms; {device} == cpu bitwise {same}; max |Δ| from the "
          f"float64 sum {err:.3g} (limit {4 / (2 * 2.0 ** 16):.3g})")
    if not same or err > 4 / (2 * 2.0 ** 16):
        fail("standalone: the secure sum differs from the CPU's or the float64 sum")
    full, lcc_ms = _ms_of(lambda: turbo.lcc_coded_sum(vecs, key), device)
    dropped = turbo.lcc_coded_sum(vecs, key, drop=(1,))
    lcc_same = torch.equal(full, dropped)
    print(f"[standalone] lcc_coded_sum (k 2, t 1) of the same vectors: {lcc_ms:.1f} ms; worker "
          f"1 dropped == none dropped bitwise {lcc_same}")
    if not lcc_same:
        fail("standalone: the LCC sum with a dropped worker differs")
    draw = rng.randint(rng.PRNGKey(3), (4, d), 0, mpc.DEFAULT_PRIME, device, torch.int64)
    draw_same = torch.equal(
        draw.cpu(), rng.randint(rng.PRNGKey(3), (4, d), 0, mpc.DEFAULT_PRIME, "cpu",
                                torch.int64))
    print(f"[standalone] int64 randint of 4 x {d} over [0, 2^31 - 1): {device} == cpu "
          f"bitwise {draw_same}")
    if not draw_same:
        fail("standalone: the int64 draw differs from the CPU's")
    rec.update(launches=launches, tc_launches=tc_launches, vector_size=d,
               secure_sum_ms=sec_ms, secure_sum_cpu_ms=sec_cpu_ms, secure_sum_err=err,
               secure_sum_card_equals_cpu=same, lcc_ms=lcc_ms, lcc_drop_equal=lcc_same,
               randint64_card_equals_cpu=draw_same)
    return rec


def _tree_as(tree, dtype, device=None):
    """A tree of tensors (dicts, lists, tuples; a named tuple comes back a
    plain one) with float leaves in ``dtype``, on ``device`` if given;
    leaves that are not tensors as they are."""
    import torch

    if isinstance(tree, dict):
        return {k: _tree_as(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return (list if isinstance(tree, list) else tuple)(_tree_as(v, dtype, device)
                                                           for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    tree = tree.detach() if device is None else tree.detach().to(device)
    return tree.to(dtype) if tree.is_floating_point() else tree


def leaf_gap(got: dict, want: dict) -> tuple:
    """(max over the leaves of two flat tensor dicts of max |Δ| over the
    leaf's largest magnitude in ``want``, that leaf's name, the largest
    max |Δ|)."""
    worst, worst_abs = (0.0, ""), 0.0
    for k, w in want.items():
        d = (got[k].cpu().double() - w.cpu().double()).abs().max().item()
        worst_abs = max(worst_abs, d)
        worst = max(worst, (d / max(w.abs().max().item(), 1e-30), k))
    return (*worst, worst_abs)


def smi_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def _split_sim(like, device, dtype=None, bump=None):
    """A fresh SplitNNSimulation with ``like``'s data and settings on
    ``device``; its states and data in ``dtype`` if given; with ``bump``
    (±inf) every parameter one ulp toward it."""
    import torch

    from fedml_tpu_torch.algorithms.splitnn import HalfState, SplitNNSimulation
    from fedml_tpu_torch.models.cnn import cnn_split_pair

    # SPLIT_ARGV's CIFAR-10 has 10 classes
    sim = SplitNNSimulation(*cnn_split_pair(10, like.bottom.input_shape, device=device),
                            like.client_data, like.test_data, batch_size=like.batch_size,
                            lr=like.lr, seed=like.seed, device=device)
    if bump is not None:
        def up(st):
            return HalfState({k: torch.nextafter(v, torch.full_like(v, bump))
                              for k, v in st.params.items()}, st.opt_state)
        sim.client_states = [up(st) for st in sim.client_states]
        sim.server_state = up(sim.server_state)
    if dtype is not None:
        sim.client_states = [HalfState(*_tree_as(st, dtype)) for st in sim.client_states]
        sim.server_state = HalfState(*_tree_as(sim.server_state, dtype))
        sim._data = [(x.to(dtype), y) for x, y in sim._data]
        sim._test = (sim._test[0].to(dtype), sim._test[1])
    return sim


def _split_gap(a, b) -> float:
    """The largest leaf gap over every client's bottom and the top."""
    return max([leaf_gap(x.params, y.params)[0] for x, y in zip(a.client_states,
                                                                 b.client_states)]
               + [leaf_gap(a.server_state.params, b.server_state.params)[0]])


def _family_splitnn(device, tmp, card, controls):
    """SplitNN through ``run.main``: the ring epoch's seconds, per client,
    samples/s and the validation accuracy.  Then the card against the
    CPU's float64 epoch: from each of the CPU's states, cast to fp32, the
    card takes the same step, within SPLIT_STEP_RTOL of each new leaf's
    largest magnitude (the CPU's fp32 step printed beside it); and
    ``run.main``'s fp32 epoch on the card within SPLIT_CHAOS × the farther
    gap of the CPU's fp32 epochs from an init one ulp up and one down (how
    far fp32 rounding alone carries this ring; at least ZOO_ROUND_RTOL).
    ``controls``: also a card epoch shuffled as in epoch 1, which the
    epoch gate must refuse."""
    import torch

    from fedml_tpu_torch.algorithms.splitnn import HalfState, SplitNNSimulation
    from fedml_tpu_torch.experiments import run

    with _RoundTimer(SplitNNSimulation, "run_epoch") as timer:
        out = run.main([*SPLIT_ARGV, "--device", device, "--run_dir", os.path.join(tmp, "runs")])
    card_sim = timer.owner
    hist = out["history"]
    samples = sum(len(x) // card_sim.batch_size * card_sim.batch_size
                  for x, _ in card_sim.client_data)
    epoch_s = timer.secs[0]
    r = {"epoch_s": epoch_s, "client_epoch_s": epoch_s / len(hist),
         "samples_per_s": samples / epoch_s, "val_acc": [row["val_acc"] for row in hist],
         "val_loss": [row["val_loss"] for row in hist]}
    print(f"[family] splitnn ring epoch, {len(hist)} clients x "
          f"{len(card_sim.client_data[0][0])} samples, batch {card_sim.batch_size}: "
          f"{epoch_s:.3f} s ({card})")
    print(f"[family] splitnn seconds per client epoch (validation included): "
          f"{r['client_epoch_s']:.4f} ({card})")
    print(f"[family] splitnn samples/s: {r['samples_per_s']:.1f} ({card})")
    print(f"[family] splitnn validation accuracy per client: "
          f"{[round(v, 4) for v in r['val_acc']]} ({card})")
    if not all(math.isfinite(v) for v in r["val_loss"]):
        fail(f"family splitnn: non-finite validation loss {r['val_loss']}")

    ref = _split_sim(card_sim, "cpu", torch.float64)
    host_step, card_step = ref._step, card_sim._step
    cpu_step = _split_sim(card_sim, "cpu")._step
    worst, worst_cpu, n = (0.0, ""), 0.0, 0

    def lockstep(bstate, tstate, x, y):
        nonlocal worst, worst_cpu, n
        nb, nt, m = host_step(bstate, tstate, x, y)
        n += 1
        for dev, step in ((device, card_step), ("cpu", cpu_step)):
            gb, gt, _ = step(HalfState(*_tree_as(bstate, torch.float32, dev)),
                             HalfState(*_tree_as(tstate, torch.float32, dev)),
                             x.to(dev, torch.float32), y.to(dev))
            for half, got, want in (("bottom", gb, nb), ("top", gt, nt)):
                rel, leaf, _ = leaf_gap(got.params, want.params)
                if step is card_step:
                    worst = max(worst, (rel, f"step {n} {half} {leaf}"))
                else:
                    worst_cpu = max(worst_cpu, rel)
        return nb, nt, m

    ref._step = lockstep
    ref.run_epoch()
    spread = 0.0
    for toward in (math.inf, -math.inf):
        bumped = _split_sim(card_sim, "cpu", bump=toward)
        bumped.run_epoch()
        spread = max(spread, _split_gap(bumped, ref))
    epoch = _split_gap(card_sim, ref)
    limit = max(ZOO_ROUND_RTOL, SPLIT_CHAOS * spread)
    r.update(card_step_vs_f64=worst[0], worst_step_leaf=worst[1], cpu_step_vs_f64=worst_cpu,
             card_epoch_vs_f64=epoch, cpu_fp32_ulp_epoch_vs_f64=spread, epoch_limit=limit)
    print(f"[family] splitnn each of {n} card fp32 steps from the cpu's float64 state vs the "
          f"float64 step, max |Δ| / max |leaf|: {worst[0]:.3g} ({worst[1]}; limit "
          f"{SPLIT_STEP_RTOL:g}); the cpu's fp32 steps beside them {worst_cpu:.3g} ({card})")
    print(f"[family] splitnn fp32 epoch vs the cpu's float64 epoch, max |Δ| / max |leaf| over "
          f"every bottom and the top: card {epoch:.3g}; the cpu's fp32 epochs from an init one "
          f"ulp up and one down, the farther {spread:.3g} (limit {SPLIT_CHAOS:g} x that, at "
          f"least {ZOO_ROUND_RTOL:g}: {limit:.3g}) ({card})")
    if not worst[0] <= SPLIT_STEP_RTOL:
        fail(f"family splitnn: a card step is not the float64 step ({worst[0]:.3g})")
    if not epoch <= limit:
        fail(f"family splitnn: the card's fp32 epoch is not the float64 epoch ({epoch:.3g})")
    if controls:
        # the ring shuffled as in epoch 1: the epoch gate must see it
        faulty = _split_sim(card_sim, device)
        faulty.epoch = 1
        faulty.run_epoch()
        r["control_shuffle"] = gap = _split_gap(faulty, ref)
        print(f"[family] splitnn control, the ring shuffled as in epoch 1: {gap:.3g} ({card})")
        if gap <= limit:
            fail("family splitnn: the epoch gate cannot tell a wrongly shuffled ring")
    return r


def _family_vfl(device, tmp, card):
    """VFL through ``run.main`` over a seeded lending-club npz of VFL_ROWS
    rows at the reference's feature width: steps/s, the last step's loss
    and the AUC; then the card's first VFL_CHECK_STEPS steps against the
    CPU's."""
    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms import vfl
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.data.tabular import LOAN_ALL_FEATURES, load_lending_club
    from fedml_tpu_torch.experiments import run
    from fedml_tpu_torch.models.finance import vfl_party

    data_dir = os.path.join(tmp, "lending_club")
    os.makedirs(data_dir)
    r64 = np.random.RandomState(0)
    x = r64.standard_normal((VFL_ROWS, len(LOAN_ALL_FEATURES))).astype(np.float32)
    w = r64.standard_normal(len(LOAN_ALL_FEATURES))
    y = (x @ w + 0.5 * r64.standard_normal(VFL_ROWS) > 0).astype(np.int32)
    np.savez(os.path.join(data_dir, "loan_processed.npz"), x=x, y=y)
    del x, y
    with _RoundTimer(vfl, "run_vfl") as run_timer, \
            _RoundTimer(vfl.VerticalFederation, "fit") as fit_timer:
        out = run.main(["--algorithm", "vfl", "--data_dir", data_dir, "--batch_size",
                        str(VFL_BATCH), "--comm_round", "1", "--device", device,
                        "--run_dir", os.path.join(tmp, "runs")])
    final = out["history"][-1]
    steps = len(fit_timer.secs)
    loss = float(fit_timer.last[1])
    r = {"rows": VFL_ROWS, "features": len(LOAN_ALL_FEATURES), "steps": steps,
         "run_s": run_timer.secs[0], "steps_per_s": steps / run_timer.secs[0],
         "loss": loss, "auc": final["auc"], "accuracy": final["accuracy"]}
    print(f"[family] vfl {VFL_ROWS} x {len(LOAN_ALL_FEATURES)} table, 2 parties, batch "
          f"{VFL_BATCH}, one epoch: {steps} steps in {r['run_s']:.3f} s, evaluation "
          f"included ({card})")
    print(f"[family] vfl steps/s: {r['steps_per_s']:.1f} ({card})")
    print(f"[family] vfl last step's loss: {loss:.6f} ({card})")
    print(f"[family] vfl test AUC: {final['auc']:.6f}, accuracy {final['accuracy']:.6f} "
          f"({card})")
    if not (math.isfinite(loss) and 0.5 < final["auc"] <= 1.0):
        fail(f"family vfl: loss {loss}, AUC {final['auc']}")
    # the card's first steps against the CPU's, on the same rows
    xt, yt, splits = load_lending_club(data_dir)
    n = VFL_CHECK_STEPS * VFL_BATCH
    states = []
    for dev in (device, "cpu"):
        fed = vfl.VerticalFederation([vfl_party(s.stop - s.start, 16, device=dev)
                                      for s in splits], lr=0.03, device=dev)
        st = fed.init(rng.PRNGKey(0))
        xs = [torch.from_numpy(xt[:n, s]).to(dev) for s in splits]
        yd = torch.from_numpy(yt[:n]).to(dev)
        for lo in range(0, n, VFL_BATCH):
            st, _ = fed.fit(st, [xi[lo:lo + VFL_BATCH] for xi in xs], yd[lo:lo + VFL_BATCH])
        states.append(st)
    worst = 0.0
    for c, h in zip(*states):
        for k, v in h.params.items():
            d = (c.params[k].cpu() - v).abs()
            worst = max(worst, float((d / (VFL_TOL + VFL_TOL * v.abs())).max()))
    r["card_vs_cpu"] = worst
    print(f"[family] vfl first {VFL_CHECK_STEPS} steps card vs cpu: max |Δ| / (1e-5 + "
          f"1e-5 |cpu|) = {worst:.3g} (limit 1) ({card})")
    if not worst <= 1.0:
        fail(f"family vfl: the card's steps are not the CPU's within {VFL_TOL:g}")
    return r


def _nas_check_search(device, dtype):
    """The card-against-CPU FedNAS search (NAS_CHECK), its data,
    variables and alphas in ``dtype``; every alpha gradient the round
    takes is kept (on the CPU, float64) in ``grads_seen``."""
    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.fednas import FedNASConfig, FedNASSearch
    from fedml_tpu_torch.core import optrepo
    from fedml_tpu_torch.core.types import FedDataset
    from fedml_tpu_torch.experiments.registry import load_data, shrink_dataset
    from fedml_tpu_torch.models.darts.search import darts_search

    big, small, crop, batch = NAS_CHECK
    ds = shrink_dataset(load_data("cifar10", "", 2, "homo", 0.5, 0), big, 32)
    idx = {0: ds.train_client_idx[0], 1: ds.train_client_idx[1][:small]}
    ds = FedDataset(train_x=ds.train_x[:, :crop, :crop].astype(dtype), train_y=ds.train_y,
                    test_x=ds.test_x[:, :crop, :crop].astype(dtype), test_y=ds.test_y,
                    train_client_idx=idx, test_client_idx=None, num_classes=10)
    search = FedNASSearch(darts_search(C=8, layers=4, image_size=crop, device=device), ds,
                          FedNASConfig(num_clients=2, clients_per_round=2, batch_size=batch,
                                       lr=0.025, arch_lr=3e-3, arch_order=2), device=device)
    if dtype == np.float64:
        search.variables = _tree_as(search.variables, torch.float64)
        search.alphas = _tree_as(search.alphas, torch.float64)
    search.grads_seen, a_opt = [], search.a_opt

    def update(g, state, params):
        search.grads_seen.append({k: v.detach().cpu().double() for k, v in g.items()})
        return a_opt.update(g, state, params)

    search.a_opt = optrepo.GradientTransformation(a_opt.init, update)
    return search


def _nas_reference(out_path: str) -> None:
    """The NAS_CHECK round on the CPU in float64, run in a process of its
    own beside the card's work (``_start_nas_reference``): the variables,
    alphas and alpha gradients, as numpy arrays, pickled to ``out_path``."""
    import pickle

    import numpy as np
    import torch

    os.nice(10)  # behind the card's host thread, whose times the phase prints
    torch.set_num_threads(4)
    ref = _nas_check_search("cpu", np.float64)
    ref.run_round()
    with open(out_path, "wb") as f:
        pickle.dump(_tree_map_leaves(lambda t: t.numpy(), {
            "variables": ref.variables, "alphas": ref.alphas,
            "grads_seen": ref.grads_seen}), f)


def _start_nas_reference(out_path: str):
    """``_nas_reference`` in a new Python process (this file imported as a
    module, whatever ran it)."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
            f"chip_smoke._nas_reference({out_path!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=here)


def _nas_reference_result(proc, out_path: str) -> dict:
    import pickle

    import torch

    if proc.wait() != 0:
        fail(f"family fednas: the CPU's float64 reference round exited {proc.returncode}")
    with open(out_path, "rb") as f:
        return _tree_map_leaves(torch.from_numpy, pickle.load(f))


def _tree_map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map_leaves(fn, v) for v in tree]
    return fn(tree)


def _nas_gaps(search, ref: dict) -> tuple:
    """(the variables' largest leaf gap from ``ref``'s, that leaf, the
    alphas' largest gap over the entries whose float64 gradient was at
    least NAS_MASK_TAU of its leaf's largest at every alpha step of
    ``ref``'s round, as a share of the leaf's largest magnitude)."""
    import torch

    var = max(leaf_gap(search.variables[c], ref["variables"][c])[:2]
              for c in ref["variables"])
    alpha = 0.0
    for k, want in ref["alphas"].items():
        keep = torch.ones(want.shape, dtype=torch.bool)
        for g in ref["grads_seen"]:
            keep &= g[k].abs() >= NAS_MASK_TAU * g[k].abs().max()
        d = (search.alphas[k].cpu().double() - want).abs()[keep]
        alpha = max(alpha, float(d.max()) / want.abs().max().item() if keep.any() else 0.0)
    return (*var, alpha)


def _nas_controls(device, ref, passes, card) -> dict:
    """The NAS_CHECK round on the card with a planted fault each (equal
    client weights, the valid batch one step off, no alpha step, a
    pad-only batch that steps): the round gate must refuse every one."""
    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms import fednas
    from fedml_tpu_torch.core import optrepo

    orig_mean, out = fednas._weighted_mean, {}

    def repack(search, train=None, valid=None):
        packs = search._packs

        def planted(ids, round_idx):
            pack, vpack = packs(ids, round_idx)
            return (train(pack) if train else pack), (valid(vpack) if valid else vpack)
        search._packs = planted

    def equal_weights(search):
        fednas._weighted_mean = lambda trees, w: orig_mean(trees, torch.full_like(w, 0.5))

    def no_alpha_step(search):
        search.a_opt = optrepo.GradientTransformation(
            search.a_opt.init,
            lambda g, s, p: ({k: torch.zeros_like(v) for k, v in g.items()}, s))

    plants = {
        "equal client weights": equal_weights,
        "the valid batch one step off": lambda s: repack(s, valid=lambda v: dataclasses.replace(
            v, **{f: np.roll(getattr(v, f), 1, 1) for f in ("x", "y", "mask")})),
        "no alpha step": no_alpha_step,
        "a pad-only batch that steps": lambda s: repack(s, train=lambda p: dataclasses.replace(
            p, mask=np.ones_like(p.mask))),
    }
    for name, plant in plants.items():
        faulty = _nas_check_search(device, np.float32)
        plant(faulty)
        try:
            faulty.run_round()
        finally:
            fednas._weighted_mean = orig_mean
        var, _, alpha = out[name] = _nas_gaps(faulty, ref)
        print(f"[family] fednas control, {name}: variables {var:.3g}, alphas {alpha:.3g} "
              f"({card})")
        if passes(var, alpha):
            fail(f"family fednas: the round gate cannot tell a round with {name}")
    return out


def _family_fednas(device, tmp, card, reference, controls):
    """FedNAS through ``run.main`` at arch_order 1 and 2 (search, then the
    train stage on the genotype): seconds per round of each stage and the
    genotype.  Then one order-2 search round (NAS_CHECK) on the card in
    fp32 against the CPU's in float64 (``reference``: the process of
    ``_start_nas_reference`` and its output file): the variables within
    NAS_VARS_RTOL of each leaf's largest magnitude, and the alphas within
    NAS_ALPHA_RTOL where the float64 gradient is not near zero
    (``_nas_gaps``), with the round's ms and peak memory; ``controls`` adds
    ``_nas_controls``."""
    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.fednas import FedNASSearch
    from fedml_tpu_torch.experiments import run

    r = {}
    for order in (1, 2):
        with _RoundTimer(FedNASSearch, "run_round") as timer:
            out = run.main([*NAS_ARGV, "--arch_order", str(order), "--device", device,
                            "--run_dir", os.path.join(tmp, "runs")])
        search_s = timer.secs
        train_s = [row["time_round"] for row in out["train_history"]]
        final = out["train_history"][-1]
        r[f"arch_order{order}"] = {"search_round_s": search_s, "train_round_s": train_s,
                                   "genotype": out["genotype"],
                                   "search_final": out["history"][-1], "train_final": final}
        print(f"[family] fednas arch_order {order} search rounds (C 8, 4 layers, "
              f"{NAS_CLIENTS} clients x 1 step of 16): {[round(t, 3) for t in search_s]} s "
              f"({card})")
        print(f"[family] fednas arch_order {order} train-stage rounds: "
              f"{[round(t, 3) for t in train_s]} s; test_acc {final['test_acc']:.4f} "
              f"({card})")
        print(f"[family] fednas arch_order {order} genotype: {out['genotype']}")
        if not all(math.isfinite(v) for k, v in final.items() if k.startswith(("test_",
                                                                               "train_"))):
            fail(f"family fednas arch_order {order}: non-finite {final}")

    checked = _nas_check_search(device, np.float32)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _, round_ms = _ms_of(checked.run_round, device)
    t0 = time.perf_counter()
    ref = _nas_reference_result(*reference)
    wait_s = time.perf_counter() - t0
    var, leaf, alpha = _nas_gaps(checked, ref)

    def passes(v, a):
        return v <= NAS_VARS_RTOL and a <= NAS_ALPHA_RTOL

    big, small, crop, batch = NAS_CHECK
    print(f"[family] fednas order-2 round, 2 clients of {big} and {small} ({crop}x{crop}, "
          f"batch {batch}, a pad-only batch), card fp32 vs cpu float64 (waited {wait_s:.1f} s "
          f"for it): variables {var:.3g} ({leaf}; limit {NAS_VARS_RTOL:g}), alphas where the "
          f"gradient is not near zero {alpha:.3g} (limit {NAS_ALPHA_RTOL:g}); card round "
          f"{round_ms:.1f} ms ({card})")
    if not passes(var, alpha):
        fail("family fednas: the card's search round is not the CPU's float64 round")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if device == "cuda" else float("nan")
    print(f"[family] fednas peak device memory in that round: {peak:.3f} GiB ({card})")
    r["card_vs_f64"] = {"variables": var, "leaf": leaf, "alphas": alpha, "round_ms": round_ms,
                        "reference_wait_s": wait_s, "peak_gib": peak}
    if controls:
        r["card_vs_f64"]["controls"] = _nas_controls(device, ref, passes, card)
    return r


def phase_family(device: str = "cuda", controls: bool = False, nas_reference=None):
    """The rest of the algorithm family through ``experiments.run.main``
    (``_family_splitnn``, ``_family_vfl``, ``_family_fednas``), in fp32 (TF32
    off) with the deterministic flags pinned, each held against a CPU run;
    the CPU's float64 FedNAS round runs in a process of its own
    (``nas_reference``: ``_start_nas_reference``'s process and output path,
    started earlier by the caller; started here at the phase's start
    without one).
    Neither kernel of the JAX package's Pallas paths is launched.
    ``controls`` adds the gates' planted-fault runs; ``device`` "cpu"
    rehearses the phase without a card."""
    import tempfile

    card = smi_line() if device == "cuda" else "cpu"
    rec = {"gpu": card}
    t0 = time.perf_counter()
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp, deterministic():
        if nas_reference is None:
            out_path = os.path.join(tmp, "nas_reference.pkl")
            nas_reference = (_start_nas_reference(out_path), out_path)
        try:
            rec["splitnn"] = _family_splitnn(device, tmp, card, controls)
            rec["vfl"] = _family_vfl(device, tmp, card)
            rec["fednas"] = _family_fednas(device, tmp, card, nas_reference, controls)
        finally:
            nas_reference[0].kill()
            nas_reference[0].wait()
    seen = read_launches()
    rec["launches"] = seen
    rec["phase_s"] = time.perf_counter() - t0
    print(f"[family] kernel launches in the phase: conv3x3_mxu {seen['conv3x3_mxu']}, "
          f"flash_attention_fwd {seen['flash_attention_fwd']} (expected 0 and 0) ({card})")
    print(f"[family] phase time: {rec['phase_s']:.1f} s ({card})")
    if seen["conv3x3_mxu"] or seen["flash_attention_fwd"]:
        fail(f"family: a path launched a kernel of the JAX package's Pallas paths: {seen}")
    return rec


# [xdevice]: cross-device FedAvg over the in-process bus (the managers of
# algorithms/fedavg_cross_device.py): ResNet-56 at full width on the conv
# kernel, bf16 compute, the CIFAR-10 stand-in with Dirichlet(0.5) clients cut
# to <= XD_SAMPLES samples each (2 steps of 64), 4 clients, 3 rounds (the first
# a warm-up), SGD lr 1e-3 momentum 0.9 wd 1e-3 as [main].  Round 0's aggregate
# is held to the simulation's at XD_ROUND0_TOL (only the folds differ: float64
# on the host against fp32 on the card); the last round, the simulation's
# taken from the federation's previous global, at XD_FINAL_TOL (readings, and
# why not at a one-ulp spread: PERF.md §6).
# (XD_ROUNDS cut from 3 to make room for [mesh]: round 0 and the last round,
# round 1, are gated; the median round is round 1's)
XD_CLIENTS, XD_BATCH, XD_SAMPLES, XD_ROUNDS = 4, 64, 128, 2
XD_ROUND0_TOL, XD_FINAL_TOL = 1e-6, 1e-5
XD_NORM_BOUND = 1.0  # the streaming defense's clip, far below a x10 upload
# the qsgd8 + EF runs: round 0 sends the full model, round 1 the delta chain
# (cut from 3 to make room for [tcp]; the digests still repeat)
XD_QSGD8_ROUNDS = 2


def _host_gap(got: dict, want: dict, floor: float = 1.0) -> tuple:
    """(max over the leaves of max |Δ| / max(floor, max |leaf of want|), that
    leaf) for two variable trees of numpy arrays or tensors.  ``floor`` 1 is
    ``_round_gap``'s measure (relative for a large leaf, absolute for a
    small one); a tiny ``floor`` gives the gap relative to each leaf."""
    import numpy as np

    from fedml_tpu_torch.compress import jax_leaves
    from fedml_tpu_torch.core.tree import host_array

    g = dict(jax_leaves(got))
    worst = (0.0, "")
    for path, w in jax_leaves(want):
        w64 = np.asarray(host_array(w), np.float64)
        d = np.abs(np.asarray(host_array(g[path]), np.float64) - w64).max()
        worst = max(worst, (float(d / max(np.abs(w64).max(), floor)), ".".join(path)))
    return worst


def _xd_problem(device, samples: Optional[int] = None, batch: Optional[int] = None):
    """[xdevice]'s problem: ResNet-56 on the conv kernel (bf16, [main]'s
    optimizer) over XD_CLIENTS clients of <= ``samples`` (XD_SAMPLES) images
    of the CIFAR-10 stand-in, the cohort's steps at ``batch`` (XD_BATCH)."""
    import torch

    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.core.types import cohort_steps_per_epoch
    from fedml_tpu_torch.data.cifar import load_cifar10
    from fedml_tpu_torch.experiments.registry import shrink_dataset
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu

    ds = shrink_dataset(load_cifar10(num_clients=XD_CLIENTS, partition="hetero",
                                     partition_alpha=0.5, seed=0), samples or XD_SAMPLES, 64)
    bundle = resnet56_tpu(conv_variant="kernel", device=device)
    opt = make_client_optimizer("sgd", 0.001, momentum=0.9, weight_decay=1e-3)
    lu = make_local_update(bundle, opt, epochs=1, compute_dtype=torch.bfloat16)
    return dict(ds=ds, bundle=bundle, lu=lu, init=bundle.init(PRNGKey(0)),
                steps=cohort_steps_per_epoch(ds, batch or XD_BATCH))


def _hist_delta(before: dict, name: str) -> tuple:
    """(count, sum) a telemetry histogram gained since ``before``."""
    from fedml_tpu_torch.obs.telemetry import get_telemetry

    now = get_telemetry().snapshot()["hists"].get(name, {"count": 0, "sum": 0.0})
    was = before.get(name, {"count": 0, "sum": 0.0})
    return now["count"] - was["count"], now["sum"] - was["sum"]


def _xd_run(p, device, *, label, card, plan_for=None, client_kw=None, clients_per_round=None,
            wrap_server=None, wrap_client=None, rounds=XD_ROUNDS, **server_kw):
    """One federation of the port's managers over an ``InprocBus``: ``rounds``
    rounds of XD_CLIENTS clients; returns its server, clients and the
    numbers [xdevice] prints (round seconds from the server's round log,
    uploads/s, encode/decode/fold ms per upload, frame bytes, launches)."""
    from fedml_tpu_torch import faults
    from fedml_tpu_torch.algorithms.fedavg_cross_device import (FedAvgClientManager,
                                                                FedAvgServerManager)
    from fedml_tpu_torch.comm.inproc import InprocBus
    from fedml_tpu_torch.obs.telemetry import get_telemetry

    bus = InprocBus()
    frames = {}  # (type, round) -> bytes of the first frame on the bus
    route = bus.route

    def tap(msg):
        key = (msg.type, msg.get("round_idx"))
        if key not in frames and msg.type in ("S2C_SYNC_MODEL", "C2S_SEND_MODEL"):
            frames[key] = (msg, msg.to_frame())
        route(msg)

    bus.route = tap
    server = FedAvgServerManager(
        bus.register(0), p["init"], num_clients=XD_CLIENTS,
        clients_per_round=clients_per_round or XD_CLIENTS, comm_rounds=rounds, seed=0,
        steps_per_epoch=p["steps"], stats_plane=False, **server_kw)
    if wrap_server:
        wrap_server(server)
    clients, enc = [], []
    for node in range(1, XD_CLIENTS + 1):
        backend = bus.register(node)
        plan = plan_for(faults, node) if plan_for else None
        if plan is not None:
            backend = faults.ChaosBackend(backend, plan)
        c = FedAvgClientManager(backend, p["lu"], p["ds"], batch_size=XD_BATCH,
                                template_variables=p["init"], seed=0, device=device,
                                **(client_kw(node) if client_kw else {}))
        encode = c._encode_upload

        def timed(*a, encode=encode):
            t0 = time.perf_counter()
            out = encode(*a)
            enc.append(time.perf_counter() - t0)
            return out

        c._encode_upload = timed
        if wrap_client:
            wrap_client(c)
        clients.append(c)
    hists = get_telemetry().snapshot()["hists"]
    reset_launches()
    t0 = time.perf_counter()
    server.start()
    deadline = time.monotonic() + 300
    while server.round_idx < rounds and time.monotonic() < deadline:
        bus.drain()
        time.sleep(0.005)
    bus.drain()
    wall = time.perf_counter() - t0
    seen = read_launches()
    if server.round_idx != rounds:
        fail(f"xdevice {label}: the federation stopped at round {server.round_idx}")
    closes = [r for r in server.round_log if "participants" in r]
    rounds_s = [r["t_close_m"] - r["t_open_m"] for r in closes]
    timed_s = rounds_s[1:]
    med = sorted(timed_s)[len(timed_s) // 2]
    n_dec, s_dec = _hist_delta(hists, "span.decode_s")
    n_fold, s_fold = _hist_delta(hists, "span.agg_fold_s")
    steps = sum(c.rounds_trained for c in clients) * p["steps"]
    sync = frames.get(("S2C_SYNC_MODEL", 1))
    up = frames.get(("C2S_SEND_MODEL", 1))
    rec = {"round_s": rounds_s, "median_round_s": med,
           "uploads_per_s": sum(len(r["participants"]) for r in closes[1:]) / sum(timed_s),
           "encode_ms": 1e3 * sum(enc) / max(len(enc), 1),
           "decode_ms": 1e3 * s_dec / max(n_dec, 1), "fold_ms": 1e3 * s_fold / max(n_fold, 1),
           "sync_frame_bytes": len(sync[1]) if sync else 0,
           "upload_frame_bytes": len(up[1]) if up else 0, "wall_s": wall,
           "client_steps": steps, "launches": seen["conv3x3_mxu"],
           "tc_launches": seen["conv3x3_mxu_tc"], "flash": seen["flash_attention_fwd"],
           "rejected": server.rejected_uploads}
    per_fwd = rec["launches"] / max(steps, 1)
    print(f"[xdevice] {label}: {rounds} rounds x {XD_CLIENTS} clients (<= {XD_SAMPLES} "
          f"samples, batch {XD_BATCH}, bf16) in {wall:.2f} s; round s "
          f"{[round(x, 4) for x in rounds_s]}, median {med:.4f} s after a warm-up, "
          f"{rec['uploads_per_s']:.2f} uploads/s; per upload encode {rec['encode_ms']:.1f} ms, "
          f"decode {rec['decode_ms']:.1f} ms, fold {rec['fold_ms']:.1f} ms; frames: sync "
          f"{rec['sync_frame_bytes']} B, upload {rec['upload_frame_bytes']} B; conv3x3_mxu "
          f"{rec['launches']} ({rec['tc_launches']} tensor-core) for {steps} client forwards "
          f"= {per_fwd:.2f} per forward; flash {rec['flash']} ({card})")
    if device == "cuda" and (rec["launches"] != 19 * steps
                             or rec["tc_launches"] != TC_PER_FORWARD * steps):
        fail(f"xdevice {label}: conv launches {seen}, expected {19 * steps} "
             f"({TC_PER_FORWARD * steps} tensor-core) for {steps} client forwards")
    if rec["flash"]:
        fail(f"xdevice {label}: the ResNet-56 clients launched the flash kernel")
    from fedml_tpu_torch.compress import jax_leaves
    from fedml_tpu_torch.core.tree import host_array

    import numpy as np

    if not all(np.isfinite(host_array(l)).all() for _, l in jax_leaves(server.variables)):
        fail(f"xdevice {label}: non-finite global model")
    return server, clients, rec, frames


def _xd_sim(p, device, variables=None, start: int = 0):
    """The port's FedAvgSimulation of the same federation (full
    participation, the same local update and keys) on ``device``, from
    ``variables`` (the init if None) at round ``start``, to the last round;
    returns its variables (on the CPU) after every round."""
    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, FedAvgSimulation

    cfg = FedAvgConfig(num_clients=XD_CLIENTS, clients_per_round=XD_CLIENTS,
                       comm_rounds=XD_ROUNDS, epochs=1, batch_size=XD_BATCH, lr=0.001,
                       momentum=0.9, weight_decay=1e-3, frequency_of_the_test=1000, seed=0,
                       compute_dtype="bf16")
    sim = FedAvgSimulation(p["bundle"], p["ds"], cfg, local_update=p["lu"], device=device)
    if variables is not None:
        sim.state = sim.state._replace(variables={
            c: {k: torch.as_tensor(np.array(v) if not isinstance(v, torch.Tensor) else v)
                .to(device) for k, v in sub.items()} for c, sub in variables.items()})
    sim.state = sim.state._replace(round_idx=start)
    out = []
    for _ in range(start, XD_ROUNDS):
        sim.run_round()
        out.append({c: {k: v.detach().cpu() for k, v in sub.items()}
                    for c, sub in sim.state.variables.items()})
    return out


def _snapshots(server):
    """Record the server's variables after every round close."""
    snaps = []
    close = server._close_round

    def recording(*a, **kw):
        out = close(*a, **kw)
        snaps.append(server.variables)
        return out

    server._close_round = recording
    return snaps


def phase_xdevice(device: str = "cuda"):
    """Cross-device FedAvg of the port over the in-process bus, the
    managers' public API (``FedAvgServerManager(backend, init, ...)``,
    ``FedAvgClientManager(backend, local_update, dataset, ...)``), each
    client's local update on ResNet-56 with every 3x3 conv on the kernel
    (19 launches per forward, 18 tensor-core per bf16 training forward),
    the uploads copied to the host and folded in float64 there.

    1. sync, full participation, held against the port's FedAvgSimulation
       on the card (same init, keys, local update): round 0's aggregate
       within XD_ROUND0_TOL, the last round (from the federation's previous
       global) within XD_FINAL_TOL; a planted fault (one client's sample
       count doubled) beyond both; round 1's sync and upload frames card ==
       CPU by sha256;
    2. qsgd8 + EF uploads with the delta broadcast (qsgd8 chain), twice, 2
       rounds each:
       the upload digests repeat bit for bit;
    3. async, cut 2 of 4, max staleness 2, poly alpha 0.5, one client with a
       train delay: stale uploads folded at w(d)·n and counted; the same
       run at cut 4 and alpha 0 equal to case 1's model bit for bit;
    4. faults and defense: a ChaosBackend NaN-corrupts one upload, which is
       rejected and counted; a x10 attacker clipped by the streaming norm
       bound; under the median close the attacker and the corrupt upload
       leave a model equal to the host median of the decoded uploads.

    ``device`` "cpu" rehearses the phase without a card (launch counts are
    0 there)."""
    import hashlib

    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.fedavg_cross_device import encode_client_upload
    from fedml_tpu_torch.comm.message import Message, tree_to_wire
    from fedml_tpu_torch.obs.telemetry import get_telemetry
    from fedml_tpu_torch.robust import DefenseConfig

    card = smi_line() if device == "cuda" else "cpu"
    rec = {"gpu": card}
    t_phase = time.perf_counter()
    tel = get_telemetry()
    launches = tc = 0
    with deterministic():
        p = _xd_problem(device)

        # -- 1. sync against the simulation ---------------------------------------------
        captured = {}

        def capture_round1(client):
            if client.backend.node_id != 1:
                return
            encode = client._encode_upload

            def both(codec, new_vars, synced, round_idx, slot):
                wire = encode(codec, new_vars, synced, round_idx, slot)
                if round_idx == 1:
                    cpu = {c: {k: v.cpu() for k, v in sub.items()} for c, sub in new_vars.items()}
                    captured["upload_cpu"] = encode_client_upload(
                        codec, cpu, cpu, cpu, seed=0, round_idx=1, slot=slot)[0]
                return wire

            client._encode_upload = both

        snaps = []
        server, _, r1, frames = _xd_run(p, device, label="sync", card=card,
                                        wrap_server=lambda s: snaps.append(_snapshots(s)),
                                        wrap_client=capture_round1)
        fed = snaps[0]
        # Round 0 from the same init and the last round from the federation's
        # own previous global: the clients' models are the simulation's bit
        # for bit and only the folds differ (float64 on the host, fp32 on the
        # card).  Free-running, bf16 steps carry round 0's one-ulp fold
        # difference to ~1e-2 of the leaves in three rounds, as far as one
        # ulp on the global moves one round (the spread printed) and as far
        # as a doubled sample count moves it: that gap is printed, not gated.
        # Gaps are max |Δ| / max(1, max |leaf|), as [silo]'s: a BatchNorm
        # bias starts at 0, where a leaf-relative gap reads bf16's rounding
        # (printed beside it).
        free = _xd_sim(p, device)
        last = XD_ROUNDS - 1
        round0, leaf0 = _host_gap(fed[0], free[0])
        rel0 = _host_gap(fed[0], free[0], 1e-30)
        forced = _xd_sim(p, device, fed[last - 1], last)[-1]
        final, leaf = _host_gap(fed[last], forced)
        spread = 0.0
        for to in (float("inf"), float("-inf")):
            bumped = {**fed[last - 1], "params": {
                k: np.nextafter(v, np.float32(to)) for k, v in fed[last - 1]["params"].items()}}
            spread = max(spread, _host_gap(_xd_sim(p, device, bumped, last)[-1], forced)[0])
        gate = XD_FINAL_TOL
        drift, drift_leaf = _host_gap(fed[last], free[last])
        launches += r1["launches"]
        tc += r1["tc_launches"]

        # the planted fault: client 2 reports twice its sample count
        def double_n(client):
            if client.backend.node_id != 2:
                return
            send = client.send_message

            def doubled(msg):
                if msg.type == "C2S_SEND_MODEL":
                    msg.add_params("num_samples", 2.0 * msg.get("num_samples"))
                send(msg)

            client.send_message = doubled

        fault_snaps = []
        _, _, rf, _ = _xd_run(p, device, label="sync, planted fault (client 2's n doubled)",
                              card=card, wrap_server=lambda s: fault_snaps.append(_snapshots(s)),
                              wrap_client=double_n)
        launches += rf["launches"]
        tc += rf["tc_launches"]
        faulted = fault_snaps[0]
        f0 = _host_gap(faulted[0], free[0])[0]
        ff = _host_gap(faulted[last], _xd_sim(p, device, faulted[last - 1], last)[-1])[0]
        # round 1's frames: the sync as sent (host numpy) against the same
        # model encoded from card tensors; client 1's upload as sent (from
        # its card tensors) against the CPU copy's
        sync_msg, sync_frame = frames[("S2C_SYNC_MODEL", 1)]
        on_card = {c: {k: torch.as_tensor(np.array(v)).to(device) for k, v in sub.items()}
                   for c, sub in fed[0].items()}
        sync_card = Message(sync_msg.type, 0, sync_msg.receiver)
        sync_card.params = {**sync_msg.params, "model_params": tree_to_wire(on_card)}
        up_msg, up_frame = frames[("C2S_SEND_MODEL", 1)]
        up_cpu = Message(up_msg.type, up_msg.sender, 0)
        up_cpu.params = {**up_msg.params, "model_params": captured["upload_cpu"]}
        sha = {k: hashlib.sha256(b).hexdigest() for k, b in (
            ("sync", sync_frame), ("sync_card", sync_card.to_frame()),
            ("upload", up_frame), ("upload_cpu", up_cpu.to_frame()))}
        frames_ok = sha["sync"] == sha["sync_card"] and sha["upload"] == sha["upload_cpu"]
        print(f"[xdevice] sync vs FedAvgSimulation on {device} (max |Δ| / max(1, max |leaf|)): "
              f"round 0 {round0:.3g} ({leaf0}; gate {XD_ROUND0_TOL:g}; per leaf max |Δ| / max "
              f"|leaf| {rel0[0]:.3g}, {rel0[1]}); round {last} from the federation's round "
              f"{last - 1} global {final:.3g} ({leaf}; gate {gate:g}; the same round from that "
              f"global one ulp up and down: spread {spread:.3g}); free-running from the init "
              f"after {XD_ROUNDS} rounds {drift:.3g} ({drift_leaf}; not gated); planted fault: "
              f"round 0 {f0:.3g}, round {last} {ff:.3g}; round 1 frames card == cpu by sha256: "
              f"sync {sha['sync'] == sha['sync_card']}, upload {sha['upload'] == sha['upload_cpu']} "
              f"({card})")
        if round0 > XD_ROUND0_TOL or final > gate:
            fail("xdevice: the federation is not the simulation")
        if not (f0 > XD_ROUND0_TOL and ff > gate):
            fail("xdevice: the planted fault (a doubled sample count) passed a gate")
        if not frames_ok:
            fail("xdevice: round 1's frames differ between the card and the CPU")
        rec["sync"] = {**r1, "round0_gap": round0, "round0_leaf_rel": rel0[0],
                       "final_round_gap": final, "final_round_gate": gate, "final_round_ulp_spread": spread,
                       "free_running_gap": drift, "fault_round0_gap": f0,
                       "fault_final_round_gap": ff, "frames_sha256": sha}
        sync_final = fed[-1]

        # -- 2. qsgd8 + EF uplink, delta broadcast, twice ------------------------------
        digests = []
        for run in (1, 2):
            _, clients, r2, _ = _xd_run(p, device, label=f"qsgd8 + EF, delta bcast, run {run}",
                                        card=card, codec="qsgd8", bcast="delta",
                                        rounds=XD_QSGD8_ROUNDS)
            digests.append([c.upload_digest for c in clients])
            launches += r2["launches"]
            tc += r2["tc_launches"]
        print(f"[xdevice] qsgd8 + EF upload digests repeat bit for bit: "
              f"{digests[0] == digests[1]} ({card})")
        if digests[0] != digests[1]:
            fail("xdevice: the qsgd8 + EF uploads did not repeat")
        rec["qsgd8_ef_delta"] = {**r2, "digests_repeat": True}

        # -- 3. async ----------------------------------------------------------------------
        stale0 = tel.counter_value("async.stale_weighted_uploads")
        folded0 = tel.counter_value("async.folded_weight")
        _, _, r3, _ = _xd_run(p, device, label="async cut 2 of 4, poly 0.5, client 4 delayed",
                              card=card, round_mode="async", cut_size=2, max_staleness=2,
                              stale_policy="poly", stale_alpha=0.5,
                              client_kw=lambda n: {"train_delay": 0.05 if n == 4 else 0.0})
        stale = tel.counter_value("async.stale_weighted_uploads") - stale0
        folded = tel.counter_value("async.folded_weight") - folded0
        launches += r3["launches"]
        tc += r3["tc_launches"]
        server4, _, r4, _ = _xd_run(p, device, label="async cut 4, alpha 0", card=card,
                                    round_mode="async", cut_size=4, stale_alpha=0.0)
        launches += r4["launches"]
        tc += r4["tc_launches"]
        same = _host_gap(server4.variables, sync_final)[0] == 0.0
        print(f"[xdevice] async: {stale:.0f} stale uploads folded at w(d)·n, folded weight "
              f"{folded:.1f}; cut 4 alpha 0 == sync bit for bit: {same} ({card})")
        if not stale > 0:
            fail("xdevice: the async cut folded no stale upload")
        if not same:
            fail("xdevice: async at cut K and alpha 0 is not the sync run")
        rec["async"] = {**r3, "stale_uploads": stale, "folded_weight": folded}
        rec["async_cut_k"] = {**r4, "equals_sync": same}

        # -- 4. faults and defense ---------------------------------------------------------
        def chaos(mod, node):
            if node == 2:  # the x10 attacker
                return mod.FaultPlan(0, rules=[mod.FaultRule(
                    action="scale_grad", node=2, msg_type="C2S_SEND_MODEL",
                    attack_scale=10.0)])
            if node == 3:  # one NaN-corrupted upload, round 1
                return mod.FaultPlan(0, rules=[mod.FaultRule(
                    action="corrupt", node=3, msg_type="C2S_SEND_MODEL", round=1)])
            return None

        corrupt0 = tel.counter_value("faults.observed", kind="corrupt_upload",
                                     msg_type="C2S_SEND_MODEL")
        clipped0 = tel.counter_value("robust.clipped_uploads")
        _, _, r5, _ = _xd_run(p, device, label="chaos: x10 attacker + NaN upload, norm clip",
                              card=card, plan_for=chaos, clients_per_round=3, spares=1,
                              defense=DefenseConfig(defense="streaming",
                                                    norm_bound=XD_NORM_BOUND))
        clipped = tel.counter_value("robust.clipped_uploads") - clipped0
        launches += r5["launches"]
        tc += r5["tc_launches"]
        medians = []

        def keep_median_inputs(server):
            close = server._close_round

            def recording(*a, **kw):
                ups = [e["variables"]["params"] for e in server.pending.values()]
                out = close(*a, **kw)
                medians.append((ups, server.variables["params"]))
                return out

            server._close_round = recording

        _, _, r6, _ = _xd_run(p, device, label="chaos: x10 attacker + NaN upload, median close",
                              card=card, plan_for=chaos, clients_per_round=3, spares=1,
                              defense=DefenseConfig(defense="median"),
                              wrap_server=keep_median_inputs)
        launches += r6["launches"]
        tc += r6["tc_launches"]
        corrupt = tel.counter_value("faults.observed", kind="corrupt_upload",
                                    msg_type="C2S_SEND_MODEL") - corrupt0
        median_ok = bool(medians) and all(
            np.array_equal(np.median(np.stack([np.asarray(u[k], np.float32) for u in ups]),
                                     axis=0).astype(np.asarray(got[k]).dtype),
                           np.asarray(got[k]))
            for ups, got in medians for k in got)
        print(f"[xdevice] faults: NaN uploads rejected {r5['rejected']} + {r6['rejected']} "
              f"(faults.observed corrupt_upload +{corrupt:.0f}); x10 uploads clipped to "
              f"norm {XD_NORM_BOUND:g}: {clipped:.0f}; median close == the host median of the "
              f"decoded uploads in {len(medians)} rounds: {median_ok} ({card})")
        if not (r5["rejected"] == 1 and r6["rejected"] == 1 and corrupt == 2):
            fail("xdevice: the NaN upload was not rejected and counted once per run")
        if clipped < XD_ROUNDS:
            fail("xdevice: the x10 attacker was not clipped every round")
        if not median_ok:
            fail("xdevice: the median close is not the host median of the uploads")
        rec["faults_clip"] = {**r5, "clipped": clipped, "corrupt_counted": corrupt}
        rec["faults_median"] = {**r6, "median_equals_host": median_ok}
    rec["launches"] = launches
    rec["tc_launches"] = tc
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[xdevice] phase time: {rec['phase_s']:.1f} s; conv3x3_mxu launches {launches} "
          f"({tc} tensor-core) ({card})")
    return rec



# [tcp]: [xdevice]'s sync federation (``_xd_problem``: the kernel ResNet-56,
# bf16, 4 clients x 2 steps of 64, XD_ROUNDS rounds) over the port's TcpHub on
# loopback, server, hub and clients in one process, each client with its own
# TcpBackend: reactor hub with the tcp lane, reactor hub with the shm lane,
# threaded hub with the tcp lane, beside the same federation over the
# InprocBus.  Each client trains on its backend's reader thread, and their
# local updates take turns on the card, as over the in-process bus: four
# client threads launching eager steps at once contend for the interpreter
# lock (rounds 1.9-2.4x the in-process one on the card, PERF.md §6).  Then
# distributed_fedavg's launch() as real processes on the card, flat and tree
# side by side.
TCP_MODES = [("reactor", "tcp"), ("reactor", "shm"), ("threaded", "tcp")]
# the loopback federations and their in-process reference run 2 rounds (cut
# from XD_ROUNDS to make room for [mesh]; the gates read round 0, the time
# round 1)
TCP_ROUNDS = 2
TCP_SHM_MIB = 16  # each connection's slab: a few 2.42 MB frames in flight
TCP_LAUNCH = dict(num_clients=3, rounds=2, seed=0, batch_size=16, lane="shm",
                  shm_mib=1, shm_min_bytes=0)  # every LR payload rides the lane


def _upload_frames(sink: dict):
    """A wrap_client hook: the sha256 of each client's round-0 upload frame,
    as its backend is handed it."""
    import hashlib

    def wrap(client):
        send = client.send_message

        def recording(msg):
            if msg.type == "C2S_SEND_MODEL" and msg.get("round_idx") == 0:
                sink[client.backend.node_id] = hashlib.sha256(msg.to_frame()).hexdigest()
            send(msg)

        client.send_message = recording

    return wrap


def _wire_totals(before: dict) -> dict:
    """Frames and bytes the process's backends received since ``before``
    (every frame the hub routed, counted where it landed) and sent."""
    from fedml_tpu_torch.obs.telemetry import get_telemetry

    now = get_telemetry().snapshot()["counters"]

    def total(prefix):
        return sum(v - before.get(k, 0.0) for k, v in now.items() if k.startswith(prefix))

    return {"routed_frames": total("comm.recv_msgs"), "routed_bytes": total("comm.recv_bytes"),
            "sent_frames": total("comm.sent_msgs"), "sent_bytes": total("comm.sent_bytes")}


def _tcp_run(p, device, *, label, card, hub_mode, lane, rounds=TCP_ROUNDS, wrap_client=None):
    """One federation of the port's managers over the port's TcpHub: rounds
    of XD_CLIENTS clients; returns its server, round snapshots and the
    numbers [tcp] prints beside [xdevice]'s."""
    import threading

    import numpy as np

    from fedml_tpu_torch.algorithms.fedavg_cross_device import (FedAvgClientManager,
                                                                FedAvgServerManager)
    from fedml_tpu_torch.comm.tcp import TcpBackend, TcpHub
    from fedml_tpu_torch.compress import jax_leaves
    from fedml_tpu_torch.core.tree import host_array
    from fedml_tpu_torch.obs.telemetry import get_telemetry

    kw = {"lane": lane, "shm_data_bytes": TCP_SHM_MIB << 20}
    if lane == "shm":
        # each connection's slab holds two rings of TCP_SHM_MIB; a slab
        # tmpfs cannot back would fault on its first touch, so say so first
        st = os.statvfs("/dev/shm")
        need = 2 * (XD_CLIENTS + 1) * (TCP_SHM_MIB << 20)
        if st.f_bavail * st.f_frsize < need:
            fail(f"tcp {label}: /dev/shm has {st.f_bavail * st.f_frsize} B free, "
                 f"the lanes need {need}")
    hub = TcpHub(mode=hub_mode)
    backends, threads, clients, enc = [], [], [], []
    turn = threading.Lock()
    try:
        for node in range(1, XD_CLIENTS + 1):
            cb = TcpBackend(node, hub.host, hub.port, **kw)
            backends.append(cb)
            c = FedAvgClientManager(cb, p["lu"], p["ds"], batch_size=XD_BATCH,
                                    template_variables=p["init"], seed=0, device=device)
            update = c.local_update

            def in_turn(*a, update=update):
                with turn:
                    return update(*a)

            c.local_update = in_turn
            encode = c._encode_upload

            def timed(*a, encode=encode):
                t0 = time.perf_counter()
                out = encode(*a)
                enc.append(time.perf_counter() - t0)
                return out

            c._encode_upload = timed
            if wrap_client:
                wrap_client(c)
            clients.append(c)
            threads.append(cb.run_in_thread())
        sb = TcpBackend(0, hub.host, hub.port, **kw)
        backends.append(sb)
        server = FedAvgServerManager(sb, p["init"], num_clients=XD_CLIENTS,
                                     clients_per_round=XD_CLIENTS, comm_rounds=rounds, seed=0,
                                     steps_per_epoch=p["steps"], stats_plane=False)
        snaps = _snapshots(server)
        sb.await_peers(range(1, XD_CLIENTS + 1), timeout=60)
        tel = get_telemetry().snapshot()
        reset_launches()
        t0 = time.perf_counter()
        st = sb.run_in_thread()
        server.start()
        st.join(timeout=300)
        wall = time.perf_counter() - t0
        seen = read_launches()
        for t in threads:
            t.join(timeout=30)
        if st.is_alive() or server.round_idx != rounds:
            fail(f"tcp {label}: the federation stopped at round {server.round_idx}")
        hub_stats = hub.stats()
    finally:
        for b in backends:
            b.stop()
        hub.stop()
    closes = [r for r in server.round_log if "participants" in r]
    rounds_s = [r["t_close_m"] - r["t_open_m"] for r in closes]
    timed_s = rounds_s[1:] or rounds_s
    med = sorted(timed_s)[len(timed_s) // 2]
    n_dec, s_dec = _hist_delta(tel["hists"], "span.decode_s")
    n_fold, s_fold = _hist_delta(tel["hists"], "span.agg_fold_s")
    steps = sum(c.rounds_trained for c in clients) * p["steps"]
    wire = _wire_totals(tel["counters"])
    rec = {"hub_mode": hub_mode, "lane": lane, "round_s": rounds_s, "median_round_s": med,
           "uploads_per_s": sum(len(r["participants"]) for r in closes[1:] or closes) / sum(timed_s),
           "encode_ms": 1e3 * sum(enc) / max(len(enc), 1),
           "decode_ms": 1e3 * s_dec / max(n_dec, 1), "fold_ms": 1e3 * s_fold / max(n_fold, 1),
           "wall_s": wall, "client_steps": steps, "launches": seen["conv3x3_mxu"],
           "tc_launches": seen["conv3x3_mxu_tc"], "flash": seen["flash_attention_fwd"],
           **wire, "hub": {k: hub_stats[k] for k in (
               "zero_copy_forwards", "mcast_frames", "mcast_copies", "shm_frames", "shm_bytes",
               "shm_fallbacks", "shm_hub_copies", "dropped_frames", "threads")}}
    per_fwd = rec["launches"] / max(steps, 1)
    print(f"[tcp] {label}: {rounds} rounds x {XD_CLIENTS} clients over the {hub_mode} hub, "
          f"{lane} lane, in {wall:.2f} s; round s {[round(x, 4) for x in rounds_s]}, median "
          f"{med:.4f} s, {rec['uploads_per_s']:.2f} uploads/s; per upload encode "
          f"{rec['encode_ms']:.1f} ms, decode {rec['decode_ms']:.1f} ms, fold "
          f"{rec['fold_ms']:.1f} ms; routed {wire['routed_frames']:.0f} frames / "
          f"{wire['routed_bytes']:.0f} B (sent {wire['sent_frames']:.0f} / "
          f"{wire['sent_bytes']:.0f} B); hub {rec['hub']}; conv3x3_mxu {rec['launches']} "
          f"({rec['tc_launches']} tensor-core) for {steps} client forwards = {per_fwd:.2f} per "
          f"forward ({card})")
    if device == "cuda" and (rec["launches"] != 19 * steps
                             or rec["tc_launches"] != TC_PER_FORWARD * steps):
        fail(f"tcp {label}: conv launches {seen}, expected {19 * steps} "
             f"({TC_PER_FORWARD * steps} tensor-core) for {steps} client forwards")
    if rec["flash"]:
        fail(f"tcp {label}: the ResNet-56 clients launched the flash kernel")
    if rec["hub"]["dropped_frames"]:
        fail(f"tcp {label}: the hub dropped frames {rec['hub']['dropped_frames']}")
    if not all(np.isfinite(host_array(l)).all() for _, l in jax_leaves(server.variables)):
        fail(f"tcp {label}: non-finite global model")
    return server, snaps, rec


def _launch_leaves(out: str) -> tuple:
    """A launch's final leaves (in JAX's order) and round log."""
    import numpy as np

    z = np.load(out)
    return [np.asarray(z[k]) for k in sorted(z.files, key=lambda k: (len(k), k))
            if k.startswith("leaf_")], json.loads(str(z["round_log"]))


def phase_tcp(device: str = "cuda"):
    """The TCP transport of the port on the card.

    1. [xdevice]'s sync federation over the port's TcpHub on loopback three
       ways (reactor hub + tcp lane, reactor + shm lane, threaded + tcp),
       each against the same federation over the InprocBus from the same
       init: round 0's aggregate within XD_ROUND0_TOL, every client's
       round-0 upload frame equal by sha256, a planted fault (client 2's
       sample count doubled, one round over the reactor hub) beyond the gate,
       19 conv launches per client forward (18 tensor-core); a message
       holding a card tensor refused by the backend before any socket;
    2. ``distributed_fedavg.launch()`` as processes on the card: hub,
       server and 3 clients over the shm lane, 2 rounds of its LR problem,
       and beside it the tree (2 muxers behind 2 edge hubs); each within 1e-5 of the
       port's FedAvgSimulation on the card from the same seed, the tree's
       model and upload digests byte for byte the flat run's.

    ``device`` "cpu" rehearses the phase without a card (launch counts are
    0 there, and the launches run their children with ``--device cpu``)."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, FedAvgSimulation
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.comm.tcp import TcpBackend, TcpHub
    from fedml_tpu_torch.compress import jax_leaves
    from fedml_tpu_torch.experiments.distributed_fedavg import _build_problem, launch

    card = smi_line() if device == "cuda" else "cpu"
    rec = {"gpu": card}
    t_phase = time.perf_counter()
    launches = tc = 0

    # a card tensor never reaches a socket: the backend refuses it
    hub = TcpHub()
    try:
        a, b = TcpBackend(1, hub.host, hub.port), TcpBackend(2, hub.host, hub.port)
        a.await_peers([2], timeout=30)
        m = Message("C2S_SEND_MODEL", 1, 2)
        m.add_params("model_params", {"__wiretree__": 2, "leaves": [
            torch.zeros(4, device=device)]})
        try:
            a.send_message(m)
            refused = False
        except TypeError:
            refused = True
        a.stop()
        b.stop()
    finally:
        hub.stop()
    print(f"[tcp] a message holding a {device} tensor refused by TcpBackend: {refused} ({card})")
    if device == "cuda" and not refused:
        fail("tcp: a card tensor reached the TCP backend's socket path")
    rec["device_leaf_refused"] = refused

    with deterministic():
        p = _xd_problem(device)
        ref_frames, ref_snaps = {}, []
        _, _, r_in, _ = _xd_run(p, device, label="in-process reference for [tcp]", card=card,
                                rounds=TCP_ROUNDS,
                                wrap_server=lambda s: ref_snaps.append(_snapshots(s)),
                                wrap_client=_upload_frames(ref_frames))
        launches += r_in["launches"]
        tc += r_in["tc_launches"]
        ref0 = ref_snaps[0][0]
        rec["inproc"] = r_in
        for hub_mode, lane in TCP_MODES:
            frames = {}
            _, snaps, r = _tcp_run(p, device, label=f"{hub_mode} hub, {lane} lane", card=card,
                                   hub_mode=hub_mode, lane=lane,
                                   wrap_client=_upload_frames(frames))
            launches += r["launches"]
            tc += r["tc_launches"]
            gap, leaf = _host_gap(snaps[0], ref0)
            same = frames == ref_frames and len(frames) == XD_CLIENTS
            print(f"[tcp] {hub_mode}/{lane} vs the InprocBus run: round 0 {gap:.3g} ({leaf}; "
                  f"gate {XD_ROUND0_TOL:g}); round-0 upload frames equal by sha256: {same}; "
                  f"median round {r['median_round_s']:.4f} s vs {r_in['median_round_s']:.4f} s "
                  f"in process ({r['median_round_s'] / r_in['median_round_s']:.3f}x); uploads/s "
                  f"{r['uploads_per_s']:.2f} vs {r_in['uploads_per_s']:.2f}; encode/decode/fold "
                  f"ms {r['encode_ms']:.1f}/{r['decode_ms']:.1f}/{r['fold_ms']:.1f} vs "
                  f"{r_in['encode_ms']:.1f}/{r_in['decode_ms']:.1f}/{r_in['fold_ms']:.1f}; "
                  f"frames sync {r_in['sync_frame_bytes']} B, upload {r_in['upload_frame_bytes']} B "
                  f"({card})")
            if gap > XD_ROUND0_TOL:
                fail(f"tcp {hub_mode}/{lane}: round 0 is not the in-process federation's")
            if not same:
                fail(f"tcp {hub_mode}/{lane}: round-0 upload frames differ from the in-process run")
            if lane == "shm" and not r["hub"]["shm_frames"] > 0:
                fail(f"tcp {hub_mode}/{lane}: no frame crossed a shared-memory lane")
            rec[f"{hub_mode}_{lane}"] = {**r, "round0_gap": gap, "upload_frames_equal": same}

        def double_n(client):
            if client.backend.node_id != 2:
                return
            send = client.send_message

            def doubled(msg):
                if msg.type == "C2S_SEND_MODEL":
                    msg.add_params("num_samples", 2.0 * msg.get("num_samples"))
                send(msg)

            client.send_message = doubled

        _, fsnaps, rf = _tcp_run(p, device, label="planted fault (client 2's n doubled)",
                                 card=card, hub_mode="reactor", lane="tcp", rounds=1,
                                 wrap_client=double_n)
        launches += rf["launches"]
        tc += rf["tc_launches"]
        f0 = _host_gap(fsnaps[0], ref0)[0]
        print(f"[tcp] planted fault: round 0 {f0:.3g} from the in-process run (gate "
              f"{XD_ROUND0_TOL:g}) ({card})")
        if not f0 > XD_ROUND0_TOL:
            fail("tcp: the planted fault (a doubled sample count) passed the round-0 gate")
        rec["fault_round0_gap"] = f0

    # -- distributed_fedavg.launch() as processes on the card ------------------------------
    env = dict(os.environ)
    env.pop("FEDML_TPU_FORCE_CPU", None)
    env["OMP_NUM_THREADS"] = "1"
    child_device = "" if device == "cuda" else "cpu"
    ds, bundle, _, _ = _build_problem(0, TCP_LAUNCH["num_clients"], device=device)
    sim = FedAvgSimulation(bundle, ds, FedAvgConfig(
        num_clients=3, clients_per_round=3, comm_rounds=TCP_LAUNCH["rounds"], epochs=1,
        batch_size=16, lr=0.1, seed=0, frequency_of_the_test=100), device=device)
    sim.run()
    want = [np.asarray(l.detach().cpu()) for _, l in jax_leaves(sim.state.variables)]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the flat run and the tree side by side (their children start up
        # at once; each wall time is its own launch() call's)
        topologies = {"flat": {}, "tree": dict(muxers=2, topology="tree", edge_hubs=2)}
        done = {}

        def run_launch(tag):
            info = {}
            t0 = time.perf_counter()
            try:
                rc = launch(out_path=os.path.join(tmp, f"{tag}.npz"), device=child_device,
                            env=env, info=info, timeout=240.0, **TCP_LAUNCH, **topologies[tag])
            except Exception as e:  # reported below, on the phase's thread
                rc = repr(e)
            done[tag] = (rc, info, time.perf_counter() - t0)

        workers = [threading.Thread(target=run_launch, args=(tag,)) for tag in topologies]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=300)
        for tag in topologies:
            if tag not in done or done[tag][0] != 0:
                fail(f"tcp: launch() {tag} did not end with 0: {done.get(tag, ('running',))[0]}")
            _, info, wall = done[tag]
            got, log = _launch_leaves(os.path.join(tmp, f"{tag}.npz"))
            gap = max(float(np.abs(g.astype(np.float64) - w).max()) for g, w in zip(got, want))
            digests = {k: v for k, v in sorted(info.items()) if k.endswith("_upload_digest")}
            edges = {k: {x: v[x] for x in ("folded_uploads", "uplink_frames", "flat_fallbacks")}
                     for k, v in info.items() if k.startswith("edge_") and k.endswith("_stats")}
            hub_stats = info.get("hub_stats", {})
            runs[tag] = {"wall_s": wall, "gap": gap, "leaves": got, "digests": digests,
                         "participants": [r.get("participants") for r in log],
                         "hub_stats": hub_stats, "edges": edges}
            print(f"[tcp] launch() {tag}: hub, server, {len(digests)} clients"
                  f"{' on 2 muxers behind 2 edge hubs' if tag == 'tree' else ''}, shm lane, "
                  f"{TCP_LAUNCH['rounds']} rounds in {wall:.2f} s (flat and tree side by "
                  f"side); max |Δ| against FedAvgSimulation on {device} {gap:.3g} (gate 1e-5); "
                  f"participants {runs[tag]['participants']}; hub {hub_stats}; edges {edges} "
                  f"({card})")
            if gap > 1e-5 or len(got) != len(want):
                fail(f"tcp: launch() {tag} is not the simulation")
            if any(sorted(r or []) != [1, 2, 3] for r in runs[tag]["participants"]):
                fail(f"tcp: launch() {tag} rounds missed a client")
            if not hub_stats.get("shm_frames"):
                fail(f"tcp: launch() {tag} moved no frame through a shared-memory lane")
    tree_same = (runs["tree"]["digests"] == runs["flat"]["digests"]
                 and len(runs["flat"]["digests"]) == 3
                 and all(np.array_equal(a, b) for a, b in
                         zip(runs["tree"]["leaves"], runs["flat"]["leaves"])))
    print(f"[tcp] tree == flat byte for byte (upload digests and final model): {tree_same} "
          f"({card})")
    if not tree_same:
        fail("tcp: the tree topology is not the flat one byte for byte")
    edges = runs["tree"]["edges"].values()
    if (len(edges) != 2 or any(e["flat_fallbacks"] or not e["folded_uploads"] for e in edges)
            or sum(e["folded_uploads"] for e in edges) != 3 * TCP_LAUNCH["rounds"]):
        fail(f"tcp: the edge hubs did not fold their cohorts {runs['tree']['edges']}")
    for tag, r in runs.items():
        rec[f"launch_{tag}"] = {k: v for k, v in r.items() if k != "leaves"}
    rec["launches"] = launches
    rec["tc_launches"] = tc
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[tcp] phase time: {rec['phase_s']:.1f} s; conv3x3_mxu launches {launches} "
          f"({tc} tensor-core) ({card})")
    return rec

# [mesh]: FedAvg over a clients mesh (fedml_tpu_torch/parallel/): the main
# path's round on a 1-rank NCCL mesh (NCCL refuses two ranks on one card),
# ResNet-56 at full width on the conv kernel, bf16, [main]'s optimizer,
# MESH_CLIENTS clients x 2 steps of MESH_BATCH, against make_round_fn from the
# same state and block, byte for byte; the two-tier round on a 1 x 1
# (group, clients) mesh and the compiled template round against their host
# forms; then MESH_RANKS gloo ranks sharing the card run the small-model
# cases of parallel/dryrun.py (a dp round within MESH_ULPS float32 spacings of
# its one-device round, as tests/test_torch_spmd.py; the gossip's dense SPMD
# form against the dense round).  gloo takes card tensors for all_reduce,
# broadcast and all_gather; its send/recv do not (they write the device
# pointer to a socket and the rank aborts; PERF.md §6), so compat.ppermute
# stages card buffers through host memory under gloo ([sp] runs the K/V ring
# so)
MESH_CLIENTS, MESH_BATCH, MESH_SAMPLES, MESH_GROUP_ROUNDS = 4, 64, 128, 2
MESH_RANKS, MESH_ULPS, MESH_TIER_TOL, MESH_GOSSIP_TOL = 2, 8, 1e-6, 1e-5
MESH_LR = dict(data=dict(num_train=600, num_test=100, input_shape=(12,), num_classes=4,
                         num_clients=2 * MESH_RANKS, partition="hetero",
                         partition_alpha=0.5, seed=0),
               model=("lr", 12, 4), opt=dict(name="sgd", lr=0.2), epochs=2, batch=16)
MESH_GOSSIP = dict(data=dict(num_train=MESH_RANKS * 50, num_test=16, input_shape=(8,),
                             num_classes=2, num_clients=MESH_RANKS, partition="homo",
                             seed=0),
                   model=("lr", 8, 2), opt=dict(name="sgd", lr=0.1), epochs=1, batch=16,
                   init_key=0, rng_key=1, ring=False, reference=True)


def _ulp_gap(got: dict, want: dict) -> float:
    """The largest |Δ| of any leaf in float32 spacings of that leaf's
    largest magnitude (numpy trees)."""
    import numpy as np

    worst = 0.0
    for c in want:
        for k, w in want[c].items():
            w = np.asarray(w, np.float32)
            ulp = np.spacing(np.float32(max(np.abs(w).max(), np.finfo(np.float32).tiny)))
            worst = max(worst, float(np.abs(np.asarray(got[c][k], np.float32) - w).max() / ulp))
    return worst


class RankPart(NamedTuple):
    """A phase's share of one gloo launch of ranks sharing the card.
    ``body(spec)`` runs on each of ``ranks`` ranks (a module-level function:
    the launch pickles it by name); ``check(results, wall, extra_s)`` then
    applies the phase's gates in this process to the ranks' results, given
    the launch's wall seconds and the ranks' seconds in the other parts;
    ``cleanup()`` runs after the launch, whatever happened."""
    name: str
    ranks: int
    body: Callable
    spec: Any
    check: Callable
    cleanup: Optional[Callable] = None


def shared_rank_body(parts: list) -> dict:
    """Rank body of a shared launch: each ``(name, body, spec)`` of
    ``parts`` in turn, with its seconds on this rank."""
    import torch

    out, seconds = {}, {}
    for name, body, spec in parts:
        t0 = time.perf_counter()
        out[name] = body(spec)
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()  # (a no-op where the part used no card)
    return {"parts": out, "seconds": seconds}


def launch_shared(parts: list, device: str = "cuda") -> None:
    """One gloo launch for every ``RankPart`` of ``parts`` (the multi-rank
    phases pay one rank start-up, 9-11 s on the card), then each part's
    check."""
    from fedml_tpu_torch.parallel.compat import launch

    counts = {p.ranks for p in parts}
    if len(counts) != 1:
        raise ValueError(f"the shared launch's parts want {counts} ranks")
    t0 = time.perf_counter()
    try:
        ranks = launch(shared_rank_body, counts.pop(), [(p.name, p.body, p.spec) for p in parts],
                       device=device, backend="gloo", timeout=900.0)
    finally:
        for p in parts:
            if p.cleanup is not None:
                p.cleanup()
    wall = time.perf_counter() - t0
    for p in parts:
        others = max(sum(v for k, v in r["seconds"].items() if k != p.name) for r in ranks)
        p.check([r["parts"][p.name] for r in ranks], wall, others)


def _hand_over(part: RankPart, shared: Optional[list], device: str, card: str) -> None:
    """Launch a phase's ranks now, or leave them to the launch that
    ``shared`` collects for."""
    if shared is None:
        launch_shared([part], device)
    else:
        shared.append(part)
        print(f"[{part.name}] the {part.ranks} gloo ranks' part runs in the shared launch "
              f"({card})")


def mesh_rank_cases(device: str) -> list:
    """[mesh]'s part 3: its cases for the gloo ranks sharing the card."""
    return [("spmd", {**MESH_LR, "device": device, "single": True}),
            ("gossip", {**MESH_GOSSIP, "device": device})]


def check_mesh_ranks(ranks, wall: float, rec: dict, device: str, card: str,
                     extra_s: float = 0.0) -> None:
    """[mesh]'s part 3 gates over each rank's ``run_cases(mesh_rank_cases)``
    results; ``extra_s`` is the ranks' other work in a shared launch."""
    import numpy as np

    body = max(sum(case["seconds"] for case in r) for r in ranks)
    dp_ulps = max(_ulp_gap(r[0]["variables"], ranks[0][0]["single"]["variables"])
                  for r in ranks)
    replicated = all(_ulp_gap(r[0]["variables"], ranks[0][0]["variables"]) == 0.0
                     for r in ranks)
    gossip_gap = max(
        float(np.abs(np.asarray(r[1]["variables"][c][k])
                     - np.asarray(ranks[0][1]["reference"][c][k])[i]).max())
        for i, r in enumerate(ranks) for c in r[1]["variables"] for k in r[1]["variables"][c])
    startup = wall - body - extra_s
    rec.update(ranks=MESH_RANKS, launch_s=wall, rank_body_s=body, startup_s=startup,
               dp_ulps=dp_ulps, gossip_gap=gossip_gap)
    print(f"[mesh] {MESH_RANKS} gloo ranks on {device} ({ranks[0][0]['mesh']['platform']} "
          f"mesh): launch {wall:.2f} s, the ranks' own work {body:.2f} s (+ {extra_s:.2f} s "
          f"of [sp]'s), start-up and teardown {startup:.2f} s; dp round of lr over "
          f"{2 * MESH_RANKS} clients vs its one-device "
          f"round {dp_ulps:.3g} float32 spacings (gate {MESH_ULPS}), every rank the same "
          f"bytes {replicated}; gossip dense SPMD form vs the dense round max |Δ| "
          f"{gossip_gap:.3g} "
          f"(gate {MESH_GOSSIP_TOL}) ({card})")
    if dp_ulps > MESH_ULPS or not replicated:
        fail("mesh: the multi-rank dp round disagrees with its one-device round")
    if gossip_gap > MESH_GOSSIP_TOL:
        fail("mesh: the multi-rank gossip disagrees with the dense round")


def phase_mesh(device: str = "cuda", shared: Optional[list] = None):
    """FedAvg over a clients mesh of the port (``parallel/``) on the card.

    1. the main path on a 1-rank NCCL ``(clients, model)`` mesh: one round
       of ``make_spmd_round_fn`` over ResNet-56 (full width, every 3x3 conv
       on the kernel, bf16, SGD lr 1e-3 momentum 0.9 wd 1e-3), 4 clients x 2
       steps of 64, equal byte for byte to ``make_round_fn`` on the card from
       the same state and block (cuDNN deterministic); 19 conv launches per
       client forward, 18 tensor-core; ``describe_mesh`` reads ``cuda``; the
       two rounds timed in turns;
    2. the two-tier round on a 1 x 1 ``(group, clients)`` mesh against
       ``HierarchicalSimulation.run_round`` (2 in-group rounds, the same
       model), within MESH_TIER_TOL of each leaf's scale; the compiled
       template round against ``run_base_framework``;
    3. MESH_RANKS ranks in one gloo group, every tensor on the card: the dp
       round of a logistic regression over 4 clients against its one-device
       round (rank 0), within MESH_ULPS float32 spacings, every rank holding
       the same bytes; the gossip's dense SPMD form (``all_gather`` and the
       rank's row of the ring matrix) against the dense round within
       MESH_GOSSIP_TOL; the ranks' start-up seconds.  Given a ``shared``
       list, these cases join it as a ``RankPart`` for ``launch_shared``,
       which pays one start-up for every multi-rank phase.

    ``device`` "cpu" rehearses the phase on gloo (launch counts are 0)."""
    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.base_framework import (make_compiled_round,
                                                           run_base_framework)
    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, ServerState, make_round_fn
    from fedml_tpu_torch.algorithms.hierarchical import HierarchicalSimulation
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.core.types import cohort_steps_per_epoch, pack_clients
    from fedml_tpu_torch.data.cifar import load_cifar10
    from fedml_tpu_torch.experiments.registry import shrink_dataset
    from fedml_tpu_torch.models.resnet_tpu import resnet56_tpu
    from fedml_tpu_torch.parallel.compat import single_rank_group
    from fedml_tpu_torch.parallel.dryrun import run_cases
    from fedml_tpu_torch.parallel.mesh import describe_mesh
    from fedml_tpu_torch.parallel.spmd import (hierarchical_pack, make_1d_mesh,
                                               make_client_mesh, make_group_mesh,
                                               make_hierarchical_spmd_round_fn,
                                               make_spmd_round_fn, replicate,
                                               shard_client_block)

    card = smi_line() if device == "cuda" else "cpu"
    rec = {"gpu": card}
    t_phase = time.perf_counter()

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    ds = shrink_dataset(load_cifar10(num_clients=MESH_CLIENTS, partition="hetero",
                                     partition_alpha=0.5, seed=0), MESH_SAMPLES, 64)
    bundle = resnet56_tpu(conv_variant="kernel", device=device)
    opt = make_client_optimizer("sgd", 0.001, momentum=0.9, weight_decay=1e-3)
    lu = make_local_update(bundle, opt, epochs=1, compute_dtype=torch.bfloat16)
    steps = cohort_steps_per_epoch(ds, MESH_BATCH)
    pack = pack_clients(ds, list(range(MESH_CLIENTS)), MESH_BATCH, steps_per_epoch=steps,
                        seed=0)
    raw = (pack.x, pack.y, pack.mask, pack.num_samples,
           np.ones(MESH_CLIENTS, np.float32), np.arange(MESH_CLIENTS, dtype=np.int32))
    key = PRNGKey(0)
    fwd = MESH_CLIENTS * steps
    launches = tc = 0
    with deterministic(), single_rank_group(device):
        mesh = make_client_mesh(device=device)
        rec["mesh"] = describe_mesh(mesh)
        print(f"[mesh] describe_mesh: {json.dumps(rec['mesh'])} ({card})")
        if rec["mesh"]["platform"] != device:
            fail(f"mesh: the clients mesh is on {rec['mesh']['platform']}, not {device}")
        block = shard_client_block(mesh, raw)
        state0 = replicate(mesh, ServerState(bundle.init(key), (), 0, key))
        spmd = make_spmd_round_fn(mesh, lu)
        plain = make_round_fn(lu, device=device)
        plain(state0, *block)  # warm-up
        sync()
        times = {"spmd": [], "plain": []}
        out = {}
        for turn, name in enumerate(("spmd", "plain", "plain", "spmd")):
            fn = spmd if name == "spmd" else plain
            if turn == 0:
                reset_launches()
            t0 = time.perf_counter()
            state, metrics = fn(state0, *block)
            sync()
            times[name].append(time.perf_counter() - t0)
            if turn == 0:
                seen = read_launches()
                launches, tc = seen["conv3x3_mxu"], seen["conv3x3_mxu_tc"]
            out.setdefault(name, (state, metrics))
        (got, gm), (want, wm) = out["spmd"], out["plain"]
        same = _same_tensors(got.variables, want.variables) and _same_tensors(gm, wm)
        loss = float(gm["loss_sum"]) / max(float(gm["count"]), 1.0)
        rec.update(spmd_round_s=times["spmd"], plain_round_s=times["plain"],
                   bytewise_equal=same, loss=loss, launches=launches, tc_launches=tc)
        print(f"[mesh] resnet56_tpu (kernel convs, bf16) on a 1-rank {device} clients mesh, "
              f"{MESH_CLIENTS} clients x {steps} steps of {MESH_BATCH}: spmd round s "
              f"{[round(t, 4) for t in times['spmd']]}, make_round_fn round s "
              f"{[round(t, 4) for t in times['plain']]} (in turns spmd, plain, plain, spmd; "
              f"median ratio {np.median(times['spmd']) / np.median(times['plain']):.3f}); "
              f"loss {loss:.4f}; equal byte for byte {same}; conv3x3_mxu launches "
              f"{launches} ({tc} tensor-core) for {fwd} forwards ({card})")
        if not same:
            fail("mesh: the 1-rank SPMD round is not make_round_fn's byte for byte")
        if not math.isfinite(loss):
            fail(f"mesh: non-finite loss {loss}")
        if device == "cuda" and (launches != 19 * fwd or tc != TC_PER_FORWARD * fwd):
            fail(f"mesh: conv launches {launches} ({tc} tensor-core), expected "
                 f"{19 * fwd} ({TC_PER_FORWARD * fwd})")

        cfg = FedAvgConfig(num_clients=MESH_CLIENTS, clients_per_round=MESH_CLIENTS,
                           comm_rounds=1, epochs=1, batch_size=MESH_BATCH, lr=0.001,
                           momentum=0.9, weight_decay=1e-3, seed=0, compute_dtype="bf16")
        sim = HierarchicalSimulation(bundle, ds, cfg, num_groups=1,
                                     group_comm_round=MESH_GROUP_ROUNDS, local_update=lu,
                                     device=device)
        gmesh = make_group_mesh(1, device=device)
        hblock, hids = hierarchical_pack(ds, sim.groups, MESH_BATCH, sim.steps_per_epoch,
                                         sim.cfg.seed)
        hargs = shard_client_block(gmesh, (*hblock, np.ones(len(hids), np.float32),
                                           np.asarray(hids, np.int32)), ("group", "clients"))
        hier = make_hierarchical_spmd_round_fn(gmesh, lu, group_comm_round=MESH_GROUP_ROUNDS)
        reset_launches()
        t0 = time.perf_counter()
        hstate, hm = hier(replicate(gmesh, sim.state), *hargs)
        sync()
        hier_s = time.perf_counter() - t0
        seen = read_launches()
        launches += seen["conv3x3_mxu"]
        tc += seen["conv3x3_mxu_tc"]
        t0 = time.perf_counter()
        host = sim.run_round()
        sync()
        host_s = time.perf_counter() - t0
        gap, leaf = _host_gap(hstate.variables, sim.state.variables)
        hfwd = MESH_GROUP_ROUNDS * fwd
        print(f"[mesh] two-tier round on a 1 x 1 (group, clients) mesh, {MESH_GROUP_ROUNDS} "
              f"in-group rounds: {hier_s:.3f} s vs HierarchicalSimulation.run_round "
              f"{host_s:.3f} s; max |Δ| / max(1, max |leaf|) {gap:.3g} ({leaf}; gate "
              f"{MESH_TIER_TOL}); count {float(hm['count'])} vs {host['count']}; conv3x3_mxu "
              f"launches {seen['conv3x3_mxu']} ({seen['conv3x3_mxu_tc']} tensor-core) for "
              f"{hfwd} forwards ({card})")
        if gap > MESH_TIER_TOL or float(hm["count"]) != host["count"]:
            fail(f"mesh: the two-tier SPMD round is {gap:.3g} from the host simulation's")
        if device == "cuda" and (seen["conv3x3_mxu"] != 19 * hfwd
                                 or seen["conv3x3_mxu_tc"] != TC_PER_FORWARD * hfwd):
            fail(f"mesh: two-tier conv launches {seen}, expected {19 * hfwd}")
        history = make_compiled_round(make_1d_mesh(axis="clients", device=device))(8, 4)
        series = run_base_framework(8, 4)
        print(f"[mesh] compiled template round (8 clients, 4 rounds) on the 1-rank mesh: "
              f"{history.tolist()} vs the message form {series} ({card})")
        if not np.allclose(history, series, rtol=1e-6):
            fail("mesh: the compiled template round disagrees with the message form")
        rec.update(hier_s=hier_s, host_hier_s=host_s, hier_gap=gap,
                   compiled=history.tolist())

    # several ranks on the one card: one gloo group, every tensor on the card
    _hand_over(RankPart("mesh", MESH_RANKS, run_cases, mesh_rank_cases(device),
                        lambda ranks, wall, extra: check_mesh_ranks(ranks, wall, rec, device,
                                                                    card, extra_s=extra)),
               shared, device, card)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[mesh] phase time: {rec['phase_s']:.1f} s; conv3x3_mxu launches {launches} "
          f"({tc} tensor-core) ({card})")
    rec.update(launches=launches, tc_launches=tc)
    return rec


# [sp]: ring attention and sequence parallelism (fedml_tpu_torch/parallel/
# {ring_attention,sequence,dp_sp}.py) at the fedllm bench width with 2,048
# tokens a sequence: part 1 on a 1-rank NCCL (clients, sp) mesh, part 2 on
# SP_RANKS gloo ranks sharing the card (1,024 tokens a shard), the K/V ring
# staged through host memory.  SP_LM_TOL is the CPU tests' tolerance for the
# sequence-parallel LM (tests/test_torch_ring_attention.py: 3e-4, where the
# CPU's gap is ~1e-6); SP_ROUND_TOL bounds ||θ_ring − θ_1rank|| /
# ||θ_1rank − θ_0|| of the bf16 round (a wrong psum or ppermute transpose
# puts it at ~1 or more)
SP_DIMS = dict(vocab_size=8192, embed_dim=1280, num_heads=10, num_layers=12)
SP_L, SP_STEPS, SP_BATCH, SP_LM_BATCH, SP_LR = 2048, 2, 8, 2, 3e-4
SP_RANKS, SP_LM_TOL, SP_ROUND_TOL, SP_LOSS_RTOL = 2, 3e-4, 0.05, 1e-2


def _sp_geometry() -> dict:
    """[sp]'s sizes, handed to its ranks whole (a rehearsal shrinks them)."""
    return dict(dims=SP_DIMS, L=SP_L, steps=SP_STEPS, batch=SP_BATCH,
                lm_batch=SP_LM_BATCH, lr=SP_LR, ranks=SP_RANKS)


def _sp_problem(g: dict):
    """The DP×SP block (1 client x ``steps`` x ``batch`` sequences of ``L``
    tokens) and the fp32 forward's tokens, from numpy seeds 0 and 1."""
    import numpy as np

    v, L, steps, batch = g["dims"]["vocab_size"], g["L"], g["steps"], g["batch"]
    toks = np.random.RandomState(0).randint(0, v, (1, steps, batch, L)).astype(np.int32)
    data = (toks, np.roll(toks, -1, axis=-1), np.ones((1, steps, batch), np.float32),
            np.full((1,), steps * batch * L, np.float32), np.ones(1, np.float32),
            np.arange(1, dtype=np.int32))
    lm = np.random.RandomState(1).randint(0, v, (g["lm_batch"], L)).astype(np.int32)
    return data, lm


def _digest(variables: dict) -> str:
    """sha256 over a variables tree's names and raw bytes."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for c in sorted(variables):
        for k in sorted(variables[c]):
            h.update(k.encode())
            leaf = variables[c][k].detach().cpu().contiguous().view(-1)
            h.update(leaf.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _sp_rank(spec: dict) -> dict:
    """[sp]'s part 2 on one of SP_RANKS gloo ranks: the fp32
    sequence-parallel LM forward against part 1's 1-rank forward, the bf16
    DP×SP round against part 1's round, and ``run.main --sp_degree``; each
    with its seconds, this rank's flash launches and the bytes the ring
    staged through the host."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from fedml_tpu_torch.algorithms.fedavg import ServerState
    from fedml_tpu_torch.core.client import make_client_optimizer
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.experiments import run
    from fedml_tpu_torch.parallel.compat import ppermute
    from fedml_tpu_torch.parallel.dp_sp import make_dp_sp_mesh, make_dp_sp_round_fn
    from fedml_tpu_torch.parallel.sequence import make_sequence_mesh, sequence_parallel_lm

    t_rank = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = spec["device"]

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def measured(fn):
        reset_launches()
        ppermute.staged_bytes = 0
        t0 = time.perf_counter()
        out = fn()
        sync()
        seen = read_launches()
        return out, {"s": time.perf_counter() - t0, "staged_bytes": ppermute.staged_bytes,
                     "flash": seen["flash_attention_fwd"],
                     "wgmma": seen["flash_attention_fwd_wgmma"]}

    g = spec["geometry"]
    data, lm_tokens = _sp_problem(g)
    ref = torch.load(spec["ref"], map_location=device)
    key = PRNGKey(0)
    out = {"rank": dist.get_rank()}
    mesh = make_sequence_mesh(device=device)
    _, init, apply = sequence_parallel_lm(mesh, **g["dims"], max_len=g["L"],
                                          attn_impl="flash")
    state0 = ServerState(init(key), (), 0, key)
    logits, out["lm"] = measured(lambda: apply(state0.variables, torch.from_numpy(lm_tokens)))
    want = ref.pop("logits")
    out["lm"].update(
        gap=float((logits - want).abs().max()), scale=float(want.abs().max()),
        within=bool(torch.isclose(logits, want, rtol=SP_LM_TOL, atol=SP_LM_TOL).all()),
        finite=bool(torch.isfinite(logits).all()))
    del logits, want

    dp_mesh = make_dp_sp_mesh(1, g["ranks"], device=device)
    round_fn, shard_data, _ = make_dp_sp_round_fn(
        dp_mesh, **g["dims"], max_len=g["L"], optimizer=make_client_optimizer("sgd", g["lr"]),
        compute_dtype=torch.bfloat16, attn_impl="flash")
    block = shard_data(data)
    (state, metrics), out["round"] = measured(lambda: round_fn(state0, *block))
    num = den = 0.0
    for k, new in state.variables["params"].items():
        old, want = state0.variables["params"][k], ref["params"][k]
        num += float((new.double() - want.double()).square().sum())
        den += float((want.double() - old.double()).square().sum())
    out["round"].update(gap=(num / max(den, 1e-300)) ** 0.5,
                        loss=float(metrics["loss_sum"]) / max(float(metrics["count"]), 1.0),
                        loss_gap=abs(float(metrics["loss_sum"]) - ref["loss_sum"])
                        / abs(ref["loss_sum"]),
                        digest=_digest(state.variables))
    del state, state0, ref, block
    if device == "cuda":
        torch.cuda.empty_cache()

    run_dir = os.path.join(spec["run_dir"], f"rank{dist.get_rank()}")
    argv = ["--algorithm", "fedllm", "--dataset", "fed_shakespeare", "--sp_degree",
            str(g["ranks"]), "--comm_round", "1", "--run_dir", run_dir]
    res, out["run"] = measured(lambda: run.main(
        [*argv, *(["--device", "cpu"] if device == "cpu" else [])]))
    out["run"].update(history=res["history"], mesh=res["mesh"])
    out["seconds"] = time.perf_counter() - t_rank
    return out


def phase_sp(device: str = "cuda", shared: Optional[list] = None):
    """Ring attention and sequence parallelism on the card (``parallel/
    {ring_attention,sequence,dp_sp}.py``) at the fedllm bench width
    (SP_DIMS, bf16 rounds, SGD SP_LR), 2,048 tokens a sequence.

    1. a 1-rank NCCL ``(clients, sp)`` mesh: one ``make_dp_sp_round_fn``
       round (flash ring; 1 client x SP_STEPS steps of SP_BATCH) equal byte
       for byte to ``make_round_fn`` over the plain ``transformer_lm`` from
       the same state and block, the two timed in turns (ring, plain,
       plain, ring); 12 flash launches per forward, all wgmma; then the fp32
       forward of ``sequence_parallel_lm`` (flash) over SP_LM_BATCH full
       sequences, and the round's variables, kept for part 2;
    2. SP_RANKS gloo ranks sharing the card (in ``launch_shared``'s launch
       when given a ``shared`` list), every tensor on the card and the K/V
       ring staged through the host: the fp32 sequence-parallel forward
       within SP_LM_TOL of part 1's; the bf16 DP×SP round (1 client x 2
       shards of 1,024) within SP_ROUND_TOL of part 1's round (relative to
       its update) and its loss within SP_LOSS_RTOL, every rank holding the
       same bytes; ``run.main`` fedllm with ``--sp_degree 2`` (the lax ring at
       run.py's widths; its evaluation runs the flash op on the card);
       per rank the flash launches (2 per layer per forward: the resident
       shard and one from the ring), the bytes staged and the seconds.

    ``device`` "cpu" rehearses the phase on gloo (launch counts are 0)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.fedavg import ServerState, make_round_fn
    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.models.transformer import transformer_lm
    from fedml_tpu_torch.parallel.compat import single_rank_group
    from fedml_tpu_torch.parallel.dp_sp import make_dp_sp_mesh, make_dp_sp_round_fn
    from fedml_tpu_torch.parallel.sequence import make_sequence_mesh, sequence_parallel_lm

    card = smi_line() if device == "cuda" else "cpu"
    rec = {"gpu": card}
    t_phase = time.perf_counter()
    layers = SP_DIMS["num_layers"]

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    data, lm_tokens = _sp_problem(_sp_geometry())
    key = PRNGKey(0)
    opt = make_client_optimizer("sgd", SP_LR)
    tmp = tempfile.mkdtemp(prefix="fedml_sp_")
    ref_path = os.path.join(tmp, "reference.pt")
    try:
        with single_rank_group(device):
            mesh = make_dp_sp_mesh(1, 1, device=device)
            ring_round, shard_data, init_fn = make_dp_sp_round_fn(
                mesh, **SP_DIMS, max_len=SP_L, optimizer=opt, compute_dtype=torch.bfloat16,
                attn_impl="flash")
            plain = make_round_fn(make_local_update(
                transformer_lm(**SP_DIMS, seq_len=SP_L, device=device), opt, 1,
                compute_dtype=torch.bfloat16), device=device)
            t0 = time.perf_counter()
            state0 = ServerState(init_fn(key), (), 0, key)
            block = shard_data(data)
            for warm in (plain, ring_round):
                warm(state0, *block)
            sync()
            setup_s = time.perf_counter() - t0
            times = {"ring": [], "plain": []}
            out = {}
            for turn, name in enumerate(("ring", "plain", "plain", "ring")):
                fn = ring_round if name == "ring" else plain
                if turn == 0:
                    reset_launches()
                t0 = time.perf_counter()
                state, metrics = fn(state0, *block)
                sync()
                times[name].append(time.perf_counter() - t0)
                if turn == 0:
                    seen = read_launches()
                out.setdefault(name, (state, metrics))
            (got, gm), (want, wm) = out["ring"], out["plain"]
            same = _same_tensors(got.variables, want.variables) and _same_tensors(gm, wm)
            loss = float(gm["loss_sum"]) / max(float(gm["count"]), 1.0)
            fwd = SP_STEPS
            launches, wgmma = seen["flash_attention_fwd"], seen["flash_attention_fwd_wgmma"]
            rec.update(setup_s=setup_s, ring_round_s=times["ring"], plain_round_s=times["plain"],
                       bytewise_equal=same, loss=loss, launches=launches, wgmma=wgmma)
            print(f"[sp] make_dp_sp_round_fn (flash ring) on a 1-rank {device} (clients, sp) "
                  f"mesh, width {SP_DIMS['embed_dim']}, {layers} layers, L {SP_L}, 1 client x "
                  f"{SP_STEPS} steps of {SP_BATCH}, bf16: set-up {setup_s:.2f} s; ring round s "
                  f"{[round(t, 4) for t in times['ring']]}, make_round_fn round s "
                  f"{[round(t, 4) for t in times['plain']]} (in turns ring, plain, plain, ring; "
                  f"median ratio {np.median(times['ring']) / np.median(times['plain']):.3f}); "
                  f"loss {loss:.4f}; equal byte for byte {same}; flash launches {launches} "
                  f"({wgmma} wgmma) for {fwd} forwards ({card})")
            if not same:
                fail("sp: the 1-rank DP×SP round is not make_round_fn's byte for byte")
            if not math.isfinite(loss):
                fail(f"sp: non-finite loss {loss}")
            if device == "cuda" and (launches != layers * fwd or wgmma != layers * fwd):
                fail(f"sp: flash launches {launches} ({wgmma} wgmma), expected "
                     f"{layers * fwd}, all wgmma")
            _, _, apply = sequence_parallel_lm(make_sequence_mesh(device=device), **SP_DIMS,
                                               max_len=SP_L, attn_impl="flash")
            logits = apply(state0.variables, torch.from_numpy(lm_tokens))
            torch.save({"logits": logits.cpu(), "loss_sum": float(gm["loss_sum"]),
                        "params": {k: v.cpu() for k, v in got.variables["params"].items()}},
                       ref_path)
            del state0, block, out, got, want, state, logits
        if device == "cuda":
            torch.cuda.empty_cache()
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[sp] part 1 phase time {rec['phase_s']:.1f} s ({card})")
    _hand_over(RankPart("sp", SP_RANKS, _sp_rank,
                        dict(device=device, ref=ref_path, run_dir=tmp, geometry=_sp_geometry()),
                        lambda ranks, wall, extra: check_sp_ranks(ranks, wall, rec, device, card,
                                                                  extra_s=extra),
                        functools.partial(shutil.rmtree, tmp, ignore_errors=True)),
               shared, device, card)
    return rec


def check_sp_ranks(sp, wall: float, rec: dict, device: str, card: str,
                   extra_s: float = 0.0) -> None:
    """[sp]'s part-2 gates over each rank's ``_sp_rank`` result; adds the
    ranks' flash launches to the record; ``extra_s`` is the ranks' other
    work in a shared launch."""
    layers = SP_DIMS["num_layers"]
    for x in sp:
        lm, rnd, run_ = x["lm"], x["round"], x["run"]
        print(f"[sp] rank {x['rank']} of {SP_RANKS} gloo ranks on {device}: "
              f"sequence_parallel_lm (flash, fp32, {SP_LM_BATCH} x {SP_L}) {lm['s']:.3f} s, "
              f"max |Δ| {lm['gap']:.3g} vs the 1-rank forward (max |logit| "
              f"{lm['scale']:.3g}, within {SP_LM_TOL}: {lm['within']}), flash launches "
              f"{lm['flash']} ({lm['wgmma']} wgmma), staged {lm['staged_bytes']} B; "
              f"DP×SP round (flash, bf16) {rnd['s']:.3f} s, ||Δθ|| / ||update|| vs part 1 "
              f"{rnd['gap']:.3g} (gate {SP_ROUND_TOL}), loss {rnd['loss']:.4f} (rel. gap "
              f"{rnd['loss_gap']:.3g}), flash launches {rnd['flash']} ({rnd['wgmma']} wgmma), "
              f"staged {rnd['staged_bytes']} B; run.main --sp_degree {SP_RANKS} "
              f"{run_['s']:.3f} s, mesh {run_['mesh']}, flash launches {run_['flash']} "
              f"({run_['wgmma']} wgmma), staged {run_['staged_bytes']} B, final "
              f"{json.dumps({k: run_['history'][-1][k] for k in ('train_loss', 'test_loss')})} "
              f"({card})")
        if not (lm["within"] and lm["finite"]):
            fail(f"sp: rank {x['rank']}'s sequence-parallel forward is {lm['gap']:.3g} from "
                 "the 1-rank forward")
        if not (rnd["gap"] <= SP_ROUND_TOL and rnd["loss_gap"] <= SP_LOSS_RTOL):
            fail(f"sp: rank {x['rank']}'s DP×SP round is {rnd['gap']:.3g} of the update "
                 f"(loss {rnd['loss_gap']:.3g}) from the 1-rank round")
        if device == "cuda" and (lm["flash"] != SP_RANKS * layers or rnd["flash"] != SP_RANKS
                                 * layers * SP_STEPS or rnd["wgmma"] != rnd["flash"]):
            fail(f"sp: rank {x['rank']}'s flash launches {lm['flash']} (forward), "
                 f"{rnd['flash']} ({rnd['wgmma']} wgmma, round): expected "
                 f"{SP_RANKS * layers}, {SP_RANKS * layers * SP_STEPS} all wgmma")
        if not all(math.isfinite(run_["history"][-1][k]) for k in ("train_loss", "test_loss")):
            fail(f"sp: run.main --sp_degree gave non-finite metrics {run_['history'][-1]}")
    if len({x["round"]["digest"] for x in sp}) != 1:
        fail("sp: the ranks' DP×SP rounds do not hold the same bytes")
    if any(x["run"]["history"] != sp[0]["run"]["history"] for x in sp):
        fail("sp: the ranks' run.main histories differ")
    body = max(x["seconds"] for x in sp)
    rec.update(ranks=sp, launch_s=wall, rank_sp_s=body,
               flash_launches=rec["launches"] + sum(x[p]["flash"] for x in sp
                                                    for p in ("lm", "round", "run")),
               flash_wgmma_launches=rec["wgmma"] + sum(x[p]["wgmma"] for x in sp
                                                       for p in ("lm", "round", "run")),
               staged_bytes_per_round=[x["round"]["staged_bytes"] for x in sp])
    print(f"[sp] {SP_RANKS}-rank gloo launch {wall:.2f} s ([sp]'s work {body:.2f} s a rank, "
          f"the other parts' {extra_s:.2f} s); flash launches {rec['flash_launches']} "
          f"({rec['flash_wgmma_launches']} wgmma); bytes staged through the host per "
          f"DP×SP round {rec['staged_bytes_per_round']} ({card})")


# [tp]: tensor parallelism and rule-driven sharding (fedml_tpu_torch/parallel/
# {tensor,gspmd,partition}.py, compress/sharded.py) at the fedllm bench width:
# part 1 on 1-rank NCCL meshes in process, part 2 on TP_RANKS gloo ranks
# sharing the card (in the multi-rank phases' shared launch).  TP_LM_TOL is [sp]'s
# limit for a sharded fp32 forward (the CPU tests hold the TP forward to 1e-4,
# where the CPU's gap is ~2e-6); TP_ROUND_TOL bounds ||θ_tp − θ_1rank|| /
# ||θ_1rank − θ_0|| of the bf16 round (a wrong conjugate operator puts it at
# ~1 or more).  TP_SPREAD_TOL bounds the spread of the ranks' own gradients
# of the replicated leaves before their mean over the model axis
# (tensor.REPLICA_SPREAD, relative to each leaf's largest): 0 where the ranks
# agree, a few bf16 spacings at most should a card kernel's sums differ in
# their last bits, ~1 where the ranks compute different things (the control:
# each rank's tokens rolled by its rank).  The (2, 1) int8 + EF rounds run
# TP_EF_LAYERS of the 12 layers (full width): their residual rows and the
# cohort's gather cross gloo; each rank makes only its share of the store.
TP_DIMS = SP_DIMS
TP_L, TP_CLIENTS, TP_STEPS, TP_BATCH, TP_LR = 1024, 4, 2, 8, 3e-4
TP_RANKS, TP_LM_BATCH, TP_LM_TOL, TP_ROUND_TOL, TP_LOSS_RTOL = 2, 2, 3e-4, 0.05, 1e-2
TP_SPREAD_TOL = 0.02
TP_EF_LAYERS, TP_EF_ROUNDS, TP_EF_SLOTS = 1, 2, [2, 0, 3, 1]
TP_RUN_ARGV = ["--algorithm", "fedllm", "--dataset", "fed_shakespeare", "--comm_round", "1"]


def _tp_geometry() -> dict:
    """[tp]'s sizes, handed to its ranks whole (a rehearsal shrinks them)."""
    return dict(dims=TP_DIMS, L=TP_L, clients=TP_CLIENTS, steps=TP_STEPS, batch=TP_BATCH,
                lr=TP_LR, ranks=TP_RANKS, lm_batch=TP_LM_BATCH, ef_layers=TP_EF_LAYERS,
                ef_rounds=TP_EF_ROUNDS, ef_slots=TP_EF_SLOTS)


def _tp_block(g: dict, clients: int, steps: int, seed: int, slots=None) -> tuple:
    """A cohort block: ``clients`` x ``steps`` x batch sequences of L tokens
    from numpy seed ``seed``, the cohort's slot ids ``slots`` (default in
    order)."""
    import numpy as np

    v, L, b = g["dims"]["vocab_size"], g["L"], g["batch"]
    toks = np.random.RandomState(seed).randint(0, v, (clients, steps, b, L)).astype(np.int32)
    ids = np.arange(clients, dtype=np.int32) if slots is None else np.asarray(slots, np.int32)
    return (toks, np.roll(toks, -1, axis=-1), np.ones((clients, steps, b), np.float32),
            np.full((clients,), steps * b * L, np.float32), np.ones(clients, np.float32), ids)


def _tp_problems(g: dict) -> dict:
    """Part 1's block, part 2's round block (1 client), the (2, 1) rounds'
    shuffled cohort (2 clients a rank, 1 step) and the fp32 forward's tokens."""
    import numpy as np

    return dict(main=_tp_block(g, g["clients"], g["steps"], 0),
                round=_tp_block(g, 1, g["steps"], 2),
                ef=_tp_block(g, len(g["ef_slots"]), 1, 3, g["ef_slots"]),
                lm=np.random.RandomState(1).randint(
                    0, g["dims"]["vocab_size"], (g["lm_batch"], g["L"])).astype(np.int32))


def _tp_models(g: dict, device, layers: Optional[int] = None):
    """The plain bench transformer (``layers`` of them) and its bf16 SGD
    local update."""
    import torch

    from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
    from fedml_tpu_torch.models.transformer import transformer_lm

    dims = dict(g["dims"], num_layers=layers or g["dims"]["num_layers"])
    bundle = transformer_lm(**dims, seq_len=g["L"], device=device)
    return bundle, make_local_update(bundle, make_client_optimizer("sgd", g["lr"]), 1,
                                     compute_dtype=torch.bfloat16)


def _tp_ef_state(bundle, clients: int, mesh):
    """The (2, 1) rounds' start: the variables from ``PRNGKey(0)`` and a zero
    residual store of ``clients`` rows, this rank's share of it on ``mesh``."""
    from fedml_tpu_torch.algorithms.fedavg import ServerState
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.parallel.partition import FEDLLM_RULES, residual_store

    key = PRNGKey(0)
    variables = bundle.init(key)
    return ServerState(variables, (), 0, key,
                       residual_store(mesh, variables, FEDLLM_RULES, clients))


def _blocks_equal(laid_out: dict, whole: dict, mesh) -> bool:
    """Every ``Shard`` of a laid-out variables tree equal, byte for byte, to
    this rank's slice of the same leaf of ``whole`` (on the card: no
    gather)."""
    import torch

    from fedml_tpu_torch.parallel.layout import axis_sizes, mesh_coords, shard_slice

    sizes, coords = axis_sizes(mesh), mesh_coords(mesh)
    return all(torch.equal(s.block, shard_slice(whole[c][k], s.spec, sizes, coords))
               for c, sub in laid_out.items() for k, s in sub.items())


def _tp_rank(spec: dict) -> dict:
    """[tp]'s part 2 on one of TP_RANKS gloo ranks: the fp32 TP forward
    against part 1's 1-rank forward (and a planted fault), the bf16 DP×TP
    round against part 1's 1-rank round, the rule rounds on (1, ranks) and
    (ranks, 1) meshes against part 1's 1-rank rule rounds, the sharded int8
    codec on the card against the CPU's, and ``run.main`` with
    ``--tp_degree`` and ``--mesh``; each with its seconds, this rank's flash
    launches (and the head counts they ran on) and the bytes summed and
    gathered over the mesh."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import fedml_tpu_torch.ops.flash_attention as fa
    from fedml_tpu_torch.algorithms.fedavg import ServerState
    from fedml_tpu_torch.compress import get_codec, sharded_wire_digest, wire_encode_tree_sharded
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.experiments import run
    from fedml_tpu_torch.parallel import compat
    from fedml_tpu_torch.parallel import tensor as tensor_mod
    from fedml_tpu_torch.parallel.gspmd import make_dp_tp_mesh, make_dp_tp_round_fn
    from fedml_tpu_torch.parallel.layout import is_sharded, unshard_tree
    from fedml_tpu_torch.parallel.mesh import make_dp_mp_mesh
    from fedml_tpu_torch.parallel.partition import (FEDLLM_RULES, make_rule_round_fn,
                                                    shard_by_rules)
    from fedml_tpu_torch.parallel.tensor import make_tp_mesh, tensor_parallel_lm

    t_rank = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    device, g = spec["device"], spec["geometry"]
    n = g["ranks"]
    problems = _tp_problems(g)
    setup: dict = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        setup[name] = setup.get(name, 0.0) + time.perf_counter() - t0
        return res

    ref = timed("reference load", lambda: torch.load(spec["ref"], map_location=device))
    heads: list = []
    held: dict = {}
    real_flash = fa._flash_cuda

    def flash_heads(q, k, v, causal, lib=None):
        heads.append(int(q.shape[2]))
        o, lse = real_flash(q, k, v, causal, lib)
        if held.pop("next", False):  # this call against the plain version, same views
            with torch.no_grad():
                want_o, _ = fa.attention_plain(q, k, v, causal)
            tol = TOL["bf16" if q.dtype == torch.bfloat16 else "fp32"]
            held.update(shape=list(q.shape), strides=list(q.stride()),
                        max_abs_err=float((o.float() - want_o.float()).abs().max()),
                        within=bool(torch.allclose(o.float(), want_o.float(), rtol=tol,
                                                   atol=tol)))
        return o, lse

    fa._flash_cuda = flash_heads

    def measured(fn):
        reset_launches()
        heads.clear()
        compat.BYTES.clear()
        tensor_mod.REPLICA_SPREAD.clear()
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        seen = read_launches()
        return out, {"s": time.perf_counter() - t0, "flash": seen["flash_attention_fwd"],
                     "wgmma": seen["flash_attention_fwd_wgmma"], "heads": sorted(set(heads)),
                     "bytes": {f"{kind}:{axis}": v for (kind, axis), v in compat.BYTES.items()},
                     "spread": {a: float(v) for a, v in tensor_mod.REPLICA_SPREAD.items()}}

    out = {"rank": dist.get_rank(), "setup": setup}
    key = PRNGKey(0)
    bundle, lu = _tp_models(g, device)
    variables = timed("init", lambda: bundle.init(key))
    mesh = timed("meshes", lambda: make_tp_mesh(n, device=device))
    _, shard_params, apply, train_step = tensor_parallel_lm(mesh, **g["dims"], seq_len=g["L"])
    sharded = timed("lay out", lambda: shard_params(variables))
    lm = torch.from_numpy(problems["lm"])
    logits, out["lm"] = measured(lambda: apply(sharded, lm))
    want = ref.pop("logits")
    real_index = tensor_mod.axis_index
    # the planted fault: each rank takes the next rank's heads' columns
    tensor_mod.axis_index = lambda a: (real_index(a) + 1) % n
    try:
        bad = timed("planted fault", lambda: apply(sharded, lm))
    finally:
        tensor_mod.axis_index = real_index
    # the spread's control: one fp32 step with each rank's tokens rolled by
    # its rank, so that the ranks' replicated gradients differ
    skewed = torch.from_numpy(np.roll(problems["lm"], dist.get_rank(), axis=1))
    _, out["skewed"] = measured(lambda: train_step(sharded, skewed, skewed.roll(-1, 1),
                                                   g["lr"]))
    specs = tensor_mod.tp_param_spec(variables, "tp")["params"]
    out["lm"].update(
        gap=float((logits - want).abs().max()), scale=float(want.abs().max()),
        fault_gap=float((bad - want).abs().max()),
        within=bool(torch.isclose(logits, want, rtol=TP_LM_TOL, atol=TP_LM_TOL).all()),
        finite=bool(torch.isfinite(logits).all()),
        param_bytes=sum(s.block.numel() * s.block.element_size()
                        for s in sharded["params"].values()),
        shape_bytes=sum(4 * v.numel() // (n if is_sharded(specs[k]) else 1)
                        for k, v in variables["params"].items()))
    del logits, bad, want, sharded

    state0 = ServerState(variables, (), 0, key)
    tp_mesh = timed("meshes", lambda: make_dp_tp_mesh(1, n, device=device))
    round_fn, shard_state, shard_data = make_dp_tp_round_fn(tp_mesh, lu, variables)
    held["next"] = True  # the round's first flash call: layer 0 on this rank's heads
    (state, metrics), out["round"] = measured(
        lambda: round_fn(shard_state(state0), *shard_data(problems["round"])))
    held.pop("next", None)  # (on the CPU no kernel call took it)
    out["round"]["flash_held"] = dict(held)
    with compat.use_mesh(tp_mesh):
        whole = timed("gathers", lambda: unshard_tree(state.variables))
    num = den = 0.0
    for k, new in whole["params"].items():
        old, w = variables["params"][k], ref["params"][k]
        num += float((new.double() - w.double()).square().sum())
        den += float((w.double() - old.double()).square().sum())
    # the sharded leaves come back from one gather on every rank; the
    # replicated ones are each rank's own, so their bytes say whether the
    # ranks hold one model
    replicated = {"params": {k: whole["params"][k] for k, spec in specs.items()
                             if not is_sharded(spec)}}
    out["round"].update(gap=(num / max(den, 1e-300)) ** 0.5,
                        loss=float(metrics["loss_sum"]) / max(float(metrics["count"]), 1.0),
                        loss_gap=abs(float(metrics["loss_sum"]) - ref["loss_sum"])
                        / abs(ref["loss_sum"]), digest=_digest(replicated))
    del state, whole

    rule_mesh = timed("meshes", lambda: make_dp_mp_mesh(1, n, device=device))
    rule_fn, rule_state, rule_data = make_rule_round_fn(rule_mesh, lu, variables, FEDLLM_RULES)
    (state, _), out["rule"] = measured(
        lambda: rule_fn(rule_state(state0), *rule_data(problems["round"])))
    out["rule"]["equal"] = _blocks_equal(state.variables, {"params": ref["params"]},
                                         rule_mesh)
    del state

    # the sharded codec, int8, the card's blocks against the same blocks on
    # the CPU: Block_0's attention, norms and MLP-up bias laid out by
    # FEDLLM_RULES (column and row chunks, a split vector, replicas)
    sub, _ = shard_by_rules(rule_mesh, {"params": {
        k: v for k, v in variables["params"].items() if k.startswith("Block_0.") and (
            "MultiHeadAttention" in k or "LayerNorm" in k or k.endswith("Dense_0.bias"))}},
        FEDLLM_RULES)
    host = {"params": {k: s._replace(block=s.block.cpu()) for k, s in sub["params"].items()}}
    with compat.use_mesh(rule_mesh):
        card, out["codec"] = measured(
            lambda: wire_encode_tree_sharded(get_codec("int8"), sub, PRNGKey(7)))
        cpu = timed("CPU encode", lambda: wire_encode_tree_sharded(get_codec("int8"), host,
                                                                  PRNGKey(7)))
    out["codec"].update(
        equal=sharded_wire_digest(card) == sharded_wire_digest(cpu) and all(
            [s["index"] for s in a["shards"]] == [s["index"] for s in b["shards"]]
            for a, b in zip(card, cpu)),
        shards=sum(len(e["shards"]) for e in card), digest=sharded_wire_digest(card))
    del sub, host, card, cpu, variables, state0

    ef_bundle, ef_lu = _tp_models(g, device, g["ef_layers"])
    ef_mesh = timed("meshes", lambda: make_dp_mp_mesh(n, 1, device=device))
    ef0 = timed("init", lambda: _tp_ef_state(ef_bundle, len(g["ef_slots"]), ef_mesh))
    ef_fn, ef_state, ef_data = timed("EF engine", lambda: make_rule_round_fn(
        ef_mesh, ef_lu, ef0.variables, FEDLLM_RULES, codec="int8", error_feedback=True))

    def ef_rounds():
        st, block = ef_state(ef0), ef_data(problems["ef"])
        for _ in range(g["ef_rounds"]):
            st, _ = ef_fn(st, *block)
        return st

    store_made = sum(s.block.numel() * s.block.element_size()
                     for sub in ef0.residuals.values() for s in sub.values())
    state, out["ef"] = measured(ef_rounds)
    del ref
    ef_ref = timed("reference load", lambda: torch.load(spec["ef_ref"], map_location=device))
    out["ef"].update(equal=_blocks_equal(state.variables, ef_ref["variables"], ef_mesh),
                     store_equal=_blocks_equal(state.residuals, ef_ref["store"], ef_mesh),
                     store_bytes=store_made,
                     store_share=sum(v.numel() * v.element_size() for sub in
                                     ef_ref["store"].values() for v in sub.values()) // n)
    del state, ef0, ef_ref
    if device == "cuda":
        torch.cuda.empty_cache()

    run_dir = os.path.join(spec["run_dir"], f"rank{dist.get_rank()}")
    tp_argv = ["--tp_degree", str(n)]
    # run_tp again under torch's deterministic algorithms: whether the ranks'
    # replicated gradients then agree bit for bit, and which ops lack one
    for name, extra, det in (("run_tp", tp_argv, False),
                             ("run_mesh", ["--mesh", f"1,{n}", "--partition_rules", "fedllm"],
                              False),
                             ("run_tp_det", tp_argv, True)):
        with warnings.catch_warnings(record=True) as caught, (
                deterministic() if det else contextlib.nullcontext()):
            warnings.simplefilter("always")
            res, out[name] = measured(lambda extra=extra, name=name: run.main(
                [*TP_RUN_ARGV, *extra, "--run_dir", f"{run_dir}-{name}",
                 *(["--device", "cpu"] if device == "cpu" else [])]))
        out[name].update(history=res["history"], mesh=res["mesh"], warned=sorted(
            {str(w.message)[:160] for w in caught if "determinis" in str(w.message)}))
    fa._flash_cuda = real_flash
    out["geometry_steps"] = int(np.asarray(problems["round"][0]).shape[1])
    out["seconds"] = time.perf_counter() - t_rank
    return out


def phase_tp(device: str = "cuda", shared: Optional[list] = None):
    """Tensor parallelism and rule-driven sharding on the card
    (``parallel/{tensor,gspmd,partition}.py``, ``compress/sharded.py``) at
    the fedllm bench width (TP_DIMS, L TP_L, bf16 rounds, SGD TP_LR).

    1. 1-rank NCCL meshes, in process: one ``make_dp_tp_round_fn`` round on
       a (1, 1) ``(clients, model)`` mesh and one ``make_rule_round_fn``
       round under ``FEDLLM_RULES`` on a (1, 1) ``(dp, mp)`` mesh (TP_CLIENTS
       clients x TP_STEPS steps of TP_BATCH), each byte for byte
       ``make_round_fn``'s from the same state and block, the three warmed
       and timed in turns; 12 flash launches per forward, all wgmma.  Then
       part 2's references: the fp32 forward of TP_LM_BATCH sequences, the
       bf16 round of part 2's block, and TP_EF_ROUNDS int8 + EF rule rounds
       of TP_EF_LAYERS layers over a shuffled cohort on a 1-rank mesh.
    2. TP_RANKS gloo ranks sharing the card (in ``launch_shared``'s launch
       when given a ``shared`` list), every tensor on the card: tp TP_RANKS
       on a (1,
       TP_RANKS) mesh: the fp32 TP forward within TP_LM_TOL of part 1's (a
       planted fault, each rank's heads from the wrong columns, beyond it),
       the bf16 DP×TP round within TP_ROUND_TOL of part 1's update and its
       loss within TP_LOSS_RTOL; 12 flash launches per forward per rank on
       H / TP_RANKS heads, wgmma in bf16; each rank's parameter bytes equal
       to the count from the shapes; the bytes summed and gathered over the
       model axis per step.  The rule round on a (1, TP_RANKS) mesh byte
       for byte part 1's 1-rank round; the int8 + EF rule rounds on a
       (TP_RANKS, 1) mesh (2 clients a rank, rows crossing ranks) byte for
       byte part 1's, the residual store too; the int8 entries of the card's
       shards byte for byte the CPU's; ``run.main`` fedllm with
       ``--tp_degree`` and with ``--mesh 1,TP_RANKS --partition_rules
       fedllm`` at run.py's widths.

    Returns the record, which ``check_tp_ranks`` completes once part 2 has
    run.  ``device`` "cpu" rehearses the phase on gloo (launch counts are
    0)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.fedavg import ServerState, make_round_fn
    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.parallel.compat import single_rank_group
    from fedml_tpu_torch.parallel.gspmd import make_dp_tp_mesh, make_dp_tp_round_fn
    from fedml_tpu_torch.parallel.layout import blocks
    from fedml_tpu_torch.parallel.mesh import make_dp_mp_mesh
    from fedml_tpu_torch.parallel.partition import FEDLLM_RULES, make_rule_round_fn

    card = smi_line() if device == "cuda" else "cpu"
    rec = {"gpu": card}
    t_phase = time.perf_counter()
    g = _tp_geometry()
    layers = g["dims"]["num_layers"]
    problems = _tp_problems(g)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def on_device(block):
        return (*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in block[:5]),
                block[5])

    tmp = tempfile.mkdtemp(prefix="fedml_tp_")
    ref_path, ef_path = os.path.join(tmp, "reference.pt"), os.path.join(tmp, "ef.pt")
    with single_rank_group(device):
        bundle, lu = _tp_models(g, device)
        key = PRNGKey(0)
        variables = bundle.init(key)
        state0 = ServerState(variables, (), 0, key)
        tp_fn, tp_state, tp_data = make_dp_tp_round_fn(make_dp_tp_mesh(1, 1, device=device),
                                                       lu, variables)
        rule_fn, rule_state, rule_data = make_rule_round_fn(
            make_dp_mp_mesh(1, 1, device=device), lu, variables, FEDLLM_RULES)
        plain = make_round_fn(lu, device=device)
        block = problems["main"]
        calls = {"tp": (tp_fn, tp_state(state0), tp_data(block)),
                 "rule": (rule_fn, rule_state(state0), rule_data(block)),
                 "plain": (plain, state0, on_device(block))}
        t0 = time.perf_counter()
        for fn, st, args in calls.values():
            fn(st, *args)
        sync()
        setup_s = time.perf_counter() - t0
        times = {name: [] for name in calls}
        out, seen = {}, {}
        for name in ("tp", "rule", "plain", "plain", "rule", "tp"):
            fn, st, args = calls[name]
            first = name not in out
            if first:
                reset_launches()
            t0 = time.perf_counter()
            res = fn(st, *args)
            sync()
            times[name].append(time.perf_counter() - t0)
            if first:
                seen[name] = read_launches()
                out[name] = res
        want_state, want_m = out["plain"]
        equal = {name: _same_tensors(blocks(out[name][0].variables), want_state.variables)
                 and _same_tensors(out[name][1], want_m) for name in ("tp", "rule")}
        fwd = g["clients"] * g["steps"]
        loss = float(want_m["loss_sum"]) / max(float(want_m["count"]), 1.0)
        ratio = {name: float(np.median(times[name]) / np.median(times["plain"]))
                 for name in ("tp", "rule")}
        rec.update(setup_s=setup_s, round_s=times, ratio=ratio, bytewise_equal=equal,
                   loss=loss, part1_launches={k: v["flash_attention_fwd"]
                                              for k, v in seen.items()},
                   part1_wgmma={k: v["flash_attention_fwd_wgmma"] for k, v in seen.items()})
        print(f"[tp] part 1 on 1-rank {device} meshes, width {g['dims']['embed_dim']}, "
              f"{layers} layers, L {g['L']}, {g['clients']} clients x {g['steps']} steps of "
              f"{g['batch']}, bf16: set-up {setup_s:.2f} s; round s (in turns tp, rule, plain, "
              f"plain, rule, tp) DP×TP {[round(t, 4) for t in times['tp']]}, rule "
              f"{[round(t, 4) for t in times['rule']]}, make_round_fn "
              f"{[round(t, 4) for t in times['plain']]} (median ratios DP×TP "
              f"{ratio['tp']:.3f}, rule {ratio['rule']:.3f}); loss {loss:.4f}; equal byte for "
              f"byte {equal}; flash launches {rec['part1_launches']} (wgmma "
              f"{rec['part1_wgmma']}) for {fwd} forwards each ({card})")
        if not all(equal.values()):
            fail(f"tp: a 1-rank sharded round is not make_round_fn's byte for byte: {equal}")
        if not math.isfinite(loss):
            fail(f"tp: non-finite loss {loss}")
        if device == "cuda" and any(
                v["flash_attention_fwd"] != layers * fwd
                or v["flash_attention_fwd_wgmma"] != layers * fwd for v in seen.values()):
            fail(f"tp: flash launches {seen}, expected {layers * fwd} a round, all wgmma")
        del calls, out, want_state, tp_fn, rule_fn

        # part 2's references, from the same state
        logits = bundle.apply_eval(variables, torch.from_numpy(problems["lm"]).to(device))
        ref_state, ref_m = plain(state0, *on_device(problems["round"]))
        ef_bundle, ef_lu = _tp_models(g, device, g["ef_layers"])
        ef_mesh = make_dp_mp_mesh(1, 1, device=device)
        ef0 = _tp_ef_state(ef_bundle, len(g["ef_slots"]), ef_mesh)
        ef_fn, ef_state, ef_data = make_rule_round_fn(
            ef_mesh, ef_lu, ef0.variables, FEDLLM_RULES, codec="int8", error_feedback=True)
        st, block = ef_state(ef0), ef_data(problems["ef"])
        for _ in range(g["ef_rounds"]):
            st, _ = ef_fn(st, *block)
        torch.save({"logits": logits.cpu(), "loss_sum": float(ref_m["loss_sum"]),
                    "params": {k: v.cpu() for k, v in ref_state.variables["params"].items()}},
                   ref_path)
        torch.save({name: {c: {k: v.block.cpu() for k, v in sub.items()}
                           for c, sub in tree.items()}
                    for name, tree in (("variables", st.variables), ("store", st.residuals))},
                   ef_path)
        del logits, ref_state, st, ef0, variables, state0
    if device == "cuda":
        torch.cuda.empty_cache()
    rec["part1_s"] = time.perf_counter() - t_phase
    rec["rank_spec"] = dict(device=device, ref=ref_path, ef_ref=ef_path, run_dir=tmp, geometry=g)
    _hand_over(RankPart("tp", g["ranks"], _tp_rank, rec["rank_spec"],
                        lambda ranks, wall, extra: check_tp_ranks(ranks, wall, rec, device,
                                                                  card, extra_s=extra),
                        functools.partial(shutil.rmtree, tmp, ignore_errors=True)),
               shared, device, card)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[tp] phase time: {rec['phase_s']:.1f} s ({card})")
    return rec


def check_tp_ranks(ranks, wall: float, rec: dict, device: str, card: str,
                   extra_s: float = 0.0) -> None:
    """[tp]'s part-2 gates over each rank's ``_tp_rank`` result; adds the
    ranks' flash launches to the record; ``extra_s`` is the ranks' other
    work in a shared launch."""
    g = rec["rank_spec"]["geometry"]
    n, layers = g["ranks"], g["dims"]["num_layers"]
    heads = g["dims"]["num_heads"]
    steps = ranks[0]["geometry_steps"]
    parts = ("lm", "skewed", "round", "rule", "codec", "ef", "run_tp", "run_mesh", "run_tp_det")
    for x in ranks:
        lm, rnd, rule, codec, ef = x["lm"], x["round"], x["rule"], x["codec"], x["ef"]
        held = rnd["flash_held"]
        spread = {name: x[name]["spread"].get(axis, 0.0) for name, axis in (
            ("round", "model"), ("run_tp", "model"), ("rule", "mp"), ("run_mesh", "mp"),
            ("run_tp_det", "model"))}
        control = x["skewed"]["spread"].get("tp", 0.0)
        step_bytes = {k: rnd["bytes"].get(f"{k}:model", 0) / steps
                      for k in ("psum", "all_gather", "psum_scatter")}
        rnd["model_axis_bytes_per_step"] = step_bytes
        print(f"[tp] rank {x['rank']} of {n} gloo ranks on {device}: TP forward (fp32, "
              f"{g['lm_batch']} x {g['L']}) {lm['s']:.3f} s, max |Δ| {lm['gap']:.3g} vs the "
              f"1-rank forward (max |logit| {lm['scale']:.3g}, within {TP_LM_TOL}: "
              f"{lm['within']}; planted fault {lm['fault_gap']:.3g}), flash launches "
              f"{lm['flash']} on heads {lm['heads']}; parameter bytes {lm['param_bytes']} "
              f"(by the shapes {lm['shape_bytes']}); DP×TP round (bf16, 1 client x {steps} "
              f"steps) {rnd['s']:.3f} s, ||Δθ|| / ||update|| {rnd['gap']:.3g} (gate "
              f"{TP_ROUND_TOL}), loss {rnd['loss']:.4f} (rel. gap {rnd['loss_gap']:.3g}), "
              f"flash launches {rnd['flash']} ({rnd['wgmma']} wgmma) on heads {rnd['heads']}, "
              f"bytes a step over the model axis: summed {step_bytes['psum']:.0f}, "
              f"gathered {step_bytes['all_gather']:.0f}, reduce-scattered "
              f"{step_bytes['psum_scatter']:.0f}; its first flash call held against "
              f"attention_plain on the same views (q {held.get('shape')} strides "
              f"{held.get('strides')}): max abs err {held.get('max_abs_err')}, within "
              f"{TOL['bf16']}: {held.get('within')}; the ranks' replicated gradients' spread "
              f"before their mean {spread} (gate {TP_SPREAD_TOL}; control, tokens rolled by "
              f"rank, {control:.3g} in {x['skewed']['s']:.3f} s; run_tp_det under torch's "
              f"deterministic algorithms {x['run_tp_det']['s']:.3f} s, ops without one "
              f"{x['run_tp_det']['warned']}); rule round (1, {n}) "
              f"{rule['s']:.3f} s, byte "
              f"for byte the 1-rank round {rule['equal']}, bytes {rule['bytes']}, "
              f"flash {rule['flash']} on heads {rule['heads']}; int8 + EF rule rounds "
              f"({n}, 1), {g['ef_layers']} layers, {g['ef_rounds']} rounds {ef['s']:.3f} s, "
              f"byte for byte {ef['equal']}, store {ef['store_equal']}, bytes {ef['bytes']}, "
              f"the rank's store made {ef['store_bytes']} B (its share {ef['store_share']}); "
              f"sharded int8 codec "
              f"{codec['s']:.3f} s, {codec['shards']} shards, card == CPU {codec['equal']}; "
              f"run.main --tp_degree {x['run_tp']['s']:.3f} s mesh {x['run_tp']['mesh']}, "
              f"--mesh {x['run_mesh']['s']:.3f} s mesh {x['run_mesh']['mesh']}; set-up s "
              f"{ {k: round(v, 3) for k, v in x['setup'].items()} }, the rest of the rank's "
              f"{x['seconds']:.3f} s: "
              f"{x['seconds'] - sum(x['setup'].values()) - sum(x[p]['s'] for p in parts):.3f} s; final "
              f"{json.dumps({k: x['run_mesh']['history'][-1][k] for k in ('train_loss', 'test_loss')})} "
              f"({card})")
        if not (lm["within"] and lm["finite"]) or lm["fault_gap"] <= TP_LM_TOL:
            fail(f"tp: rank {x['rank']}'s TP forward is {lm['gap']:.3g} from the 1-rank "
                 f"forward (planted fault {lm['fault_gap']:.3g})")
        if max(spread.values()) > TP_SPREAD_TOL or control <= TP_SPREAD_TOL:
            fail(f"tp: rank {x['rank']}'s replicated gradients spread {spread} before their "
                 f"mean over the model axis (control {control:.3g}; gate {TP_SPREAD_TOL})")
        if ef["store_bytes"] != ef["store_share"]:
            fail(f"tp: rank {x['rank']} made {ef['store_bytes']} B of the residual store, "
                 f"its share is {ef['store_share']}")
        if device == "cuda" and not (held.get("within") and held.get("shape") == [
                g["batch"], g["L"], heads // n, g["dims"]["embed_dim"] // heads]):
            fail(f"tp: rank {x['rank']}'s flash call on its heads against attention_plain: "
                 f"{held}")
        if lm["param_bytes"] != lm["shape_bytes"]:
            fail(f"tp: rank {x['rank']} holds {lm['param_bytes']} B of parameters, the "
                 f"shapes say {lm['shape_bytes']}")
        if not (rnd["gap"] <= TP_ROUND_TOL and rnd["loss_gap"] <= TP_LOSS_RTOL):
            fail(f"tp: rank {x['rank']}'s DP×TP round is {rnd['gap']:.3g} of the update "
                 f"(loss {rnd['loss_gap']:.3g}) from the 1-rank round")
        if not (rule["equal"] and ef["equal"] and ef["store_equal"] and codec["equal"]):
            fail(f"tp: rank {x['rank']}'s rule rounds or sharded codec differ from the "
                 f"1-rank ones: rule {rule['equal']}, EF {ef['equal']}/{ef['store_equal']}, "
                 f"codec {codec['equal']}")
        if device == "cuda" and (
                lm["flash"] != layers or lm["heads"] != [heads // n]
                or rnd["flash"] != layers * steps or rnd["wgmma"] != rnd["flash"]
                or rnd["heads"] != [heads // n] or rule["flash"] != layers * steps
                or rule["wgmma"] != rule["flash"] or rule["heads"] != [heads]):
            fail(f"tp: rank {x['rank']}'s flash launches: forward {lm['flash']} on "
                 f"{lm['heads']}, DP×TP {rnd['flash']} ({rnd['wgmma']} wgmma) on "
                 f"{rnd['heads']}, rule {rule['flash']} ({rule['wgmma']} wgmma) on "
                 f"{rule['heads']}: expected {layers}, {layers * steps} on {heads // n} heads, "
                 f"{layers * steps} on {heads}")
        for name in ("run_tp", "run_mesh", "run_tp_det"):
            if not all(math.isfinite(x[name]["history"][-1][k])
                       for k in ("train_loss", "test_loss")):
                fail(f"tp: run.main ({name}) gave non-finite metrics {x[name]['history'][-1]}")
    for name in ("run_tp", "run_mesh", "run_tp_det"):
        if any(x[name]["history"] != ranks[0][name]["history"] for x in ranks):
            fail(f"tp: the ranks' run.main ({name}) histories differ")
    if len({x["round"]["digest"] for x in ranks}) != 1:
        fail("tp: the ranks' DP×TP rounds do not gather the same bytes")
    body = max(x["seconds"] for x in ranks)
    rec.update(ranks=ranks, launch_s=wall, rank_tp_s=body,
               startup_s=wall - body - extra_s,
               flash_launches=sum(rec["part1_launches"].values())
               + sum(x[p]["flash"] for x in ranks for p in parts),
               flash_wgmma_launches=sum(rec["part1_wgmma"].values())
               + sum(x[p]["wgmma"] for x in ranks for p in parts))
    print(f"[tp] {n}-rank gloo launch {wall:.2f} s ([tp]'s work {body:.2f} s a rank); flash "
          f"launches {rec['flash_launches']} ({rec['flash_wgmma_launches']} wgmma) ({card})")


# [pp]: the GPipe pipeline at the fedllm bench width (bench.py's
# TransformerLM): PP_MICRO microbatches of PP_BATCH x PP_L tokens
PP_DIMS = SP_DIMS
PP_L, PP_MICRO, PP_BATCH, PP_RANKS = 1024, 4, 2, 2
# part 1, bf16: the pipeline's output (max |Δ| over max |y|) and each stage
# gradient (||Δ|| / ||g||) against serial_reference; part 2: the fp32
# forward against part 1's (max |Δ| over max |y|), the bf16 output and stage
# gradients against part 1's
PP_OUT_TOL, PP_GRAD_TOL, PP_FWD_TOL = 1e-3, 1e-2, 1e-4
# [ep]: one expert at the Block's MLP width over the bench batch's tokens;
# part 2 two experts, EP_TOKENS // EP_RANKS tokens a rank
EP_D, EP_H, EP_TOKENS, EP_RANKS = 1280, 5120, 8 * 1024, 2
# fp32 (TF32 off): outputs max |Δ| over max |ref|, gradients ||Δ|| / ||g||
EP_TOL, EP_GRAD_TOL = 1e-5, 1e-4


def _pp_geometry() -> dict:
    """[pp]'s sizes, handed to its ranks whole (a rehearsal shrinks them)."""
    return dict(dims=PP_DIMS, L=PP_L, micro=PP_MICRO, batch=PP_BATCH, ranks=PP_RANKS)


def _stage_params(params: dict, first: int, depth: int) -> dict:
    """Blocks ``first .. first + depth - 1`` of a transformer's parameters,
    renamed ``Block_0 .. Block_<depth - 1>`` (a ``BlockStage``'s names)."""
    return {f"Block_{i}.{k.split('.', 1)[1]}": v for i in range(depth)
            for k, v in params.items() if k.startswith(f"Block_{first + i}.")}


def _pp_loss(y, head: dict, targets):
    """The LM loss on the pipeline's output: final norm, the weight-tied
    head and cross-entropy against the next tokens, in fp32."""
    import torch
    import torch.nn.functional as F

    h = F.layer_norm(y.float(), (y.shape[-1],), head["ln_f.scale"], head["ln_f.bias"],
                     eps=1e-6)
    logits = h @ head["wte.embedding"].t()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long())


def _norm_gap(got: dict, want: dict) -> float:
    """The largest ||Δ|| / ||want|| over the leaves."""
    return max(float((got[k].double() - want[k].double()).norm()
                     / want[k].double().norm().clamp_min(1e-300)) for k in want)


def _pp_grads(apply, stacked: dict, mesh, x, head, targets):
    """The pipeline's bf16 output and this rank's stage gradients of the
    LM loss (``[1, ...]`` blocks squeezed)."""
    import torch

    from fedml_tpu_torch.parallel.pipeline import shard_stage_params

    leaves = {k: s._replace(block=s.block.requires_grad_(True))
              for k, s in shard_stage_params(mesh, stacked).items()}
    y = apply(leaves, x)
    grads = torch.autograd.grad(_pp_loss(y, head, targets), [s.block for s in leaves.values()])
    return y.detach(), {k: g[0] for k, g in zip(leaves, grads)}


def phase_pp(device: str = "cuda", shared: Optional[list] = None):
    """Pipeline parallelism on the card (``parallel/pipeline.py``) at the
    fedllm bench width, the flash kernel in every Block of every stage.

    1. A 1-rank NCCL ``pp`` mesh, in process: the stage is the bench-width
       transformer's 12 Blocks (embedding, final norm and head outside the
       pipeline), PP_MICRO microbatches of PP_BATCH x PP_L tokens forward
       and backward in bf16 (LM loss): the output within PP_OUT_TOL and each
       stage gradient within PP_GRAD_TOL of ``serial_reference`` on the
       card, the two timed in turns; 12 flash launches per microbatch, all
       wgmma.  Then part 2's references: the fp32 forward and the bf16
       output and gradients of the same pipeline.
    2. PP_RANKS gloo ranks sharing the card (in ``launch_shared``'s launch
       when given a ``shared`` list), 12 / PP_RANKS Blocks a stage, the
       activations' ring hops staged through the host: the fp32 forward
       within PP_FWD_TOL of part 1's and a planted fault (the stages in the
       wrong order) beyond it; the bf16 forward and backward, output and
       stage gradients within PP_OUT_TOL / PP_GRAD_TOL of part 1's; each
       rank's first flash call on a real microbatch held against
       ``attention_plain`` on the same q/k/v views within TOL["bf16"];
       Blocks x (M + S - 1) flash launches per forward per rank (bubble
       ticks compute, as JAX's do); ``ppermute.staged_bytes`` beside the
       count from the shapes.

    Returns the record, which ``check_pp_ranks`` completes once part 2 has
    run.  ``device`` "cpu" rehearses the phase on gloo (launch counts are
    0)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.models.transformer import transformer_lm
    from fedml_tpu_torch.parallel.compat import single_rank_group
    from fedml_tpu_torch.parallel.dryrun import block_stage_fn
    from fedml_tpu_torch.parallel.pipeline import (make_gpipe, make_pp_mesh, serial_reference,
                                                   shard_stage_params, stack_stage_params)

    card = smi_line() if device == "cuda" else "cpu"
    rec = {"gpu": card}
    t_phase = time.perf_counter()
    g = _pp_geometry()
    dims, L, M, B, n = g["dims"], g["L"], g["micro"], g["batch"], g["ranks"]
    layers, E, H = dims["num_layers"], dims["embed_dim"], dims["num_heads"]

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    tmp = tempfile.mkdtemp(prefix="fedml_pp_")
    ref_path = os.path.join(tmp, "reference.pt")
    with torch.no_grad():
        params = transformer_lm(**dims, seq_len=L, device=device).init(PRNGKey(0))["params"]
        toks = torch.from_numpy(np.random.RandomState(0).randint(
            0, dims["vocab_size"], (M, B, L))).to(device)
        x = params["wte.embedding"][toks] + params["wpe.embedding"][:L]
    head = {k: params[k] for k in ("ln_f.scale", "ln_f.bias", "wte.embedding")}
    targets = toks.roll(-1, -1)
    with single_rank_group(device):
        mesh = make_pp_mesh(1, device=device)
        stage_fn = block_stage_fn(E, H, layers)
        apply = make_gpipe(mesh, stage_fn)
        whole32 = stack_stage_params([_stage_params(params, 0, layers)])
        whole16 = {k: v.bfloat16() for k, v in whole32.items()}
        x16 = x.bfloat16()

        def serial():
            ref = {k: v.clone().requires_grad_(True) for k, v in whole16.items()}
            ys = serial_reference(stage_fn, ref, x16)
            grads = torch.autograd.grad(_pp_loss(ys, head, targets), list(ref.values()))
            return ys.detach(), {k: gr[0] for k, gr in zip(ref, grads)}

        calls = {"pipeline": lambda: _pp_grads(apply, whole16, mesh, x16, head, targets),
                 "serial": serial}
        times = {k: [] for k in calls}
        out, seen = {}, {}
        for name in ("pipeline", "serial", "serial", "pipeline"):
            first = name not in out
            if first:
                reset_launches()
            t0 = time.perf_counter()
            res = calls[name]()
            sync()
            times[name].append(time.perf_counter() - t0)
            if first:
                seen[name] = read_launches()
                out[name] = res
        (y, grads), (ys, sgrads) = out["pipeline"], out["serial"]
        out_gap, grad_gap = _logit_gap(y, ys), _norm_gap(grads, sgrads)
        reset_launches()
        with torch.no_grad():
            y32 = apply(shard_stage_params(mesh, whole32), x)
        sync()
        seen["fp32"] = read_launches()
        rec.update(times=times, out_gap=out_gap, grad_gap=grad_gap, part1_launches={
            k: seen[k]["flash_attention_fwd"] for k in ("pipeline", "fp32")},
            part1_wgmma={k: seen[k]["flash_attention_fwd_wgmma"] for k in ("pipeline", "fp32")})
        print(f"[pp] part 1 on a 1-rank {device} pp mesh: the stage is {layers} Blocks at width "
              f"{E} ({H} heads), {M} microbatches of {B} x {L} tokens, bf16 forward and "
              f"backward (LM loss): s in turns (pipeline, serial, serial, pipeline) pipeline "
              f"{[round(t, 4) for t in times['pipeline']]}, serial_reference "
              f"{[round(t, 4) for t in times['serial']]}; output max |Δ| / max |y| "
              f"{out_gap:.3g} (gate {PP_OUT_TOL}), stage gradients ||Δ|| / ||g|| "
              f"{grad_gap:.3g} (gate {PP_GRAD_TOL}); flash launches {rec['part1_launches']} "
              f"(wgmma {rec['part1_wgmma']}), {layers * M} expected a forward ({card})")
        if not (out_gap <= PP_OUT_TOL and grad_gap <= PP_GRAD_TOL
                and torch.isfinite(y).all()):
            fail(f"pp: the 1-rank pipeline is {out_gap:.3g} (gradients {grad_gap:.3g}) from "
                 "serial_reference")
        if device == "cuda" and (
                any(v != layers * M for v in rec["part1_launches"].values())
                or rec["part1_wgmma"] != {"pipeline": layers * M, "fp32": 0}):
            fail(f"pp: flash launches {rec['part1_launches']} (wgmma {rec['part1_wgmma']}), "
                 f"expected {layers * M} a forward, wgmma in bf16 only")
        depth = layers // n
        torch.save({"stacked": {k: v.cpu() for k, v in stack_stage_params(
                        [_stage_params(params, s * depth, depth) for s in range(n)]).items()},
                    "x": x.cpu(), "targets": targets.cpu(),
                    "head": {k: v.cpu() for k, v in head.items()}, "y32": y32.cpu(),
                    "y16": y.cpu(), "grads": {k: v.cpu() for k, v in grads.items()}},
                   ref_path)
        del out, calls, y, ys, grads, sgrads, y32, whole32, whole16, params
    if device == "cuda":
        torch.cuda.empty_cache()
    rec["part1_s"] = time.perf_counter() - t_phase
    rec["rank_spec"] = dict(device=device, ref=ref_path, geometry=g)
    _hand_over(RankPart("pp", n, _pp_rank, rec["rank_spec"],
                        lambda ranks, wall, extra: check_pp_ranks(ranks, wall, rec, device,
                                                                  card, extra_s=extra),
                        functools.partial(shutil.rmtree, tmp, ignore_errors=True)),
               shared, device, card)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[pp] phase time: {rec['phase_s']:.1f} s ({card})")
    return rec


def _pp_rank(spec: dict) -> dict:
    """[pp]'s part 2 on one of PP_RANKS gloo ranks: the fp32 forward, the
    planted fault and the bf16 forward and backward of the pipeline of
    12 / PP_RANKS Blocks a stage, each with its seconds, this rank's flash
    launches and the bytes its ring hops staged through the host."""
    import torch
    import torch.distributed as dist

    import fedml_tpu_torch.ops.flash_attention as fa
    from fedml_tpu_torch.parallel import compat
    from fedml_tpu_torch.parallel.dryrun import block_stage_fn
    from fedml_tpu_torch.parallel.pipeline import make_gpipe, make_pp_mesh, shard_stage_params

    t_rank = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    device, g = spec["device"], spec["geometry"]
    n, dims = g["ranks"], g["dims"]
    depth = dims["num_layers"] // n
    rank = dist.get_rank()
    t0 = time.perf_counter()
    ref = torch.load(spec["ref"], map_location=device)
    load_s = time.perf_counter() - t0
    # the call to hold against attention_plain: this rank's first on a real
    # microbatch, tick ``rank``'s first Block (``at`` counts the run's calls)
    held: dict = {"calls": 0, "at": None}
    real_flash = fa._flash_cuda

    def flash_held(q, k, v, causal, lib=None):
        o, lse = real_flash(q, k, v, causal, lib)
        if held["calls"] == held["at"]:
            held["at"] = None
            with torch.no_grad():
                want_o, _ = fa.attention_plain(q, k, v, causal)
            held.update(shape=list(q.shape), strides=list(q.stride()),
                        max_abs_err=float((o.float() - want_o.float()).abs().max()),
                        within=bool(torch.allclose(o.float(), want_o.float(),
                                                   rtol=TOL["bf16"], atol=TOL["bf16"])))
        held["calls"] += 1
        return o, lse

    fa._flash_cuda = flash_held

    def measured(fn):
        reset_launches()
        compat.ppermute.staged_bytes = 0
        compat.BYTES.clear()
        t0 = time.perf_counter()
        res = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        seen = read_launches()
        return res, {"s": time.perf_counter() - t0, "flash": seen["flash_attention_fwd"],
                     "wgmma": seen["flash_attention_fwd_wgmma"],
                     "staged": compat.ppermute.staged_bytes,
                     "bytes": {f"{kind}:{axis}": v for (kind, axis), v in compat.BYTES.items()}}

    mesh = make_pp_mesh(n, device=device)
    apply = make_gpipe(mesh, block_stage_fn(dims["embed_dim"], dims["num_heads"], depth))
    stacked, x = ref["stacked"], ref["x"]
    out = {"rank": rank, "load_s": load_s}
    with torch.no_grad():
        y32, out["fp32"] = measured(lambda: apply(shard_stage_params(mesh, stacked), x))
        bad = apply(shard_stage_params(mesh, {k: v.flip(0) for k, v in stacked.items()}), x)
    out["fp32"].update(gap=_logit_gap(y32, ref["y32"]), fault_gap=_logit_gap(bad, ref["y32"]),
                       finite=bool(torch.isfinite(y32).all()))
    del y32, bad
    stacked16 = {k: v.bfloat16() for k, v in stacked.items()}
    held.update(calls=0, at=rank * depth)
    (y, grads), out["bf16"] = measured(lambda: _pp_grads(
        apply, stacked16, mesh, x.bfloat16(), ref["head"], ref["targets"]))
    want = _stage_params(ref["grads"], rank * depth, depth)
    out["bf16"].update(out_gap=_logit_gap(y, ref["y16"]), grad_gap=_norm_gap(grads, want),
                       names=len(grads) == len(want) == 10 * depth)
    fa._flash_cuda = real_flash
    out["held"] = {k: v for k, v in held.items() if k not in ("calls", "at")}
    out["act_bytes"] = int(x[0].numel()) * 2  # one bf16 microbatch activation
    out["seconds"] = time.perf_counter() - t_rank
    return out


def check_pp_ranks(ranks, wall: float, rec: dict, device: str, card: str,
                   extra_s: float = 0.0) -> None:
    """[pp]'s part-2 gates over each rank's ``_pp_rank`` result; adds the
    ranks' flash launches to the record; ``extra_s`` is the ranks' other
    work in a shared launch."""
    g = rec["rank_spec"]["geometry"]
    n, M, layers = g["ranks"], g["micro"], g["dims"]["num_layers"]
    depth, ticks = layers // n, M + n - 1
    heads, E = g["dims"]["num_heads"], g["dims"]["embed_dim"]
    for x in ranks:
        f32, b16, held = x["fp32"], x["bf16"], x["held"]
        act = x["act_bytes"]
        # each tick sends and receives one activation; the backward runs the
        # hops of every tick but the last (whose result nothing reads)
        want_staged = {"fp32": ticks * 2 * 2 * act, "bf16": (2 * ticks - 1) * 2 * act}
        # the output's psum-broadcast, once a run: its backward sends nothing
        want_sum = {"fp32": M * 2 * act, "bf16": M * act}
        print(f"[pp] rank {x['rank']} of {n} gloo ranks on {device}, {depth} Blocks a stage, "
              f"{M} microbatches: fp32 forward {f32['s']:.3f} s, max |Δ| / max |y| "
              f"{f32['gap']:.3g} vs the 1-rank forward (gate {PP_FWD_TOL}; planted fault, the "
              f"stages in the wrong order, {f32['fault_gap']:.3g}); bf16 forward and backward "
              f"{b16['s']:.3f} s, output {b16['out_gap']:.3g} (gate {PP_OUT_TOL}), stage "
              f"gradients {b16['grad_gap']:.3g} (gate {PP_GRAD_TOL}) vs the 1-rank ones; flash "
              f"launches fp32 {f32['flash']}, bf16 {b16['flash']} ({b16['wgmma']} wgmma), "
              f"{depth * ticks} expected a forward; first flash call on a real microbatch "
              f"(call {x['rank'] * depth}, q {held.get('shape')} strides {held.get('strides')}) "
              f"vs attention_plain max abs err {held.get('max_abs_err')}, within "
              f"{TOL['bf16']}: {held.get('within')}; staged through the host fp32 forward "
              f"{f32['staged']} B (shapes {want_staged['fp32']}), bf16 forward and backward "
              f"{b16['staged']} B (shapes {want_staged['bf16']}); bytes over the pp axis "
              f"fp32 {f32['bytes']}, bf16 {b16['bytes']} (shapes psum {want_sum}); reference load {x['load_s']:.2f} s, the rank's "
              f"{x['seconds']:.2f} s ({card})")
        if not (f32["gap"] <= PP_FWD_TOL and f32["finite"]) or f32["fault_gap"] <= PP_FWD_TOL:
            fail(f"pp: rank {x['rank']}'s fp32 pipeline is {f32['gap']:.3g} from the 1-rank "
                 f"forward (planted fault {f32['fault_gap']:.3g})")
        if not (b16["out_gap"] <= PP_OUT_TOL and b16["grad_gap"] <= PP_GRAD_TOL
                and b16["names"]):
            fail(f"pp: rank {x['rank']}'s bf16 pipeline is {b16['out_gap']:.3g} (gradients "
                 f"{b16['grad_gap']:.3g}) from the 1-rank pipeline")
        if device == "cuda" and (
                f32["flash"] != depth * ticks or b16["flash"] != depth * ticks
                or b16["wgmma"] != b16["flash"] or not held.get("within")
                or held.get("shape") != [g["batch"], g["L"], heads, E // heads]):
            fail(f"pp: rank {x['rank']}'s flash launches fp32 {f32['flash']}, bf16 "
                 f"{b16['flash']} ({b16['wgmma']} wgmma), expected {depth * ticks}; first "
                 f"call held {held}")
        if device == "cuda" and (f32["staged"], b16["staged"]) != (want_staged["fp32"],
                                                                   want_staged["bf16"]):
            fail(f"pp: rank {x['rank']} staged {f32['staged']} / {b16['staged']} B, the "
                 f"shapes say {want_staged}")
        if (f32["bytes"], b16["bytes"]) != ({"psum:pp": want_sum["fp32"]},
                                            {"psum:pp": want_sum["bf16"]}):
            fail(f"pp: rank {x['rank']} sent {f32['bytes']} / {b16['bytes']} over the pp "
                 f"axis, the shapes say psum {want_sum}")
    body = max(x["seconds"] for x in ranks)
    rec.update(ranks=ranks, launch_s=wall, rank_pp_s=body, startup_s=wall - body - extra_s,
               flash_launches=sum(rec["part1_launches"].values())
               + sum(x[p]["flash"] for x in ranks for p in ("fp32", "bf16")),
               flash_wgmma_launches=sum(rec["part1_wgmma"].values())
               + sum(x[p]["wgmma"] for x in ranks for p in ("fp32", "bf16")))
    print(f"[pp] {n}-rank gloo launch {wall:.2f} s ([pp]'s work {body:.2f} s a rank); flash "
          f"launches {rec['flash_launches']} ({rec['flash_wgmma_launches']} wgmma) ({card})")


def _ep_problem(g: dict, n: int, device: str, seed: int):
    """``init_moe_params`` for ``n`` experts of ``g``'s widths from
    ``PRNGKey(seed)`` and ``g["tokens"]`` tokens from ``PRNGKey(seed + 1)``."""
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.parallel.expert import init_moe_params

    params = init_moe_params(rng.PRNGKey(seed), n, g["d"], g["h"], device=device)
    return params, rng.normal(rng.PRNGKey(seed + 1), (g["tokens"], g["d"]), device)


def phase_ep(device: str = "cuda", shared: Optional[list] = None):
    """Expert parallelism on the card (``parallel/expert.py``): the GShard
    top-1 MoE FFN, fp32 with TF32 off.  No kernel runs here: the experts'
    FFN is a plain product, as JAX's is outside any Pallas kernel.

    1. A 1-rank NCCL ``ep`` mesh, in process: one expert at the Block's MLP
       width (EP_D -> EP_H -> EP_D) over EP_TOKENS tokens (the bench
       batch's), capacity EP_TOKENS, within EP_TOL of ``moe_reference``;
       the two timed in turns.
    2. EP_RANKS gloo ranks sharing the card (in ``launch_shared``'s launch
       when given a ``shared`` list), an expert a rank, EP_TOKENS / EP_RANKS
       tokens a rank, card buffers through gloo's all-to-all: at the
       capacity of every local token, within EP_TOL of ``moe_reference``;
       at half of it, within EP_TOL of the collective-free dense per-shard
       oracle (``dryrun.moe_dense_oracle``) on the card, and the gradients
       of the gate, the rank's expert weights and its tokens within
       EP_GRAD_TOL of autograd through that oracle on one rank (the one-device
       layer at the same capacity); the all-to-all bytes beside the count
       from the shapes.

    Returns the record, which ``check_ep_ranks`` completes once part 2 has
    run."""
    import torch

    from fedml_tpu_torch.parallel.compat import single_rank_group
    from fedml_tpu_torch.parallel.expert import (make_ep_mesh, make_moe_ffn, moe_reference,
                                                 shard_moe_params)

    card = smi_line() if device == "cuda" else "cpu"
    rec = {"gpu": card, "kernels": "none: the experts' FFN is a plain product"}
    t_phase = time.perf_counter()
    g = dict(d=EP_D, h=EP_H, tokens=EP_TOKENS, ranks=EP_RANKS)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    with single_rank_group(device), torch.no_grad():
        mesh = make_ep_mesh(1, device=device)
        params, x = _ep_problem(g, 1, device, 1)
        sharded = shard_moe_params(mesh, params)
        apply = make_moe_ffn(mesh, capacity=g["tokens"])
        calls = {"moe": lambda: apply(sharded, x).block,
                 "reference": lambda: moe_reference(params, x)}
        times = {k: [] for k in calls}
        out = {}
        for name in ("moe", "reference", "reference", "moe"):
            t0 = time.perf_counter()
            out[name] = calls[name]()
            sync()
            times[name].append(time.perf_counter() - t0)
        gap = _logit_gap(out["moe"], out["reference"])
        rec.update(times=times, gap=gap)
        print(f"[ep] part 1 on a 1-rank {device} ep mesh: one expert {g['d']} -> {g['h']} -> "
              f"{g['d']} over {g['tokens']} tokens, capacity {g['tokens']}, fp32: s in turns (moe, "
              f"reference, reference, moe) make_moe_ffn {[round(t, 4) for t in times['moe']]}, "
              f"moe_reference {[round(t, 4) for t in times['reference']]}; max |Δ| / max |y| "
              f"{gap:.3g} (gate {EP_TOL}); no kernel runs in [ep] ({card})")
        if not (gap <= EP_TOL and torch.isfinite(out["moe"]).all()):
            fail(f"ep: the 1-rank MoE is {gap:.3g} from moe_reference")
        del out, calls, params, x, sharded
    if device == "cuda":
        torch.cuda.empty_cache()
    rec["part1_s"] = time.perf_counter() - t_phase
    rec["rank_spec"] = dict(device=device, geometry=g)
    _hand_over(RankPart("ep", g["ranks"], _ep_rank, rec["rank_spec"],
                        lambda ranks, wall, extra: check_ep_ranks(ranks, wall, rec, device,
                                                                  card, extra_s=extra)),
               shared, device, card)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[ep] phase time: {rec['phase_s']:.1f} s ({card})")
    return rec


def _ep_rank(spec: dict) -> dict:
    """[ep]'s part 2 on one of EP_RANKS gloo ranks: the MoE at two
    capacities against its oracles, and its gradients at the smaller one;
    each with its seconds and the bytes its all-to-alls sent."""
    import torch
    import torch.distributed as dist

    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.parallel import compat
    from fedml_tpu_torch.parallel.dryrun import moe_dense_oracle
    from fedml_tpu_torch.parallel.expert import (make_ep_mesh, make_moe_ffn, moe_reference,
                                                 shard_moe_params)
    from fedml_tpu_torch.parallel.layout import shard_leaf

    t_rank = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    device, g = spec["device"], spec["geometry"]
    n, T = g["ranks"], g["tokens"]
    rank, t = dist.get_rank(), T // n
    mesh = make_ep_mesh(n, device=device)
    params, x = _ep_problem(g, n, device, 3)
    rows = slice(rank * t, (rank + 1) * t)
    sharded = shard_moe_params(mesh, params)
    out = {"rank": rank, "local_tokens": t}

    def measured(fn):
        compat.BYTES.clear()
        t0 = time.perf_counter()
        res = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        return res, {"s": time.perf_counter() - t0,
                     "a2a_bytes": compat.BYTES.get(("all_to_all", "ep"), 0)}

    with torch.no_grad():
        for name, cap in (("full", t), ("half", t // 2)):
            y, out[name] = measured(lambda cap=cap: make_moe_ffn(mesh, cap)(sharded, x).block)
            want = (moe_reference(params, x) if name == "full"
                    else moe_dense_oracle(params, x, n, cap))[rows]
            out[name].update(capacity=cap, gap=_logit_gap(y, want), finite=bool(
                torch.isfinite(y).all()), dropped=int((y.abs().amax(1) == 0).sum()))
    cap = t // 2
    leaves = {k: s._replace(block=s.block.clone().requires_grad_(True))
              for k, s in sharded.items()}
    xs = shard_leaf(mesh, x, ("ep",))
    xs = xs._replace(block=xs.block.requires_grad_(True))
    cot = rng.normal(rng.PRNGKey(5), (T, g["d"]), device)
    apply = make_moe_ffn(mesh, cap)
    grads, out["grads"] = measured(lambda: torch.autograd.grad(
        (apply(leaves, xs).block * cot[rows]).sum(),
        [*(s.block for s in leaves.values()), xs.block]))
    whole = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xw = x.clone().requires_grad_(True)
    ref = torch.autograd.grad((moe_dense_oracle(whole, xw, n, cap) * cot).sum(),
                              [*whole.values(), xw])
    got = dict(zip([*leaves, "x"], grads))
    want = {"gate": ref[0], "w_in": ref[1][rank:rank + 1], "w_out": ref[2][rank:rank + 1],
            "x": ref[3][rows]}
    out["grads"].update(capacity=cap, gap=_norm_gap(got, want),
                        per_leaf={k: _norm_gap({k: got[k]}, {k: want[k]}) for k in want})
    out["buffer_bytes"] = {name: n * out[name]["capacity"] * g["d"] * 4
                           for name in ("full", "half", "grads")}
    out["seconds"] = time.perf_counter() - t_rank
    return out


def check_ep_ranks(ranks, wall: float, rec: dict, device: str, card: str,
                   extra_s: float = 0.0) -> None:
    """[ep]'s part-2 gates over each rank's ``_ep_rank`` result."""
    n = rec["rank_spec"]["geometry"]["ranks"]
    for x in ranks:
        full, half, gr = x["full"], x["half"], x["grads"]
        buf = x["buffer_bytes"]
        # each all-to-all sends one [E, capacity, d] fp32 buffer; the forward
        # runs two, the backward two more
        want = {"full": 2 * buf["full"], "half": 2 * buf["half"], "grads": 4 * buf["grads"]}
        got = {k: x[k]["a2a_bytes"] for k in want}
        print(f"[ep] rank {x['rank']} of {n} gloo ranks on {device}, an expert a rank, "
              f"{x['local_tokens']} tokens a rank, fp32: capacity {full['capacity']} "
              f"{full['s']:.3f} s, max |Δ| / max |y| {full['gap']:.3g} vs moe_reference "
              f"(gate {EP_TOL}), {full['dropped']} tokens dropped; capacity "
              f"{half['capacity']} {half['s']:.3f} s, {half['gap']:.3g} vs the dense per-shard "
              f"oracle, {half['dropped']} dropped; gradients at capacity {gr['capacity']} "
              f"{gr['s']:.3f} s, ||Δ|| / ||g|| {gr['gap']:.3g} (gate {EP_GRAD_TOL}) vs "
              f"autograd through the oracle on one rank, per leaf "
              f"{ {k: float(f'{v:.3g}') for k, v in gr['per_leaf'].items()} }; all-to-all "
              f"bytes sent (gloo copies the card buffers through the host itself) {got} "
              f"(shapes {want}); no kernel runs here; "
              f"the rank's {x['seconds']:.2f} s ({card})")
        if not (full["gap"] <= EP_TOL and half["gap"] <= EP_TOL and full["finite"]
                and half["finite"] and full["dropped"] == 0 and half["dropped"] > 0):
            fail(f"ep: rank {x['rank']}'s MoE is {full['gap']:.3g} / {half['gap']:.3g} from "
                 f"its oracles (dropped {full['dropped']} / {half['dropped']})")
        if not gr["gap"] <= EP_GRAD_TOL:
            fail(f"ep: rank {x['rank']}'s MoE gradients are {gr['gap']:.3g} from the oracle's")
        if got != want:
            fail(f"ep: rank {x['rank']}'s all-to-alls sent {got} B, the shapes say {want}")
    body = max(x["seconds"] for x in ranks)
    rec.update(ranks=ranks, launch_s=wall, rank_ep_s=body, startup_s=wall - body - extra_s)
    print(f"[ep] {n}-rank gloo launch {wall:.2f} s ([ep]'s work {body:.2f} s a rank) ({card})")


# [mux]: the muxed cohort on a mesh of ranks (algorithms/fedavg_mux.py's mesh=,
# parallel/partition.py::CohortEngine).  Part 1 runs [xdevice]'s ResNet-56
# problem (the conv kernel, bf16) as a muxer federation over an in-process
# reactor TcpHub on a 1-rank NCCL (1, 1) mesh beside the mesh-free muxer; part 2
# runs on MUX_RANKS gloo ranks sharing the card (in the shared launch): the
# ResNet-56 federation on a (2, 1) mesh, a 3-client cohort that takes the
# indivisible fallback, and the fedllm transformer at the bench width cut to
# MUX_LM's layers on a (1, 2) mesh under FEDLLM_RULES beside the mesh-free
# muxer.  Byte-for-byte gates run under deterministic algorithms.
MUX_CLIENTS, MUX_ROUNDS, MUX_FALLBACK, MUX_RANKS = XD_CLIENTS, 2, 3, 2
MUX_LM = dict(dims=SP_DIMS, layers=2, L=1024, clients=2, batch=2, lr=3e-4)


def _mux_lm_problem(g: dict, device) -> dict:
    """The fedllm transformer at ``g``'s widths cut to ``g["layers"]`` layers,
    its bf16 SGD local update and init (``PRNGKey(0)``), and a dataset of
    ``g["clients"]`` clients of ``g["batch"]`` sequences of L tokens (numpy seed
    4): one step a round."""
    import numpy as np

    from fedml_tpu_torch.core.rng import PRNGKey
    from fedml_tpu_torch.core.types import FedDataset

    bundle, lu = _tp_models(dict(dims=g["dims"], L=g["L"], lr=g["lr"]), device, g["layers"])
    v, b, n = g["dims"]["vocab_size"], g["batch"], g["clients"]
    toks = np.random.RandomState(4).randint(0, v, (n * b, g["L"])).astype(np.int32)
    ds = FedDataset(train_x=toks, train_y=np.roll(toks, -1, axis=-1), test_x=None,
                    test_y=None, test_client_idx=None, num_classes=v,
                    train_client_idx={c: np.arange(c * b, (c + 1) * b) for c in range(n)})
    return dict(ds=ds, lu=lu, init=bundle.init(PRNGKey(0)), steps=1, batch=b, clients=n)


def _host_digest(variables: dict) -> str:
    """sha256 over a variables tree's names and bytes in JAX's leaf order
    (host numpy or tensors)."""
    import hashlib

    import numpy as np

    from fedml_tpu_torch.compress import jax_leaves
    from fedml_tpu_torch.core.tree import host_array

    h = hashlib.sha256()
    for path, leaf in jax_leaves(variables):
        h.update("/".join(path).encode())
        h.update(np.ascontiguousarray(host_array(leaf)).tobytes())
    return h.hexdigest()


def _mux_federation(p: dict, device, *, mesh=None, clients: Optional[int] = None,
                    rounds: int = MUX_ROUNDS, plant=None) -> dict:
    """One federation over an in-process reactor TcpHub: the port's server
    manager and one ``FedAvgMuxClientManager`` driving ``clients`` virtual
    clients (default ``p["clients"]``) over one connection, its cohorts on
    ``mesh`` (this rank its root; the mesh's other ranks serve) or
    mesh-free on ``device``; ``plant(mgr)`` may alter the muxer first.
    Returns the sha256 of each upload frame by node and round, the final
    model's digest, this process's kernel launches, the client forwards,
    the wall seconds and the muxer's ``shard.*`` counters."""
    import hashlib
    import threading

    from fedml_tpu_torch.algorithms.fedavg_cross_device import FedAvgServerManager
    from fedml_tpu_torch.algorithms.fedavg_mux import FedAvgMuxClientManager
    from fedml_tpu_torch.comm.mux import TcpMuxBackend
    from fedml_tpu_torch.comm.tcp import TcpBackend, TcpHub
    from fedml_tpu_torch.obs.telemetry import get_telemetry

    clients = clients or p["clients"]
    hub = TcpHub(mode="reactor")
    backends, frames, errors = [], {}, []
    try:
        mux = TcpMuxBackend(list(range(1, clients + 1)), hub.host, hub.port)
        backends.append(mux)
        mgr = FedAvgMuxClientManager(mux, p["lu"], p["ds"], batch_size=p["batch"],
                                     template_variables=p["init"], seed=0, mesh=mesh,
                                     device=None if mesh is not None else device)
        send = mgr._send_upload

        def recording(node, reply):
            frames[f"{node}/{reply.get('round_idx')}"] = hashlib.sha256(
                reply.to_frame()).hexdigest()
            send(node, reply)

        mgr._send_upload = recording
        if plant is not None:
            plant(mgr)

        def drive():
            try:
                mgr.run()
            except Exception as e:  # reported below, on the phase's thread
                errors.append(repr(e))

        muxer = threading.Thread(target=drive, daemon=True)
        muxer.start()
        sb = TcpBackend(0, hub.host, hub.port)
        backends.append(sb)
        server = FedAvgServerManager(sb, p["init"], num_clients=clients,
                                     clients_per_round=clients, comm_rounds=rounds, seed=0,
                                     steps_per_epoch=p["steps"], stats_plane=False)
        sb.await_peers(range(1, clients + 1), timeout=60)
        before = get_telemetry().snapshot()["counters"]
        reset_launches()
        t0 = time.perf_counter()
        st = sb.run_in_thread()
        server.start()
        st.join(timeout=300)
        muxer.join(timeout=60)
        wall = time.perf_counter() - t0
        seen = read_launches()
        if st.is_alive() or muxer.is_alive() or server.round_idx != rounds or errors:
            fail(f"mux: the federation stopped at round {server.round_idx} ({errors})")
    finally:
        for b in backends:
            b.stop()
        hub.stop()
    now = get_telemetry().snapshot()["counters"]
    return {"frames": frames, "model": _host_digest(server.variables), "launches": seen,
            "forwards": sum(mgr.rounds_trained.values()) * p["steps"], "wall_s": wall,
            "counters": {k: v - before.get(k, 0.0) for k, v in now.items()
                         if k.startswith("shard.") and v != before.get(k, 0.0)}}


def _swap_slots(mgr) -> None:
    """The planted fault: rows 0 and 1 of every mesh cohort keyed with each
    other's slot."""
    step = mgr._mesh.step

    def swapped(round_idx, steps, ids, slots, variables):
        return step(round_idx, steps, ids, [slots[1], slots[0], *slots[2:]], variables)

    mgr._mesh.step = swapped


def _conv_gate(label: str, run: dict, forwards: int, device: str) -> None:
    seen = run["launches"]
    if device == "cuda" and (seen["conv3x3_mxu"] != 19 * forwards
                             or seen["conv3x3_mxu_tc"] != TC_PER_FORWARD * forwards):
        fail(f"mux {label}: conv launches {seen}, expected {19 * forwards} "
             f"({TC_PER_FORWARD * forwards} tensor-core) for {forwards} client forwards")
    if seen["flash_attention_fwd"]:
        fail(f"mux {label}: the ResNet-56 cohort launched the flash kernel")


def phase_mux(device: str = "cuda", shared: Optional[list] = None):
    """The muxed cohort on a mesh of ranks (``fedavg_mux``'s ``mesh=``) on
    the card.

    1. In process, [xdevice]'s ResNet-56 problem (conv kernel, bf16, 4
       virtual clients of <= 128 samples, batch 64), MUX_ROUNDS rounds over
       an in-process reactor TcpHub and the port's server manager: the
       mesh-free muxer, then the muxer on a 1-rank NCCL (1, 1) mesh from the
       same init; every upload frame equal by sha256 and the final models
       equal, 19 conv launches per client forward (18 tensor-core); a planted
       fault (two rows' slots swapped, one round) beyond the frame gate.
    2. MUX_RANKS gloo ranks sharing the card (in ``launch_shared``'s launch
       when given a ``shared`` list): rank 0 hosts the hub, the server and
       the muxer, rank 1 is the resident worker.  On a (2, 1) mesh the same
       federation, its frames and final model part 1's byte for byte, each
       rank's conv launches 19 per forward of its two rows; a 3-client
       cohort on the indivisible fallback (counted, rank 1 served none); on
       a (1, 2) mesh under FEDLLM_RULES the fedllm transformer at the bench
       width cut to 2 layers (bf16, 2 virtual clients, 1 step of 2
       sequences of 1,024), its frames the mesh-free muxer's byte for byte,
       each rank's flash launches on the wgmma route; and the (1, 2) run
       once more outside deterministic mode, its frames' equality and the
       ranks' replicated-gradient spread printed.

    Part 1 and 2's byte gates run under deterministic algorithms
    (``deterministic()``).  Returns the record, which ``check_mux_ranks``
    completes once part 2 has run."""
    from fedml_tpu_torch.parallel.compat import single_rank_group
    from fedml_tpu_torch.parallel.mesh import make_dp_mp_mesh

    card = smi_line() if device == "cuda" else "cpu"
    rec = {"gpu": card}
    t_phase = time.perf_counter()
    with deterministic():
        p = dict(_xd_problem(device), clients=MUX_CLIENTS, batch=XD_BATCH)
        free = _mux_federation(p, device)
        with single_rank_group(device):
            mesh = make_dp_mp_mesh(1, 1, device=device)
            on_mesh = _mux_federation(p, device, mesh=mesh)
            fault = _mux_federation(p, device, mesh=mesh, rounds=1, plant=_swap_slots)
    same = free["frames"] == on_mesh["frames"] and len(free["frames"]) == MUX_CLIENTS * MUX_ROUNDS
    model_same = free["model"] == on_mesh["model"]
    fault_same = {k: v for k, v in free["frames"].items() if k.endswith("/0")} == fault["frames"]
    for label, run in (("mesh-free", free), ("1-rank mesh", on_mesh), ("planted fault", fault)):
        _conv_gate(label, run, run["forwards"], device)
    print(f"[mux] part 1, in process: {MUX_CLIENTS} virtual clients x {MUX_ROUNDS} rounds of "
          f"ResNet-56 (conv kernel, bf16, batch {XD_BATCH}) over a reactor TcpHub: mesh-free "
          f"muxer {free['wall_s']:.2f} s, on a 1-rank NCCL (1, 1) mesh {on_mesh['wall_s']:.2f} s; "
          f"every upload frame equal by sha256 {same}, final models equal {model_same}; conv "
          f"launches {on_mesh['launches']['conv3x3_mxu']} "
          f"({on_mesh['launches']['conv3x3_mxu_tc']} tensor-core) for {on_mesh['forwards']} "
          f"client forwards; planted fault (rows 0 and 1 keyed with each other's slot, 1 round): "
          f"frames equal {fault_same} ({card})")
    if not (same and model_same):
        fail("mux: the 1-rank mesh muxer's uploads are not the mesh-free muxer's")
    if fault_same:
        fail("mux: the planted fault (swapped slots) passed the frame gate")
    rec.update(part1={k: {x: run[x] for x in ("wall_s", "launches", "forwards", "model")}
                      for k, run in (("free", free), ("mesh", on_mesh), ("fault", fault))},
               frames=free["frames"], model=free["model"],
               launches=sum(r["launches"]["conv3x3_mxu"] for r in (free, on_mesh, fault)),
               tc_launches=sum(r["launches"]["conv3x3_mxu_tc"] for r in (free, on_mesh, fault)),
               flash_launches=0, flash_wgmma_launches=0, part1_s=time.perf_counter() - t_phase)
    del p
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
    rec["rank_spec"] = dict(device=device, lm=MUX_LM, samples=XD_SAMPLES, batch=XD_BATCH)
    _hand_over(RankPart("mux", MUX_RANKS, _mux_rank, rec["rank_spec"],
                        lambda ranks, wall, extra: check_mux_ranks(ranks, wall, rec, device,
                                                                   card, extra_s=extra)),
               shared, device, card)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[mux] phase time: {rec['phase_s']:.1f} s ({card})")
    return rec


def _mux_rank(spec: dict) -> dict:
    """[mux]'s part 2 on one of MUX_RANKS gloo ranks: rank 0 runs each
    federation (hub, server, muxer), the others serve its cohorts."""
    import torch
    import torch.distributed as dist

    from fedml_tpu_torch.algorithms.fedavg_mux import serve_cohorts
    from fedml_tpu_torch.parallel import tensor as tensor_mod
    from fedml_tpu_torch.parallel.mesh import make_dp_mp_mesh

    t_rank = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    device, rank = spec["device"], dist.get_rank()
    out: dict = {"rank": rank}

    def run(name, p, mesh, **kw):
        if rank == 0:
            out[name] = _mux_federation(p, device, mesh=mesh, **kw)
            return
        reset_launches()
        t0 = time.perf_counter()
        served = serve_cohorts(mesh, p["lu"], p["ds"], p["init"], batch_size=p["batch"], seed=0)
        out[name] = {"served": served, "launches": read_launches(),
                     "wall_s": time.perf_counter() - t0}

    with deterministic():
        p = dict(_xd_problem(device, spec["samples"], spec["batch"]), clients=MUX_CLIENTS,
                 batch=spec["batch"])
        mesh = make_dp_mp_mesh(2, 1, device=device)
        run("resnet", p, mesh)
        run("fallback", p, mesh, clients=MUX_FALLBACK, rounds=1)
        del p
        q = _mux_lm_problem(spec["lm"], device)
        mesh = make_dp_mp_mesh(1, 2, device=device)
        if rank == 0:
            out["lm_free"] = _mux_federation(q, device, rounds=1)
        tensor_mod.REPLICA_SPREAD.clear()
        run("lm", q, mesh, rounds=1)
    tensor_mod.REPLICA_SPREAD.clear()
    run("lm_nd", q, mesh, rounds=1)
    out["lm_nd_spread"] = float(tensor_mod.REPLICA_SPREAD.get("mp", 0.0))
    out["seconds"] = time.perf_counter() - t_rank
    return out


def check_mux_ranks(ranks, wall: float, rec: dict, device: str, card: str,
                    extra_s: float = 0.0) -> None:
    """[mux]'s part-2 gates over each rank's ``_mux_rank`` result."""
    r0, workers = ranks[0], ranks[1:]
    spec = rec["rank_spec"]
    lm = spec["lm"]
    res, fb = r0["resnet"], r0["fallback"]
    steps = res["forwards"] // (MUX_CLIENTS * MUX_ROUNDS)
    rows = MUX_CLIENTS // MUX_RANKS
    same = res["frames"] == rec["frames"] and res["model"] == rec["model"]
    lm_same = (r0["lm"]["frames"] == r0["lm_free"]["frames"]
               and r0["lm"]["model"] == r0["lm_free"]["model"]
               and len(r0["lm"]["frames"]) == lm["clients"])
    nd_same = r0["lm_nd"]["frames"] == r0["lm_free"]["frames"]
    fallbacks = fb["counters"].get("shard.cohort_fallbacks{reason=indivisible}", 0.0)
    # (1, 2): every rank trains both rows, one step, a flash forward a layer
    flash_want = lm["clients"] * lm["layers"]
    print(f"[mux] part 2, {MUX_RANKS} gloo ranks sharing {device} (rank 0: hub, server, muxer; "
          f"rank 1 its resident worker): ResNet-56 on a (2, 1) mesh {res['wall_s']:.2f} s, "
          f"frames and final model part 1's byte for byte {same}; conv launches rank 0 "
          f"{res['launches']['conv3x3_mxu']} ({res['launches']['conv3x3_mxu_tc']} tensor-core), "
          + ", ".join(f"rank {w['rank']} {w['resnet']['launches']['conv3x3_mxu']} "
                      f"({w['resnet']['launches']['conv3x3_mxu_tc']} tensor-core, "
                      f"{w['resnet']['served']} cohorts served)" for w in workers)
          + f" for {rows * MUX_ROUNDS * steps} client forwards a rank; a {MUX_FALLBACK}-client "
          f"cohort: {fallbacks:.0f} indivisible fallback(s), rank 0's conv launches "
          f"{fb['launches']['conv3x3_mxu']}, cohorts served by the workers "
          f"{[w['fallback']['served'] for w in workers]} ({card})")
    print(f"[mux] part 2: the fedllm transformer (width {lm['dims']['embed_dim']}, "
          f"{lm['layers']} layers, L {lm['L']}, bf16, {lm['clients']} virtual clients x 1 step of "
          f"{lm['batch']}) on a (1, 2) mesh under FEDLLM_RULES {r0['lm']['wall_s']:.2f} s "
          f"(mesh-free {r0['lm_free']['wall_s']:.2f} s): frames and final model the mesh-free "
          f"muxer's byte for byte {lm_same} (deterministic algorithms); flash launches rank 0 "
          f"{r0['lm']['launches']['flash_attention_fwd']} "
          f"({r0['lm']['launches']['flash_attention_fwd_wgmma']} wgmma), "
          + ", ".join(f"rank {w['rank']} {w['lm']['launches']['flash_attention_fwd']} "
                      f"({w['lm']['launches']['flash_attention_fwd_wgmma']} wgmma)"
                      for w in workers)
          + f", mesh-free {r0['lm_free']['launches']['flash_attention_fwd']}; outside "
          f"deterministic mode: frames equal {nd_same}, the ranks' replicated-gradient spread "
          f"{r0['lm_nd_spread']:.3g} (rank 0) / "
          f"{[round(w['lm_nd_spread'], 12) for w in workers]} ({card})")
    if not same:
        fail("mux: the (2, 1) mesh muxer's uploads are not part 1's")
    if not lm_same:
        fail("mux: the (1, 2) mesh muxer's transformer uploads are not the mesh-free muxer's")
    if fallbacks != 1 or any(w["fallback"]["served"] for w in workers):
        fail(f"mux: the {MUX_FALLBACK}-client cohort did not take the indivisible fallback "
             f"({fb['counters']})")
    _conv_gate("rank 0 (2, 1)", res, rows * MUX_ROUNDS * steps, device)
    _conv_gate("fallback", fb, MUX_FALLBACK * steps, device)
    for w in workers:
        _conv_gate(f"rank {w['rank']} (2, 1)", w["resnet"], rows * MUX_ROUNDS * steps, device)
        if w["resnet"]["served"] != MUX_ROUNDS:
            fail(f"mux: rank {w['rank']} served {w['resnet']['served']} cohorts")
    lm_runs = [r0["lm"], r0["lm_free"], *(w["lm"] for w in workers)]
    for run in lm_runs:
        seen = run["launches"]
        if device == "cuda" and not (seen["flash_attention_fwd"] == flash_want
                                     == seen["flash_attention_fwd_wgmma"]):
            fail(f"mux: flash launches {seen}, expected {flash_want} on the wgmma route")
    nd = [r0["lm_nd"], *(w["lm_nd"] for w in workers)]
    conv = [res, fb, *(w[k] for w in workers for k in ("resnet", "fallback"))]
    rec["launches"] += sum(r["launches"]["conv3x3_mxu"] for r in conv)
    rec["tc_launches"] += sum(r["launches"]["conv3x3_mxu_tc"] for r in conv)
    rec["flash_launches"] += sum(r["launches"]["flash_attention_fwd"] for r in lm_runs + nd)
    rec["flash_wgmma_launches"] += sum(r["launches"]["flash_attention_fwd_wgmma"]
                                       for r in lm_runs + nd)
    body = max(r["seconds"] for r in ranks)
    rec.update(part2={"resnet_s": res["wall_s"], "fallback_s": fb["wall_s"],
                      "lm_s": r0["lm"]["wall_s"], "lm_free_s": r0["lm_free"]["wall_s"],
                      "lm_nd_s": r0["lm_nd"]["wall_s"], "nd_frames_equal": nd_same,
                      "nd_spread": [r["lm_nd_spread"] for r in ranks]},
               launch_s=wall, rank_mux_s=body, startup_s=wall - body - extra_s)
    print(f"[mux] {MUX_RANKS}-rank gloo launch {wall:.2f} s ([mux]'s work {body:.2f} s a rank); "
          f"conv3x3_mxu launches {rec['launches']} ({rec['tc_launches']} tensor-core), flash "
          f"{rec['flash_launches']} ({rec['flash_wgmma_launches']} wgmma) ({card})")


PHASES = ["build", "kernels", "check", "main", "fedllm", "rng", "north_star", "sim",
          "init", "compress", "pack", "zoo", "silo", "algos", "standalone", "family",
          "imagenet", "comm", "xdevice", "tcp", "mesh", "tp", "sp", "pp", "ep", "mux"]
# the phases whose ResNet-56 client forwards the kernels line's conv count sums
CONV_PHASES = ["main", "north_star", "sim", "compress", "silo", "algos", "standalone",
               "imagenet", "xdevice", "tcp", "mesh", "mux"]
# the phases whose transformer forwards the kernels line's flash count sums
FLASH_PHASES = ["fedllm", "sp", "tp", "pp", "mux"]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write every per-case number here as JSON")
    parser.add_argument("--profile", action="store_true",
                        help="also trace one main-path round with torch.profiler")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma list of the phases to run, in the script's order "
                             "(default: every phase); the kernels line needs 'kernels'")
    args = parser.parse_args()
    selected = [p.strip() for p in args.phases.split(",") if p.strip()]
    unknown = sorted(set(selected) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}; known: {','.join(PHASES)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import tempfile

    smi = smi_line()
    recs: dict = {}
    seconds: dict = {}

    def run(name, fn):
        if name not in selected:
            return
        t0 = time.perf_counter()
        recs[name] = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"[{name}] phase seconds: {seconds[name]:.1f} ({smi})")

    with contextlib.ExitStack() as stack:
        run("build", phase_build)
        run("kernels", lambda: (phase_kernels(),
                                phase_kernels(CONV_SHAPES_224, N_224, [("bf16", True, False)]),
                                phase_flash_kernels()))
        run("check", lambda: (phase_check(), phase_flash_check(), phase_check_variants()))
        run("main", lambda: phase_main(args.profile))
        run("fedllm", lambda: phase_fedllm(args.profile))
        run("rng", phase_rng)
        run("north_star", lambda: phase_north_star(args.profile))
        run("sim", lambda: phase_sim(recs["north_star"]["step_ms"] if "north_star" in recs
                                     else None))
        run("init", phase_init)
        run("compress", phase_compress)
        run("pack", phase_pack)
        run("zoo", lambda: phase_zoo(args.profile))
        run("silo", lambda: phase_silo(args.profile))
        nas_reference = None
        if "family" in selected:
            # [family]'s CPU float64 FedNAS round starts here, beside [algos] and
            # [standalone], so that [family] need not wait for it
            nas_dir = stack.enter_context(tempfile.TemporaryDirectory())
            out_path = os.path.join(nas_dir, "nas_reference.pkl")
            nas_reference = (_start_nas_reference(out_path), out_path)
            stack.callback(nas_reference[0].kill)
        run("algos", phase_algos)
        run("standalone", phase_standalone)
        run("family", lambda: phase_family(nas_reference=nas_reference))
        run("imagenet", phase_imagenet)
        run("comm", phase_comm)
        run("xdevice", phase_xdevice)
        run("tcp", phase_tcp)
        # the multi-rank phases' gloo ranks run in one launch after them
        shared: list = []
        stack.callback(lambda: [p.cleanup() for p in shared if p.cleanup is not None])
        run("mesh", lambda: phase_mesh(shared=shared))
        run("tp", lambda: phase_tp(shared=shared))
        run("sp", lambda: phase_sp(shared=shared))
        run("pp", lambda: phase_pp(shared=shared))
        run("ep", lambda: phase_ep(shared=shared))
        run("mux", lambda: phase_mux(shared=shared))
        if shared:
            t0 = time.perf_counter()
            launch_shared(shared)
            seconds["ranks"] = time.perf_counter() - t0
            print(f"[ranks] phase seconds: {seconds['ranks']:.1f} (the gloo ranks of "
                  f"{', '.join(p.name for p in shared)}) ({smi})")
    total = sum(seconds.values())
    print(f"[phases] {total:.1f} s over {len(seconds)} phases: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + f" ({smi})")

    kernels = kernels_record(recs) if "kernels" in recs else None
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"gpu": smi, "phase_seconds": seconds, "kernels": kernels,
                       **{k: v for k, v in recs.items() if k not in ("kernels", "check")},
                       **({"cases": recs["kernels"][0], "cases_224": recs["kernels"][1],
                           "flash_cases": recs["kernels"][2]} if "kernels" in recs else {})},
                      f, indent=1, default=str)
    print(smi)
    if kernels is not None:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernels_record(recs: dict) -> list:
    """The kernels line: each kernel's checks and times from [kernels], its
    launches summed over the main-path phases that ran."""
    cases, cases_224, flash_cases = recs["kernels"]
    # the kernel's row: summed over the 19 convs of one training forward
    # (bf16, moments), the main path's configuration
    train = [c for c in cases if c["dtype"] == "bf16" and c["moments"]]

    def per_forward(key, rows=train):
        return sum(c[key] * c["per_forward"] for c in rows)

    kernels = [{
        "name": "conv3x3_mxu",
        "route": "cuda",
        "source": "fedml_tpu_torch/ops/csrc/conv_mxu.cu",
        "replaces": "fedml_tpu/ops/conv_mxu.py:72",
        "launches": sum(recs[p]["launches"] for p in CONV_PHASES if p in recs),
        "max_abs_err": max(c["max_abs_err"] for c in train),
        "ms": per_forward("ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": ("bytes" if per_forward("bytes_ms") >= per_forward("ops_ms")
                     else "operations"),
        "library_ms": per_forward("library_ms"),
        # the same forward at the ImageNet loaders' 224 px (N_224 images)
        "at_224px": {
            "n": N_224, "launches": recs.get("imagenet", {}).get("launches", 0),
            "max_abs_err": max(c["max_abs_err"] for c in cases_224),
            **{k: per_forward(k, cases_224)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": ("bytes" if per_forward("bytes_ms", cases_224)
                         >= per_forward("ops_ms", cases_224) else "operations")},
    }]
    # the flash kernel's row: the bench shape (bf16, causal) times the 12
    # layers of one forward, the fedllm main path's configuration
    bench = next(c for c in flash_cases if c["case"] == "bench" and c["dtype"] == "bf16")
    kernels.append({
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "fedml_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "fedml_tpu/ops/flash_attention.py:35",
        "launches": sum(recs.get(p, {}).get("flash_launches", 0) for p in FLASH_PHASES),
        "wgmma_launches": sum(recs.get(p, {}).get("flash_wgmma_launches", 0)
                              for p in FLASH_PHASES),
        "max_abs_err": bench["max_abs_err"],
        "ms": BENCH_LAYERS * bench["ms"],
        "plain_ms": BENCH_LAYERS * bench["plain_ms"],
        "bound_ms": BENCH_LAYERS * bench["bound_ms"],
        "bound_by": "bytes" if bench["bytes_ms"] >= bench["ops_ms"] else "operations",
        "library_ms": BENCH_LAYERS * bench["library_ms"],
    })
    return kernels


if __name__ == "__main__":
    sys.exit(main())
