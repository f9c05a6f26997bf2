#!/usr/bin/env python3
"""Drive the port's decode, training (configs 1-5) and measurement path once
on one NVIDIA GPU.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

It builds the CUDA kernels from ``asr_craft_tpu_torch/csrc`` and then runs,
in phases:

(a) parity — the K3 kernels (``fdt_viterbi_plane``, every frame's plane on
    the tensor cores; ``fdt_viterbi_fwd``, the recursion that reads them;
    ``fdt_viterbi_traceback``) against their plain PyTorch version on the
    card: the config-2 flagship (B=64, T=512, P=48, ns=3, ragged lengths
    with an empty row) exact, with ``beam_threshold=8`` and with
    ``beam_width=16``, and P=128 at small B, T; and the recursion alone
    against its plain version on the same planes (paths equal, scores
    within rtol 1e-6);
(b) end to end — ``asr_craft_tpu_torch.cli.decode.main`` on a synthetic
    corpus at flagship widths with a hand-set posterior model, through the
    kernels (launch counts must rise) and again with ``--kernel_backend
    torch`` (same PER, same MLF);
(c) timing — the decode's planes (beside one cuBLAS fp32 ``mm`` of the
    same product), K3's recursion (exact, and once with ``beam_width=16``),
    K3's forward whole, the traceback and ``decode()``, kernels against the
    plain version at B=64, T=512 (CUDA events); the traceback's own device
    time from a ``torch.profiler`` trace (events around its calls read the
    wrapper's host time) and us a dependent step (ms / T): on L2-resident
    backpointers (its time in the ``kernels`` line), right after the
    forward has written them and inside ``decode()``;
(d) training parity — the plane kernel (``fdt_train_plane``, every frame's
    plane on the tensor cores, formed once a step by K1's wrapper), K1's
    recursion (``fdt_train_fwd``, which reads them; whole K1 against the
    plain version, and the recursion alone against its plain version on
    the same planes), and K2's recursion (``fdt_train_bwd``, beta/xi/gamma
    on the same planes) and contraction (``fdt_train_contract``, dWall /
    dfeats on the tensor cores, dWall bit-equal on two runs) against their
    plain PyTorch versions: the flagship (B=128, T=512, ragged lengths with
    an empty row and a dead clamped lattice) with phone labels (clamp_ns =
    ns, and once with ``grad_feats``) and state labels (clamp_ns = 1),
    P=128 at small B, T, and the parameter gradients of ``crf_loss`` end to
    end; K2 launches no plane kernel when handed K1's planes;
(e) training end to end — ``asr_craft_tpu_torch.cli.train.main`` with the
    flags of the JAX reference run (256 synthetic utterances, 3 epochs),
    held to the JAX CPU losses and PER; K1, K2 and K3 launch counts must
    rise, and the plane kernel must launch once a forward (train step or
    CV batch), none in K2's backward; again with ``--kernel_backend torch``
    (same losses); the final weights decode to the same PER and MLF under
    both backends; the CLI's steps and CV pass run as CUDA graphs, and the
    run again eagerly (``train.graphs.disabled()``) gives the same losses,
    PERs and final weights;
(f) training timing — the planes, K1's recursion, K1 whole, K2's recursion
    and contraction, K2 whole (on K1's planes) and a full train step (loss,
    backward, SGD update), kernels against the plain version at B=128,
    T=512, all rows full; cuBLAS in fp32 on the planes' and the
    contraction's products alone; one step's launches (one plane kernel)
    and peak device memory (the step eager: phase (s) times its graph);
(g) shared-transition parity — the K7 kernel (``viterbi_dense_fwd``, configs
    1 and 3), the K8 kernel (``viterbi_nstate_fwd``, config 5) and the
    traceback kernel (``viterbi_traceback``) against their plain version
    (``ops/viterbi``) on the potentials of random models at B=64, T=512
    (ragged lengths, an empty row), exact, ``beam_threshold=8`` and
    ``beam_width=16``, and K7 at P=130, ns=3 (L'=390, the wide kernel) at
    small B, T: backpointers, final labels, scores and paths EQUAL;
(h) shared-transition end to end — ``cli.decode.main`` for configs 1, 3
    (``--normalize utt --beam_threshold 8``) and 5 on a synthetic corpus
    with the hand-set posterior model, through the kernels and with
    ``--kernel_backend torch`` (same PER, same MLF, the JAX CPU counts),
    and the ``--lexicon`` word decode of the word fixture (the JAX CLI's
    words and WER);
(i) shared-transition timing — K7, K8 (each exact, with
    ``beam_threshold=8`` and with ``beam_width=16``, and us a frame), the
    traceback and ``decode()`` against the plain version at B=64, T=512 for
    configs 1, 3 and 5, K7 also on config 5's n-state problem; K8's
    re-scans of dead destinations on this data (its bound counts them), the
    traceback's own device time alone and inside ``decode()`` (traced, us a
    dependent step) and the device-busy share of ``decode()`` (a
    ``torch.profiler`` trace);
(j) shared-transition training parity — the K6a / K6b kernels (``forward``,
    ``backward``), K4 / K14 (``forward_dual``, ``backward_dual``) and K5, its
    recursion (``backward_dual_grad``: g_state and the rows U, V of the
    transition gradient) and its contraction on the tensor cores
    (``backward_dual_contract``: UV, held alone against its plain version on
    the same rows), against their plain versions on the potentials of random
    models of configs 1, 3 and 5 at B=128, T=512 (ragged lengths, an empty
    row, a row whose labels no state admits: zero gradient and zero rows),
    with phone labels and, for config 5, state labels; UV and g_state
    bit-equal on two runs; one launch of each half a ``backward_dual_grad``;
    the parameter gradients of the shared ``crf_loss``;
(k) shared-transition training end to end — ``cli.train.main`` for configs
    1, 3 and 5 with their recipes' model flags (256 synthetic utterances, 3
    epochs), held to the JAX CPU losses and PER: K4, K5 (both halves), K7,
    K8 and the traceback must launch; then, each with its own launch counts,
    the trained models' ``frame_posteriors`` (K6a, K6b must launch) and
    ``kernels.fwdbwd.backward_dual`` (K14: no higher entry point calls it,
    here or in the JAX package); the train CLI again with
    ``--kernel_backend torch`` (same losses); the trained weights decode to
    the same PER and MLF under both backends; each config's run again
    eagerly: the same losses, PERs and final weights as through the
    graphs;
(l) shared-transition training timing — the six kernels (K5's recursion and
    contraction apart, the contraction on the recursion's rows beside one
    cuBLAS fp32 ``U.T @ V`` of the same rows), K5 whole and a full train step
    (loss, backward, SGD update, eager) against the plain version at B=128,
    T=512, all rows full, for configs 1, 3 and 5, and the device-busy share
    of the step (a ``torch.profiler`` trace);
(m) segmental parity — the K9-K13 kernels (``segmental_forward``,
    ``segmental_backward``, K11 whole and in its three parts
    (``segmental_grad_message``, the xi pass ``segmental_grad``, the
    tensor-core ``segmental_grad_contract``, each also alone on the plain
    version's inputs), ``segmental_viterbi``,
    ``segmental_viterbi_traceback``) against their plain versions on the
    frame scores of a random config-4 model at B=128, T=512, L=48, Dmax=16
    (ragged lengths, an empty row), mean and sum pooling: alphas, betas,
    logZ and the gradient pieces within tolerance, gd and gt bit-equal on
    two runs; deltas, duration argmaxes, segment markers and packed
    segments equal, exact and with ``beam_threshold=8``; the parameter
    gradients of ``scrf_loss_fused`` under both backends;
(n) segmental end to end — ``asr_craft_tpu_torch.recipes.scrf.main`` (60
    training and 600 held-out utterances, 300 epochs), held to the JAX CPU
    run's losses and PER: K9-K13 must launch; ``--decode_only`` on the
    weights it wrote under both backends (the same counts); 30 epochs again
    under both backends (the same losses); its Adam step is one CUDA
    graph, and the 300 epochs again eagerly give the same losses, counts
    and weights;
(o) segmental timing — the five kernels (K11 in its three parts and
    whole, its contraction beside one cuBLAS fp32 ``E.T @ F`` of the same
    rows), one train step (``scrf_loss_fused``, backward, SGD) and one
    ``scrf_decode`` against the plain version at B=128, T=512, L=48, D=144,
    Dmax=16, all rows full, K13's own device time alone and inside
    ``scrf_decode`` (traced; us a dependent step: ms / the segments of an
    utterance's best path), and the device-busy share and kernel count of
    the step and the decode;
(p) calibration parity — the K15 kernel (``calibrate``) against its plain
    version at a short chain (2 steps, where nothing has settled) and at 64
    steps over the whole (16, 48, 128) window; its launch count rises; its
    rates at Dmax = 8 and 16 agree within 25% (all the slots are worked on);
    its time at the default chain (the plain version timed at 8 steps and
    scaled);
(q) bench end to end — ``asr_craft_tpu_torch.bench.main`` at full width: K1,
    K2, K3, K9-K13 and K15 must launch; its records are held to what no
    card can break (every share of a roofline or floor in (0, 100], the
    stream bandwidth in (1000, 3350] GB/s, the elementwise rate under the
    multiply-add peak, both T-sweep fits with r2 >= 0.98 and a per-frame
    cost within 30% of PERF.md's, its step and decode times, all through
    CUDA graphs, within 1.5x of phase (s)'s graph times of the same paths);
    then the recipe twins 1, 2, 3 and 5
    at their own sizes, held to the JAX CPU runs of the same recipes
    (losses rtol 1e-3, PERs within 0.02);
(r) diagnostics — the train CLI for one epoch on 64 utterances with
    ``--profile_dir`` (the trace exists, names ``fdt_train_fwd_kernel``,
    and gives the device-busy share of the traced epoch); with
    ``--debug_nans`` and a weight file holding one NaN it raises
    ``FloatingPointError``, and without the flag the same run ends;
(s) the compiled step (run after (o), before (p), since (q) reads it) —
    ``train.make_train_step`` and the captured decodes
    (``train.graphs.Graphed``, the counterpart of ``jax.jit``) against
    their eager code (``graphs.disabled()``) at full width: the config-2
    step (B=128, T=512; 8 steps, one a replay) and 8 steps in one
    ``multi_step`` replay, the shared steps at configs 1, 3 and 5, the
    config-4 step (SGD, as the bench's), ``scrf_decode`` (B=128) and
    ``decode()`` at configs 2, 1, 3 and 5 (B=64): losses, gradient norms
    and parameters after 8 steps, paths, scores and segment markers equal
    bit for bit (or within rtol 1e-6 where a cuBLAS product differs under
    capture, said so), the same launch counts through the graph as
    eagerly (every count 0 before the compared call); then each path's ms
    a call eager and graph, and from a trace its device-busy share,
    kernels a call and host launches a call;
(t) multi-GPU (run last) — data parallelism on a group of ONE NCCL rank
    (``parallel.initialize_distributed`` with a ``FileStore``: the machine
    has one card, and NCCL runs one rank a GPU), which still issues every
    collective inside the step's CUDA graph: the config-2 step (B=128,
    T=512, rows full) and config 5's (K4, K5), 8 steps one a replay and 8
    in one ``multi_step``, through the data-parallel ``Trainer`` against the
    single-process compiled step of phase (s): losses, gradient norms,
    frame counts and parameters bit-equal, the same launch counts, and the
    step times beside each other; ``flagship.dryrun_multichip(1)`` (a
    spawned rank) and ``bench --scaling --check`` at n = 1; then the
    time-sharded decode at config 5 (``parallel.timeshard``, layout (i),
    N=8 chunks on the card): ``sharded_decode`` at B=64, T=512 against
    ``decode()`` (K8 and its traceback), and the long form B=4, T=16384
    exact and pruned (``beam_labels=12``, against K8 on
    ``survivor_mask``'s lattice, with the hand-set posterior model on
    phone-posterior frames: a random model's pruned lattice is dead):
    scores within rtol 1e-5, paths equal or both within it by rescoring
    (the near-tie rule); ``sharded_log_partition``
    against K6a's logZ (rtol 1e-5); the three sharded decodes' times beside
    ``decode()``'s at the same shapes, with the chunk product's share;
(u) precision (run before (t)) — the ``bf16x3`` and ``default`` modes of
    ``CrfConfig.precision`` (``bf16x3``: the products of K1-K3 as three
    bf16 products of a hi/lo split on the bf16 tensor cores; ``default``:
    one TF32 pass; the recursions fp32): the plane kernel (the flagship
    step's B=128, T=512 and P=128), the contraction in modes 0 (dWall) and
    1 (dfeats) on the flagship step's dplane, and K3's planes (the decode,
    B=64) against their plain versions at each mode; three config-2 train
    steps (B=128, T=512, a synthetic corpus) and a ``decode()`` at each
    mode from one start, the losses beside ``highest``'s and the PERs
    beside its PER; one config-5 shared step at ``bf16x3`` beside
    ``highest``; the train CLI at ``--optimizer lbfgs`` for 3 epochs, held
    to the JAX CPU losses and PER; the plane kernel, the contraction and
    K3's planes timed at each mode beside the plain version and one
    ``torch.mm`` with TF32 allowed (no single call computes ``bf16x3``),
    with their bounds at each mode, and the design each plane launch took
    (the counter ``kernels.plane_path``: ``wgmma`` at these shapes).

Every kernel's time stands beside its bound on this card: the largest of the
bytes it must move (each input read once, each output written once) over
the memory rate, its matrix products over the tensor cores' 3xTF32 rate
(495 / 3 TFLOP/s) and its other operations over the fp32 rate, from this
run's shapes (``asr_craft_tpu_torch.utils.roofline``: ``kernel_phase``,
``bound``; K15: ``calibrate_phase``, multiply-adds over the fp32 rate plus
exponentials over the special-function rate); phase (u)'s products at the
rate of their mode (``bf16x3``: 989 / 3 TFLOP/s, ``default``: 495).

Prints the card (``nvidia-smi``), the build time, one line per check, a
``{"kernels": [...]}`` JSON line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero, without the last line, if there is no CUDA device, if the
package is missing, or if any phase fails.  ``--only WORD`` (for work on one
family of kernels) runs the phases whose names hold WORD and exits 2 after
them, with their lines but no result line: only the whole run is a result
(``--only bench`` runs (p), (q) and (r)).
Writes its weight files and MLFs under
``asr_craft_tpu_torch/_build/chip_smoke/`` (git-ignored).
"""
from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "asr_craft_tpu_torch" / "_build" / "chip_smoke"
FRAME_S = 0.01                    # 10 ms frames
# Scores: fp32 sums over up to 512 frames of 145-term dots, accumulated in
# another order by cuBLAS (plain) than by the kernel's sequential FMAs.
SCORE_TOL = dict(rtol=1e-5, atol=1e-3)
FWD_SRC = "asr_craft_tpu/kernels/fdt_pallas.py:919"     # _fdt_vit_fwd_kernel
VIT_PLANE_SRC = "asr_craft_tpu/kernels/fdt_pallas.py:930"   # its _form call
TB_SRC = "asr_craft_tpu/kernels/fdt_pallas.py:1003"     # _fdt_vit_bwd_kernel
CU_SRC = "asr_craft_tpu_torch/csrc/fdt_viterbi.cu"
TRAIN_CU = "asr_craft_tpu_torch/csrc/fdt_train.cu"
MMA_CU = "asr_craft_tpu_torch/csrc/fdt_mma.cu"
TRAIN_SRC = {                       # (source, the TPU kernel code replaced)
    "fdt_train_fwd": (TRAIN_CU, "asr_craft_tpu/kernels/fdt_pallas.py:263"),
    "fdt_train_plane": (MMA_CU, "asr_craft_tpu/kernels/fdt_pallas.py:276 "
                                "and :354"),
    "fdt_train_bwd": (TRAIN_CU, "asr_craft_tpu/kernels/fdt_pallas.py:324"),
    "fdt_train_contract": (MMA_CU,
                           "asr_craft_tpu/kernels/fdt_pallas.py:466"),
}
# Log-partitions: sums over up to 512 frames of ~2.5e3 magnitude (fp32 ulp
# 2.4e-4 there); the plane kernel sums in 3xTF32 where the plain version
# takes cuBLAS's fp32 product, and the recursion takes a three-way lse and a
# shuffle tree where the plain loop chains logaddexp.  The same bar holds
# the recursion alone on the same planes.
Z_TOL = dict(rtol=1e-5, atol=1e-3)
# dplane holds posteriors (|v| <= |w| = 1) gated by exp(s - z), where s - z
# is a difference of two such sums: ~1e-4 relative error at worst.
DPLANE_ATOL = 1e-3
# dWall / dfeats / parameter gradients: sums over B*T = 65,536 frames in
# another order; held to their largest entry (REL_MAX of it) and RTOL.
REL_MAX, RTOL = 1e-4, 1e-3
# The planes and the contraction alone, on the same inputs: 3xTF32 keeps
# ~2^-21 of each term, and the sums run in another order.
CONTRACT_REL_MAX = 1e-5
# The JAX package's crf-train on the CPU with the same flags
# (asr_craft_tpu.cli.train --platform cpu): per-epoch mean_loss and the
# final CV PER (81 errors in 484 tokens).
JAX_TRAIN_LOSSES = (1.1025186777114868, 1.056251883506775,
                    1.0076534748077393)
JAX_TRAIN_PER = 0.16735537190082644
TRAIN_FLAGS = ["--synthetic_utts", "256", "--crf_label_size", "48",
               "--crf_states", "3", "--window_extent", "1",
               "--crf_transftr_end", "144", "--batch_size", "64",
               "--crf_epochs", "3", "--crf_lr", "0.5", "--seed", "0"]
# The same run with --optimizer lbfgs (optax.scale_by_lbfgs, no line
# search): the JAX CPU CLI's per-epoch mean_loss and final CV PER (18 errors
# in 484 tokens).
JAX_LBFGS_LOSSES = (0.8132341504096985, 0.13798797130584717,
                    0.05851224064826965)
JAX_LBFGS_PER = 0.0371900826446281
# Phase (u): the precisions' kernels against their plain versions on the
# same inputs.  Both round the operands alike (ops/precision.py), so every
# product is exact in fp32 and only the order of the fp32 sums differs.
# The planes (145 terms): each entry within CONTRACT_REL_MAX of the float64
# sum of its terms' magnitudes.  The contraction over the step's dplane (up
# to 65,536 frames, 4,096 a chunk, terms of one sign): the bar phase (d)
# holds the highest contraction to (RTOL, and REL_MAX of the largest entry),
# since the tensor cores' fp32 accumulation drops low bits at every k-step
# and, on terms of one sign, the losses add up.
# The steps' losses
# at bf16x3 and default against highest: JAX's bar for bf16x3 (nll rtol
# 2e-3, tests/kernels/test_fdt_pallas.py), the PER within 0.01.
PREC_LOSS_RTOL, PREC_PER_TOL = 2e-3, 0.01
# (errors, tokens) of the JAX package's CPU decode of the same hand-set model
# and corpus (asr_craft_tpu.cli.decode --platform cpu, same flags): PER
# 568/2420 = 0.2347, byte-identical MLF to the port's.
JAX_REFERENCE = (568, 2420)
SHARED_CU = "asr_craft_tpu_torch/csrc/viterbi.cu"
SHARED_SRC = {                      # the TPU kernels they replace
    "viterbi_dense_fwd": "asr_craft_tpu/kernels/viterbi_pallas.py:74",
    "viterbi_nstate_fwd": "asr_craft_tpu/kernels/viterbi_pallas.py:235",
    "viterbi_traceback": "asr_craft_tpu/kernels/viterbi_pallas.py:108",
}
# The shared-transition configs: (window, recipe decode flags) and the
# (errors, tokens) of the JAX package's CPU decode (asr_craft_tpu.cli.decode
# --platform cpu) of 128 synthetic utterances, batch 64, with
# flagship.posterior_model(cfg, window) (transitions 0.01 * N(0, 1): a model
# that switches phones almost every frame, hence PER > 1 for the monophone
# configs; a parity check, not a quality figure).  MLFs byte-identical to
# the port's CPU decode.
SHARED = {
    "config1": (1, [], (9235, 2402)),
    "config3": (2, ["--normalize", "utt", "--beam_threshold", "8"],
                (10561, 2445)),
    "config5": (2, ["--normalize", "global"], (562, 2374)),
}
# The JAX CLI's --lexicon word decode (--fst_backend py) of
# flagship.word_corpus's 10 test utterances with posterior_model at window
# 0: WER 0/33 and these words.
JAX_WORDS = ("utt000000 w02 w05 w02\n"
             "utt000001 w03 w01 w04 w02 w04 w01\n"
             "utt000002 w02 w03 w05\n"
             "utt000003 w04 w01 w00\n"
             "utt000004 w05 w02\n"
             "utt000005 w04 w02 w02\n"
             "utt000006 w05 w01\n"
             "utt000007 w00 w02 w01 w00 w05 w04\n"
             "utt000008 w02 w03 w02\n"
             "utt000009 w04 w03\n")
JAX_WORD_ERRORS = (0, 33)
FB_CU = "asr_craft_tpu_torch/csrc/fwdbwd.cu"
FB_MMA_CU = "asr_craft_tpu_torch/csrc/fwdbwd_mma.cu"
FB_SRC = {                          # the TPU kernel bodies they replace
    "forward": "asr_craft_tpu/kernels/fwdbwd_pallas.py:65",
    "backward": "asr_craft_tpu/kernels/fwdbwd_pallas.py:136",
    "forward_dual": "asr_craft_tpu/kernels/dual_pallas.py:39",
    "backward_dual": "asr_craft_tpu/kernels/dual_pallas.py:134",
    "backward_dual_grad": "asr_craft_tpu/kernels/dual_pallas.py:172",
    # K5's U^T V (uv_acc += dot_general), on the tensor cores here
    "backward_dual_contract": "asr_craft_tpu/kernels/dual_pallas.py:226",
}
# Alphas, betas and logZ: sums over up to 512 frames, ~1e3 in magnitude
# (fp32 ulp 6e-5 there); the kernel splits each sum over four lanes and
# takes expf / logf where the plain version takes a cuBLAS product and
# torch.exp / torch.log.
FB_Z_TOL = dict(rtol=1e-5, atol=2e-3)
# g_state holds posteriors times |w| = 1, each the exp of a difference of
# such sums: ~1e-4 relative at worst, on values <= 1.  The free lattice's
# posteriors are ~7e-3 at L' = 138, so the bar must sit well under that:
# twice the largest difference seen on this card (2.6e-4).
FB_G_ATOL = 5e-4
# The JAX package's crf-train on the CPU (asr_craft_tpu.cli.train --platform
# cpu) with each recipe's model and optimizer flags, 256 synthetic
# utterances, 3 epochs, seed 0: per-epoch mean_loss and the final CV PER.
SHARED_TRAIN = {                    # (model flags, optimizer flags, ...)
    "config1": (["--crf_label_size", "48", "--crf_states", "1",
                 "--window_extent", "1"],
                ["--crf_lr", "0.5", "--crf_lr_decay", "0.9", "--batch_size",
                 "32"],
                (3.7838029861450195, 3.5888805389404297, 3.416109561920166),
                0.3306613226452906),
    "config3": (["--crf_label_size", "42", "--crf_states", "1",
                 "--window_extent", "2", "--normalize", "utt"],
                ["--crf_lr", "0.05", "--crf_lr_decay", "0.85",
                 "--batch_size", "48"],
                (3.7067105770111084, 3.633991003036499, 3.572345018386841),
                0.515748031496063),
    "config5": (["--crf_label_size", "46", "--crf_states", "3",
                 "--window_extent", "2", "--normalize", "global"],
                ["--crf_lr", "0.03", "--crf_lr_decay", "0.9", "--batch_size",
                 "64", "--bucket_sizes", "256,512,1024,2048"],
                (1.1079281568527222, 1.0945173501968384, 1.0828857421875),
                0.09285714285714286),
}
SHARED_TRAIN_CORPUS = ["--synthetic_utts", "256", "--crf_epochs", "3",
                       "--seed", "0"]
SEG_CU = "asr_craft_tpu_torch/csrc/segmental.cu"
SEG_SRC = {                         # the TPU kernel bodies they replace
    "segmental_forward": "asr_craft_tpu/kernels/segmental_pallas.py:71",
    "segmental_backward": "asr_craft_tpu/kernels/segmental_pallas.py:257",
    # K11 in three parts: the message (the PT_ref dot of its body), the xi
    # pass (the body), gt (gt_ref += dot_general), on the tensor cores here
    "segmental_grad_message": "asr_craft_tpu/kernels/segmental_pallas.py:478",
    "segmental_grad": "asr_craft_tpu/kernels/segmental_pallas.py:382",
    "segmental_grad_contract":
        "asr_craft_tpu/kernels/segmental_pallas.py:465",
    "segmental_viterbi": "asr_craft_tpu/kernels/segmental_pallas.py:616",
    "segmental_viterbi_traceback":
        "asr_craft_tpu/kernels/segmental_pallas.py:748",
}
# A and S hold pooled segment posteriors times |g| = 1, each the exp of a
# difference of sums ~1e3 in magnitude at T = 512: ~1e-4 relative.  Four
# times the largest difference seen on this card (1.3e-4).
SEG_G_ATOL = 5e-4
# The JAX package's recipe on the CPU (recipes/scrf.py --utts 60 --eval_utts
# 600 --epochs 300 --platform cpu): the logged losses by epoch and the
# held-out eval (453 errors in 6392 tokens: sub 80, ins 110, del 263).
SCRF_FLAGS = ["--utts", "60", "--eval_utts", "600"]
JAX_SCRF_LOSSES = {
    0: 2.5630927085876465, 25: 0.7011288404464722, 50: 0.46663135290145874,
    75: 0.3654933273792267, 100: 0.30418962240219116,
    125: 0.2624880373477936, 150: 0.2322712391614914,
    175: 0.2093581110239029, 200: 0.19136327505111694,
    225: 0.17683425545692444, 250: 0.1648397594690323,
    275: 0.15475565195083618, 299: 0.14646832644939423}
JAX_SCRF_PER, JAX_SCRF_TOKENS = 0.07086983729662077, 6392
CAL_CU = "asr_craft_tpu_torch/csrc/calibrate.cu"
CAL_SRC = "asr_craft_tpu/utils/roofline.py:519"   # the inner `kernel`
# K15 against its plain version: nvcc fuses z * 0.999 + 1e-4 into one
# multiply-add where PyTorch rounds twice, and the chain is a contraction,
# so the gap stays at a few 1e-8 relative on values in (0, 1].
CAL_ATOL = 2e-6
# Per-frame costs the T-sweep fits are held to (+-30%), from PERF.md: the
# config-2 decode (the plane kernel on its wgmma path, K3's recursion on a
# cluster of two blocks an utterance and the traceback, its rows streamed
# through shared memory) is 1.241 us a frame at B=64; the segmental decode
# at one segment a frame (the bench's zero model), K12 on K9's frame and
# K13 on the traceback's stream, is 0.852 us.
FDT_FRAME_US, SCRF_FRAME_US = 1.241, 0.852
# The time-sharded decode's scores against the unsharded decode's (phase
# (t)): rtol 1e-5 at T=512, as the JAX tests hold them; at T=16384 the two
# fp32 sums of 16,384 frames, associated chunk by chunk and frame by frame,
# drift ~sqrt(T) eps relative apart (7.7e-6) with a heavy tail (a 0.334
# difference seen on an H100 where 1e-5 allowed less): 1e-4.  Paths are held
# equal, or both within SHARD_RTOL by rescoring.
SHARD_RTOL, SHARD_LONG_RTOL = 1e-5, 1e-4
# The JAX package's recipes on the CPU at their own sizes (python
# recipes/<name>.py --platform cpu): per-epoch mean_loss, the final CV PER
# and the decode's (errors, tokens); swbd_multihost does not decode.
JAX_RECIPES = {
    "timit_mono": (
        (3.7217633724212646, 3.4133148193359375, 3.148581027984619,
         2.917658805847168, 2.724485158920288, 2.546931743621826,
         2.4048452377319336, 2.2803666591644287, 2.1560726165771484,
         2.0665929317474365, 1.984771490097046, 1.9073097705841064,
         1.8321545124053955, 1.7853820323944092, 1.7311973571777344,
         1.6906898021697998, 1.6430723667144775, 1.6141828298568726,
         1.582660436630249, 1.5576300621032715),
        0.1492361927144536, (151, 967)),
    "timit_triphone": (
        (1.1215606927871704, 1.1149563789367676, 1.107577919960022,
         1.1037689447402954, 1.09769606590271, 1.092675805091858,
         1.0895310640335083, 1.0872814655303955, 1.082550287246704,
         1.0800095796585083, 1.078734278678894, 1.0738489627838135),
        0.17026378896882494, (93, 929)),
    "wsj_crandem": (
        (3.7008109092712402, 3.6158447265625, 3.546869993209839,
         3.4888088703155518, 3.4375131130218506, 3.395601749420166,
         3.3651163578033447, 3.332920551300049, 3.3059747219085693,
         3.2846665382385254, 3.267786741256714, 3.2526094913482666,
         3.2379727363586426, 3.2325003147125244, 3.2282912731170654),
        0.6394422310756972, (459, 996)),
    "swbd_multihost": (
        (1.0995190143585205, 1.0728946924209595, 1.0527453422546387,
         1.0345604419708252, 1.0154149532318115, 0.9970547556877136,
         0.9781779050827026, 0.9706317186355591),
        0.07533414337788578, None),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# each kernel family's kernels; a wrapper counts its launches in the
# diagnostics counter kernels.<kernel>, or kernels.<kernel>[<design>]
FAMILIES = {
    "fdt_viterbi": ("fdt_viterbi_plane", "fdt_viterbi_fwd",
                    "fdt_viterbi_traceback"),
    "fdt_train": ("fdt_train_fwd", "fdt_train_plane", "fdt_train_bwd",
                  "fdt_train_contract"),
    "viterbi": ("viterbi_dense_fwd", "viterbi_nstate_fwd",
                "viterbi_traceback"),
    "fwdbwd": ("forward", "backward", "forward_dual", "backward_dual",
               "backward_dual_grad", "backward_dual_contract"),
    "segmental": ("segmental_forward", "segmental_backward",
                  "segmental_grad_message", "segmental_grad",
                  "segmental_grad_contract", "segmental_viterbi",
                  "segmental_viterbi_traceback"),
    "calibrate": ("calibrate",),
}


def launches(*families, since=None) -> dict:
    """``{kernel: launches}`` for every kernel of ``families`` (all where
    none is named), each kernel's designs summed, from the launch
    counters; less ``since``, an earlier reading of the same families."""
    from asr_craft_tpu_torch.utils import diagnostics
    out = {k: -(since or {}).get(k, 0)
           for f in families or FAMILIES for k in FAMILIES[f]}
    for name, n in diagnostics.launches().items():
        k = name[len(diagnostics.LAUNCHES):].split("[")[0]
        if k in out:
            out[k] += n
    return out


class Smoke:
    B, T = 64, 512                        # the flagship decode batch

    def __init__(self, torch):
        from asr_craft_tpu_torch.flagship import flagship
        from asr_craft_tpu_torch.kernels import fdt_viterbi as K
        from asr_craft_tpu_torch.kernels import wall
        from asr_craft_tpu_torch.ops import fdt
        from asr_craft_tpu_torch.utils import roofline
        self.torch, self.K, self.fdt, self.wall = torch, K, fdt, wall
        self.rl = roofline          # the one definition of a kernel's bound
        self.dev = torch.device("cuda")
        self.cfg = flagship()
        self.err = {"fdt_viterbi_plane": 0.0, "fdt_viterbi_fwd": 0.0,
                    "fdt_viterbi_traceback": 0, "fdt_train_fwd": 0.0,
                    "fdt_train_plane": 0.0, "fdt_train_bwd": 0.0,
                    "fdt_train_contract": 0.0}
        self.counts = {}
        self.train_counts = {}
        self.shared_counts = {}
        self.fb_counts = {}
        self.seg_counts = {}
        self.bench_counts = {}
        self.busy = {}              # device-busy ms a call, by device_share
        self.compiled = {}          # phase (s): each path's rows
        self.compiled_counts = {}
        self.multigpu = {}          # phase (t)'s rows
        self.times = {}
        self.bounds = {}
        self.library_ms = {}
        self.err.update({k: 0.0 for k in SHARED_SRC})
        self.err.update({k: 0.0 for k in FB_SRC})
        self.err.update({k: 0.0 for k in SEG_SRC})
        self.err["calibrate"] = 0.0

    def bound(self, name, **shape):
        """(bound_ms, bound_by) of kernel ``name`` at ``shape``."""
        return self.rl.bound(self.rl.kernel_phase(name, **shape))

    # -- (a) parity ---------------------------------------------------------
    def problem(self, cfg, B, T, seed):
        from asr_craft_tpu_torch.flagship import ragged_lengths, tiny_batch
        torch = self.torch
        params = cfg.init_params(torch.Generator().manual_seed(seed), 0.01,
                                 self.dev)
        feats = tiny_batch(cfg, B, T, seed, self.dev)["feats"]
        lengths = torch.from_numpy(ragged_lengths(B, T, seed)).to(self.dev)
        Wall, u0, u1, dims = self.wall.build_wall(params, cfg.fmap,
                                               cfg.num_states)
        kw = dict(u0=u0, u1=u1, ns=cfg.num_states, P=dims["P"],
                  boundaries=True)
        return Wall, feats, lengths, kw

    def check(self, label, Wall, feats, lengths, kw, beams):
        from asr_craft_tpu_torch.kernels.fdt_train import (fdt_planes_cuda,
                                                           fdt_planes_torch)
        torch, K, fdt = self.torch, self.K, self.fdt
        ns, P = kw["ns"], kw["P"]
        planes = self.wall.wall_planes(Wall, feats, kw["u0"], kw["u1"], ns,
                                       P)
        ref_bp, ref_last, ref_scores = fdt.fdt_viterbi_forward(
            *planes, lengths, ns, True, beams.get("beam_width"),
            beams.get("beam_threshold"))
        ref_paths = fdt.fdt_viterbi_traceback(ref_bp, ref_last, lengths)
        bp, last, scores = K.viterbi_forward_cuda(Wall, feats, lengths,
                                                  **kw, **beams)
        paths = K.viterbi_traceback_cuda(bp, last, lengths)
        tb_paths = K.viterbi_traceback_cuda(ref_bp, ref_last, lengths)
        torch.cuda.synchronize()
        if not (torch.isfinite(scores).all() and paths.min() >= 0
                and paths.max() < ns * P):
            raise AssertionError(f"{label}: non-finite scores or bad labels")
        err = float((scores - ref_scores).abs().max())
        if not torch.allclose(scores, ref_scores, **SCORE_TOL):
            raise AssertionError(f"{label}: scores differ, max abs {err}")
        # near-tie rule: a differing path must score (on the plain planes)
        # within the tolerance of the plain optimum
        diff = (paths != ref_paths).any(dim=1)
        n_diff = int(diff.sum())
        if n_diff:
            if bool((diff & (lengths == 0)).any()):
                raise AssertionError(f"{label}: empty row paths differ")
            rescored = fdt.path_score(*planes, paths, lengths, ns, True)
            if not torch.allclose(rescored[diff], ref_scores[diff],
                                  **SCORE_TOL):
                raise AssertionError(f"{label}: {n_diff} paths differ and "
                                     "are not near-ties")
        tb_err = int((tb_paths - ref_paths).abs().max())
        if tb_err:
            raise AssertionError(f"{label}: traceback kernel differs on the "
                                 "plain backpointers")
        # the plane kernel against cuBLAS's fp32 product, then the recursion
        # alone against its plain version on the plane kernel's planes: only
        # the recursion's arithmetic differs, the same fp32 additions in the
        # same order
        kplanes = fdt_planes_cuda(Wall, feats, u0=kw["u0"], u1=kw["u1"])
        rplanes = fdt_planes_torch(Wall, feats, u0=kw["u0"], u1=kw["u1"])
        R = rplanes.shape[-1]
        p_err = self.close(f"{label} planes", kplanes[..., :R], rplanes, 0.0,
                           CONTRACT_REL_MAX * float(rplanes.abs().max()))
        B, T, Lp = bp.shape
        sbp = torch.empty_like(bp)
        slast, sscores = torch.empty_like(last), torch.empty_like(scores)
        K.viterbi_forward_planes_cuda(kplanes, lengths, sbp, slast, sscores,
                                      ns=ns, P=P, **beams)
        spaths = K.viterbi_traceback_cuda(sbp, slast, lengths)
        rpaths, rscores = K.fdt_viterbi_planes_torch(kplanes, lengths, ns=ns,
                                                     P=P, **beams)
        torch.cuda.synchronize()
        s_err = float((sscores - rscores).abs().max())
        if not torch.equal(spaths, rpaths):
            raise AssertionError(f"{label}: the recursion's paths differ from "
                                 "the plain version's on the same planes")
        if not torch.allclose(sscores, rscores, rtol=1e-6, atol=0.0):
            raise AssertionError(f"{label}: the recursion's scores differ "
                                 f"on the same planes, max abs {s_err}")
        self.err["fdt_viterbi_plane"] = max(self.err["fdt_viterbi_plane"],
                                            p_err)
        self.err["fdt_viterbi_fwd"] = max(self.err["fdt_viterbi_fwd"], s_err)
        self.err["fdt_viterbi_traceback"] = max(
            self.err["fdt_viterbi_traceback"], tb_err)
        log(f"parity {label}: max |score - plain| {err:.3e}, "
            f"paths differing {n_diff}/{len(paths)} (near-ties), "
            f"traceback exact; |planes - matmul| {p_err:.3e}; on the same "
            f"planes paths equal, max |score - plain| {s_err:.3e}")

    def phase_parity(self):
        from asr_craft_tpu_torch.models.crf import CrfConfig
        Wall, feats, lengths, kw = self.problem(self.cfg, self.B, self.T,
                                                seed=0)
        for label, beams in (("flagship exact", {}),
                             ("flagship beam_threshold=8",
                              {"beam_threshold": 8.0}),
                             ("flagship beam_width=16", {"beam_width": 16})):
            self.check(label, Wall, feats, lengths, kw, beams)
        big = CrfConfig(num_labels=128, feat_dim=16, num_states=3,
                        trans_range=(0, 16))
        Wall, feats, lengths, kw = self.problem(big, 4, 24, seed=1)
        self.check("P=128 ns=3 exact", Wall, feats, lengths, kw, {})
        self.check("P=128 ns=3 beam_width=40", Wall, feats, lengths, kw,
                   {"beam_width": 40})

    # -- (b) end to end -----------------------------------------------------
    def run_cli(self, argv):
        from asr_craft_tpu_torch.cli.decode import main
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        self.torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        for ln in lines:
            log(f"  cli: {ln}")
        done = [json.loads(ln) for ln in lines if '"decode_done"' in ln]
        if rc != 0 or len(done) != 1:
            raise AssertionError(f"decode CLI rc={rc}, output {lines}")
        return done[0], secs

    def phase_decode(self):
        from asr_craft_tpu_torch import kernels
        from asr_craft_tpu_torch.flagship import posterior_model
        from asr_craft_tpu_torch.models.weights import (params_from_numpy,
                                                        save_raw)
        K = self.K
        OUT.mkdir(parents=True, exist_ok=True)
        wfile = OUT / "posterior_model.dat"
        save_raw(wfile, self.cfg.fmap,
                 params_from_numpy(posterior_model(self.cfg)))
        argv = ["--synthetic_utts", "128", "--crf_label_size", "48",
                "--crf_states", "3", "--window_extent", "1",
                "--crf_transftr_end", "144", "--batch_size", "64",
                "--weight_file", str(wfile), "--device", "cuda"]
        mark = launches("fdt_viterbi")
        rec, secs = self.run_cli(argv + ["--kernel_backend", "auto",
                                         "--out_mlf", str(OUT / "auto.mlf")])
        self.counts = launches("fdt_viterbi", since=mark)
        mark = launches("fdt_viterbi")
        rec_t, secs_t = self.run_cli(argv + ["--kernel_backend", "torch",
                                             "--out_mlf",
                                             str(OUT / "torch.mlf")])
        plain_counts = launches("fdt_viterbi", since=mark)
        kernels.set_backend("auto")
        log(f"decode CLI: per {rec['per']} (kernels, {secs:.3f} s wall, "
            f"launches {self.counts}); per {rec_t['per']} (plain, "
            f"{secs_t:.3f} s wall, launches {plain_counts})")
        if not rec["per"] < 0.4:
            raise AssertionError(f"PER {rec['per']} >= 0.4")
        if (rec["errors"], rec["tokens"]) != JAX_REFERENCE:
            raise AssertionError(f"errors/tokens {rec['errors']}/"
                                 f"{rec['tokens']}, JAX reference "
                                 f"{JAX_REFERENCE}")
        if min(self.counts.values()) < 1:
            raise AssertionError(f"a kernel never launched: {self.counts}")
        if max(plain_counts.values()) != 0:
            raise AssertionError(f"plain backend launched {plain_counts}")
        if rec["per"] != rec_t["per"]:
            raise AssertionError("kernel and plain PER differ")
        if (OUT / "auto.mlf").read_bytes() != (OUT / "torch.mlf").read_bytes():
            raise AssertionError("kernel and plain MLFs differ")
        log("decode CLI: kernel and plain backends give the same PER and "
            "MLF; errors/tokens equal the JAX reference")

    # -- (c) timing ---------------------------------------------------------
    def cuda_ms(self, fn, reps):
        torch = self.torch
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

    def kernel_ms(self, fn, match):
        """Device ms of the one launch a call of ``fn`` makes of the kernel
        whose name holds ``match``, from a ``torch.profiler`` trace
        (``utils/ab_timing.launch_ms``): a kernel's own time where events
        around back-to-back calls would read its wrapper's host time (the
        tracebacks: ~0.02 ms of device work, more of Python)."""
        from asr_craft_tpu_torch.utils.ab_timing import launch_ms
        return launch_ms(self.dev, fn, match)

    def device_share(self, label, fn, reps=5):
        """Trace ``reps`` calls of ``fn`` with torch.profiler
        (``bench.device_busy``) and log the wall time per call, the time
        the device was busy in it and the kernels that took most of that."""
        from asr_craft_tpu_torch.bench import device_busy
        rec = device_busy(fn, self.dev, reps)
        if rec is None:
            log(f"device share {label}: not measured (the trace holds no "
                "device time)")
            return
        self.busy[label] = rec["busy_ms"]
        log(f"device share {label}: {rec['wall_ms']:.4f} ms wall per call "
            f"(traced), device busy {rec['busy_ms']:.4f} ms in "
            f"{rec['kernels']} kernels ({rec['pct']:.1f}%); most of it: "
            + "; ".join(f"{k} {ms:.4f} ms x{n}" for k, ms, n in rec["top"]))

    def phase_timing(self):
        from asr_craft_tpu_torch.kernels.fdt_train import (fdt_planes_cuda,
                                                           fdt_planes_torch)
        from asr_craft_tpu_torch.models.crf import decode
        torch, K, fdt, cfg = self.torch, self.K, self.fdt, self.cfg
        B, T = self.B, self.T
        Wall, feats, _, kw = self.problem(cfg, B, T, seed=0)
        lengths = torch.full((B,), T, dtype=torch.int32, device=self.dev)
        params = cfg.init_params(torch.Generator().manual_seed(0), 0.01,
                                 self.dev)
        ns, P, u0, u1 = kw["ns"], kw["P"], kw["u0"], kw["u1"]

        def plain_fwd(**beams):
            return fdt.fdt_viterbi_forward(
                *self.wall.wall_planes(Wall, feats, u0, u1, ns, P), lengths,
                ns, True, beams.get("beam_width"),
                beams.get("beam_threshold"))

        planes = fdt_planes_cuda(Wall, feats, u0=u0, u1=u1)
        blocks = self.wall.plane_blocks(planes, ns, P)
        out = [torch.empty((B, T, ns * P), dtype=torch.int32,
                           device=self.dev),
               torch.empty((B,), dtype=torch.int32, device=self.dev),
               torch.empty((B,), dtype=torch.float32, device=self.dev)]

        def recursion(**beams):
            return lambda: K.viterbi_forward_planes_cuda(
                planes, lengths, *out, ns=ns, P=P, **beams)

        def plain_recursion(**beams):
            return lambda: fdt.fdt_viterbi_forward(
                *blocks, lengths, ns, True, beams.get("beam_width"),
                beams.get("beam_threshold"))

        bp, last, _ = plain_fwd()
        # the library's call for the planes' product on the same inputs,
        # [x; 1] made before the clock starts
        xu2 = self.wall.feats_xu(feats, u0, u1).reshape(B * T, u1 - u0 + 1)
        library = {"fdt_viterbi_plane": lambda: torch.mm(xu2, Wall.T)}
        fns = {
            "fdt_viterbi_plane": (
                lambda: fdt_planes_cuda(Wall, feats, u0=u0, u1=u1),
                lambda: fdt_planes_torch(Wall, feats, u0=u0, u1=u1), 10, 3),
            "fdt_viterbi_fwd": (recursion(), plain_recursion(), 10, 3),
            "fdt_viterbi_fwd beam_width=16": (
                recursion(beam_width=16), plain_recursion(beam_width=16), 10,
                3),
            "K3 forward (planes + recursion)": (
                lambda: K.viterbi_forward_cuda(Wall, feats, lengths, **kw),
                plain_fwd, 10, 3),
            "fdt_viterbi_traceback": (
                lambda: K.viterbi_traceback_cuda(bp, last, lengths),
                lambda: fdt.fdt_viterbi_traceback(bp, last, lengths), 20, 3),
            "decode": (
                lambda: decode(cfg, params, feats, lengths),
                lambda: self._plain_decode(cfg, params, feats, lengths),
                10, 3),
        }
        audio_s = B * T * FRAME_S
        shape = dict(B=B, T=T, L=ns * P, D=feats.shape[2], ns=ns,
                     Du=u1 - u0, frames=int(lengths.sum()))
        for name in ("fdt_viterbi_plane", "fdt_viterbi_fwd"):
            self.bounds[name] = self.bound(name, **shape)
        self.bounds["fdt_viterbi_traceback"] = self.bound(
            "fdt_viterbi_traceback", B=B, T=T)
        for name, (kern, plain, nk, npl) in fns.items():
            # plain, kernel, kernel, plain: compare within one call only
            p1 = self.cuda_ms(plain, npl)
            k1 = self.cuda_ms(kern, nk)
            k2 = self.cuda_ms(kern, nk)
            p2 = self.cuda_ms(plain, npl)
            ms, plain_ms = min(k1, k2), min(p1, p2)
            self.times[name] = (ms, plain_ms)
            tail = ""
            if name in library:
                # cuBLAS in fp32 (allow_tf32 is off), timed twice
                lib_ms = min(self.cuda_ms(library[name], 10),
                             self.cuda_ms(library[name], 10))
                self.library_ms[name] = lib_ms
                tail = f"; cuBLAS fp32 mm {lib_ms:.4f} ms"
            if name in self.bounds:
                b_ms, b_by = self.bounds[name]
                tail += f"; bound {b_ms:.5f} ms ({b_by})"
            log(f"timing {name} B={B} T={T}: kernel {ms:.4f} ms "
                f"({k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms "
                f"({p1:.4f}, {p2:.4f}); {audio_s / ms * 1e3:.1f} vs "
                f"{audio_s / plain_ms * 1e3:.1f} audio-s/s{tail}")
        # The traceback's own device time (its events read the wrapper's
        # host time): on L2-resident backpointers, right after the forward
        # has written them, and inside decode(); and us a dependent step.
        tb = "fdt_vit_tb_kernel"
        resident = self.kernel_ms(
            lambda: K.viterbi_traceback_cuda(bp, last, lengths), tb)
        fresh = self.kernel_ms(lambda: K.viterbi_traceback_cuda(
            *K.viterbi_forward_cuda(Wall, feats, lengths, **kw)[:2],
            lengths), tb)
        in_decode = self.kernel_ms(
            lambda: decode(cfg, params, feats, lengths), tb)
        self.times["fdt_viterbi_traceback"] = (
            resident, self.times["fdt_viterbi_traceback"][1])
        log(f"timing fdt_viterbi_traceback B={B} T={T} L'={ns * P} (trace, "
            f"C = {K.traceback_frames(ns * P)} frames a stream block): "
            f"{resident:.4f} ms on L2-resident backpointers "
            f"({resident * 1e3 / T:.4f} us a dependent step), {fresh:.4f} "
            f"ms right after the forward wrote them ({fresh * 1e3 / T:.4f} "
            f"us a step), {in_decode:.4f} ms inside decode() "
            f"({in_decode * 1e3 / T:.4f} us a step)")

    def _plain_decode(self, cfg, params, feats, lengths):
        from asr_craft_tpu_torch import kernels
        from asr_craft_tpu_torch.models.crf import decode
        kernels.set_backend("torch")
        try:
            return decode(cfg, params, feats, lengths)
        finally:
            kernels.set_backend("auto")

    # -- (d) training parity -------------------------------------------------
    def train_problem(self, cfg, B, T, seed, state_labels, dead_row=True):
        """Params at scale 0.01, N(0, 1) frames, topology-legal labels
        (phone runs of 4 frames, or the state walk [0, 0, 1, 2] of each
        run), ragged lengths with an empty last row and (``dead_row``) row
        1 cut to 6 frames: inside its second run, so its clamped lattice is
        dead."""
        from asr_craft_tpu_torch.flagship import ragged_lengths, tiny_batch
        torch = self.torch
        params = cfg.init_params(torch.Generator().manual_seed(seed), 0.01,
                                 self.dev)
        batch = tiny_batch(cfg, B, T, seed, self.dev)
        labels = batch["labels"]
        if state_labels:
            walk = torch.tensor([0, 0, 1, 2], dtype=torch.int32,
                                device=self.dev).repeat(T // 4)
            labels = (labels * cfg.num_states + walk).contiguous()
        lengths = ragged_lengths(B, T, seed)
        if dead_row:
            lengths[1] = 6
        return (params, batch["feats"], labels,
                torch.from_numpy(lengths).to(self.dev))

    def close(self, label, got, want, rtol, atol):
        torch = self.torch
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite values")
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"{label}: max abs difference {err} "
                                 f"(rtol {rtol}, atol {atol:.3e})")
        return err

    def check_train(self, label, cfg, B, T, seed, state_labels=False,
                    grad_feats=False):
        from asr_craft_tpu_torch.kernels import fdt_train as K
        torch = self.torch
        params, feats, labels, lengths = self.train_problem(
            cfg, B, T, seed, state_labels)
        Wall, u0, u1, dims = self.wall.build_wall(params, cfg.fmap,
                                                  cfg.num_states)
        kw = dict(u0=u0, u1=u1, ns=cfg.num_states, P=dims["P"],
                  clamp_ns=1 if state_labels else cfg.num_states,
                  boundaries=True)
        args = (Wall, feats, labels, lengths)
        before = launches("fdt_train")
        alphas, zf, zc, planes = K.fdt_forward_cuda(*args, **kw)
        ra, rzf, rzc = K.fdt_forward_wall_torch(*args, **kw)
        z_err = max(self.close(f"{label} zf", zf, rzf, **Z_TOL),
                    self.close(f"{label} zc", zc, rzc, **Z_TOL))
        if not (float(zc[1]) < -1e29 < float(zf[1])):
            raise AssertionError(f"{label}: row 1's clamped lattice is not "
                                 f"dead (zf {float(zf[1])}, zc "
                                 f"{float(zc[1])})")
        R = Wall.shape[0]
        rplanes = K.fdt_planes_torch(Wall, feats, u0=u0, u1=u1)
        p_err = self.close(f"{label} planes", planes[..., :R], rplanes, 0.0,
                           CONTRACT_REL_MAX * float(rplanes.abs().max()))
        if planes[..., R:].any():
            raise AssertionError(f"{label}: the planes' pad is not zero")
        del rplanes
        # K1's recursion alone, on the plane kernel's planes
        rec = dict(ns=kw["ns"], P=kw["P"], clamp_ns=kw["clamp_ns"],
                   boundaries=True)
        sa, szf, szc = K.fdt_forward_planes_cuda(planes, labels, lengths,
                                                 **rec)
        qa, qzf, qzc = K.fdt_forward_planes_torch(planes, labels, lengths,
                                                  **rec)
        s_err = max(self.close(f"{label} alphas on the same planes", sa, qa,
                               **Z_TOL),
                    self.close(f"{label} zf on the same planes", szf, qzf,
                               **Z_TOL),
                    self.close(f"{label} zc on the same planes", szc, qzc,
                               **Z_TOL))
        del sa, qa
        wf, wc = torch.ones_like(zf), -torch.ones_like(zf)   # d(zf - zc)
        grad_args = args + (ra, rzf, rzc, wf, wc)
        dplane = K.fdt_dplane_cuda(*grad_args, **kw, planes=planes)
        rdplane = K.fdt_dplane_wall_torch(*grad_args, **kw)
        dp_err = self.close(f"{label} dplane", dplane, rdplane, 0.0,
                            DPLANE_ATOL)
        del rdplane
        dWs = []
        for _ in range(2):          # the same bits on every run
            dWs.append(torch.full((R, u1 - u0 + 1), float("nan"),
                                  device=self.dev))
            K.contract_cuda(dplane, feats, dWs[-1], mode=0,
                            D=feats.shape[2], u0=u0, Du=u1 - u0)
        if not torch.equal(dWs[0], dWs[1]):
            raise AssertionError(f"{label}: dWall differs between two runs")
        ref = K.contract_wall_torch(dplane, feats, mode=0, u0=u0, u1=u1)
        c_err = self.close(f"{label} contraction", dWs[0], ref, 0.0,
                           CONTRACT_REL_MAX * float(ref.abs().max()))
        mid = launches("fdt_train")
        out = K.fdt_backward_grad_cuda(*args, alphas, zf, zc, wf, wc, **kw,
                                       want_dfeats=grad_feats, planes=planes)
        # K1 whole (one plane kernel) and the recursion alone (K1's kernel
        # twice in all); then K2 handed K1's planes: no plane kernel
        ran = {k: mid[k] - before[k] for k in before}
        ran2 = launches("fdt_train", since=mid)
        if (ran["fdt_train_plane"], ran["fdt_train_fwd"],
                ran2["fdt_train_plane"], ran2["fdt_train_bwd"]) \
                != (1, 2, 0, 1):
            raise AssertionError(f"{label}: launches {ran}, then K2 {ran2}")
        rout = K.fdt_backward_grad_wall_torch(*grad_args, **kw,
                                              want_dfeats=grad_feats)
        for name, got, want in zip(("dWall", "dfeats"),
                                   out if grad_feats else (out,),
                                   rout if grad_feats else (rout,)):
            self.close(f"{label} {name}", got, want, RTOL,
                       REL_MAX * float(want.abs().max()))
        # the dead lattice alone: zero gradient, exactly
        one = lambda x: x[1:2].contiguous()
        dead = K.fdt_backward_grad_cuda(
            Wall, one(feats), one(labels), one(lengths), one(alphas),
            one(zf), one(zc), torch.zeros_like(one(zf)),
            torch.ones_like(one(zf)), **kw)
        if float(dead.abs().max()) != 0.0:
            raise AssertionError(f"{label}: dead lattice gradient "
                                 f"{float(dead.abs().max())}")
        torch.cuda.synchronize()
        for name, e in (("fdt_train_fwd", s_err), ("fdt_train_plane", p_err),
                        ("fdt_train_bwd", dp_err),
                        ("fdt_train_contract", c_err)):
            self.err[name] = max(self.err[name], e)
        log(f"train parity {label}: K1 max |z - plain| {z_err:.3e}; on the "
            f"same planes max |alpha, z - plain| {s_err:.3e}; |planes - "
            f"matmul| {p_err:.3e}, |dplane - plain| {dp_err:.3e}, "
            f"|contraction - matmul| {c_err:.3e} (bit-equal on two runs); "
            f"dWall{' and dfeats' if grad_feats else ''} within tolerance; "
            "dead lattice gradient 0; K2 on K1's planes launched no plane "
            "kernel")

    def check_loss_grads(self):
        """crf_loss + backward(): the kernels against the plain path
        (backend 'torch': autograd of the plain loop) on every parameter."""
        from asr_craft_tpu_torch import kernels
        from asr_craft_tpu_torch.models.crf import crf_loss
        torch = self.torch
        params, feats, labels, lengths = self.train_problem(
            self.cfg, 128, 512, 0, False, dead_row=False)
        # cut each row where its last phone run keeps >= 3 frames (a
        # multiple of 4, or one short of it), so every lattice lives and
        # the loss is a real one
        cut = lengths % 4
        lengths = torch.where((cut == 1) | (cut == 2), lengths - cut,
                              lengths).to(torch.int32)
        grads = {}
        for backend in ("auto", "torch"):
            kernels.set_backend(backend)
            try:
                p = {k: v.clone().requires_grad_(True)
                     for k, v in params.items()}
                loss, _ = crf_loss(self.cfg, p, feats, labels, lengths)
                loss.backward()
                grads[backend] = (loss.item(), {k: v.grad
                                                for k, v in p.items()})
            finally:
                kernels.set_backend("auto")
        (lk, gk), (lp, gp) = grads["auto"], grads["torch"]
        if not abs(lk) < 1e3:
            raise AssertionError(f"crf_loss {lk}: a lattice is dead")
        if abs(lk - lp) > 1e-5 * abs(lp):
            raise AssertionError(f"crf_loss {lk} vs plain {lp}")
        errs = {k: self.close(f"grad {k}", gk[k], gp[k], RTOL,
                              REL_MAX * float(gp[k].abs().max()))
                for k in gk}
        log(f"train parity crf_loss B=128 T=512: loss {lk:.7f} (plain "
            f"{lp:.7f}); max |grad - plain| {errs}")

    def phase_train_parity(self):
        from asr_craft_tpu_torch.models.crf import CrfConfig
        self.check_train("flagship phone labels", self.cfg, 128, 512, 0)
        self.check_train("flagship phone labels, grad_feats", self.cfg, 128,
                         512, 1, grad_feats=True)
        self.check_train("flagship state labels", self.cfg, 128, 512, 2,
                         state_labels=True)
        big = CrfConfig(num_labels=128, feat_dim=16, num_states=3,
                        trans_range=(0, 16))
        for state_labels in (False, True):
            kind = "state" if state_labels else "phone"
            self.check_train(f"P=128 ns=3 {kind} labels", big, 4, 24, 3,
                             state_labels, grad_feats=True)
        self.check_loss_grads()

    # -- (e) training end to end ---------------------------------------------
    def run_train_cli(self, backend, tag=""):
        from asr_craft_tpu_torch.cli.train import main
        out = OUT / f"train_{backend}{tag}"
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(TRAIN_FLAGS + ["--device", "cuda", "--kernel_backend",
                                     backend, "--out_dir", str(out)])
        self.torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]
        for r in recs:
            if r["kind"] in ("train_epoch", "eval"):
                log(f"  cli ({backend}): {json.dumps(r)}")
        if rc != 0:
            raise AssertionError(f"train CLI rc={rc}")
        losses = [r["mean_loss"] for r in recs if r["kind"] == "train_epoch"]
        evals = [r for r in recs if r["kind"] == "eval"]
        return losses, evals, out / "weights.final.dat", secs

    def same_run(self, label, graph, eager):
        """A CLI run through the CUDA graphs (the default on the card)
        against the same run eager (``graphs.disabled()``): the same
        per-epoch losses, CV PERs and final weights (bit for bit; where a
        cuBLAS product differs under capture, within rtol 1e-6)."""
        import numpy as np
        (losses, evals, wfile, secs), (elosses, eevals, ewfile, esecs) = \
            graph, eager
        exact = (losses == elosses and wfile.read_bytes()
                 == ewfile.read_bytes())
        w, ew = (np.fromfile(f, dtype=np.float32) for f in (wfile, ewfile))
        if not exact and not (
                np.allclose(losses, elosses, rtol=1e-6, atol=0)
                and w.shape == ew.shape
                and np.allclose(w, ew, rtol=1e-6, atol=0)):
            raise AssertionError(f"{label}: graph losses {losses}, eager "
                                 f"{elosses}; weights max abs diff "
                                 f"{np.abs(w - ew).max()}")
        pers = [e.get("per") for e in evals]
        if pers != [e.get("per") for e in eevals]:
            raise AssertionError(f"{label}: graph PERs {pers}, eager "
                                 f"{[e.get('per') for e in eevals]}")
        log(f"{label}: through the CUDA graphs {secs:.3f} s wall, eagerly "
            f"{esecs:.3f} s; the same losses, PERs and final weights "
            + ("bit for bit" if exact else "within rtol 1e-6 (cuBLAS)"))

    def phase_train_cli(self):
        from asr_craft_tpu_torch import kernels
        mark = launches("fdt_train", "fdt_viterbi")
        losses, evals, wfile, secs = self.run_train_cli("auto")
        self.train_counts = launches("fdt_train", "fdt_viterbi", since=mark)
        mark = launches("fdt_train", "fdt_viterbi")
        plosses, pevals, _, psecs = self.run_train_cli("torch")
        plain_counts = launches("fdt_train", "fdt_viterbi", since=mark)
        kernels.set_backend("auto")
        log(f"train CLI: losses {losses}, final PER {evals[-1]['per']} "
            f"(kernels, {secs:.3f} s wall, launches {self.train_counts}); "
            f"losses {plosses}, final PER {pevals[-1]['per']} (plain, "
            f"{psecs:.3f} s wall, launches {plain_counts})")
        for got, want in zip(losses, JAX_TRAIN_LOSSES):
            if abs(got - want) > 1e-3 * want:
                raise AssertionError(f"epoch losses {losses}, JAX reference "
                                     f"{JAX_TRAIN_LOSSES} (rtol 1e-3)")
        if len(losses) != len(JAX_TRAIN_LOSSES):
            raise AssertionError(f"{len(losses)} epochs")
        if abs(evals[-1]["per"] - JAX_TRAIN_PER) > 0.02:
            raise AssertionError(f"final PER {evals[-1]['per']}, JAX "
                                 f"reference {JAX_TRAIN_PER} (+-0.02)")
        if min(self.train_counts.values()) < 1:
            raise AssertionError(f"a kernel never launched in training: "
                                 f"{self.train_counts}")
        # one plane launch a forward (a train step or a CV batch), none in
        # K2's backward
        tc = self.train_counts
        if tc["fdt_train_plane"] != tc["fdt_train_fwd"] or \
                tc["fdt_train_bwd"] >= tc["fdt_train_fwd"]:
            raise AssertionError(f"train CLI: {tc['fdt_train_plane']} plane "
                                 f"launches for {tc['fdt_train_fwd']} "
                                 f"forwards and {tc['fdt_train_bwd']} "
                                 "backwards")
        if max(plain_counts.values()) != 0:
            raise AssertionError(f"plain backend launched {plain_counts}")
        for a, b in zip(losses, plosses):
            if abs(a - b) > 1e-4 * abs(b):
                raise AssertionError(f"kernel losses {losses} vs plain "
                                     f"{plosses} (rtol 1e-4)")
        decode = TRAIN_FLAGS[:10] + ["--weight_file", str(wfile),
                                     "--device", "cuda"]
        rec, _ = self.run_cli(decode + ["--kernel_backend", "auto",
                                        "--out_mlf",
                                        str(OUT / "train_auto.mlf")])
        rec_t, _ = self.run_cli(decode + ["--kernel_backend", "torch",
                                          "--out_mlf",
                                          str(OUT / "train_torch.mlf")])
        kernels.set_backend("auto")
        if rec["per"] != rec_t["per"] or ((OUT / "train_auto.mlf")
                                          .read_bytes() != (
                                              OUT / "train_torch.mlf")
                                          .read_bytes()):
            raise AssertionError("the trained weights decode differently "
                                 "under the kernels and the plain version")
        log(f"train CLI: within rtol 1e-3 of the JAX losses, PER within "
            f"0.02 of {JAX_TRAIN_PER}; kernel and plain losses within rtol "
            f"1e-4; weights.final.dat decodes to PER {rec['per']} and the "
            "same MLF under both backends")
        from asr_craft_tpu_torch.train import graphs
        with graphs.disabled():
            elosses, eevals, ewfile, esecs = self.run_train_cli("auto",
                                                                "_eager")
        self.same_run("train CLI", (losses, evals, wfile, secs),
                      (elosses, eevals, ewfile, esecs))

    # -- (f) training timing -------------------------------------------------
    def phase_train_timing(self):
        from asr_craft_tpu_torch import kernels
        from asr_craft_tpu_torch.flagship import tiny_batch
        from asr_craft_tpu_torch.kernels import fdt_train as K
        from asr_craft_tpu_torch.train import TrainConfig, Trainer, graphs
        torch, cfg = self.torch, self.cfg
        B, T = 128, 512
        params = cfg.init_params(torch.Generator().manual_seed(0), 0.01,
                                 self.dev)
        batch = tiny_batch(cfg, B, T, 0, self.dev)
        feats, labels, lengths = (batch["feats"], batch["labels"],
                                  batch["lengths"])
        Wall, u0, u1, dims = self.wall.build_wall(params, cfg.fmap,
                                                  cfg.num_states)
        kw = dict(u0=u0, u1=u1, ns=cfg.num_states, P=dims["P"],
                  clamp_ns=cfg.num_states, boundaries=True)
        args = (Wall, feats, labels, lengths)
        alphas, zf, zc, planes = K.fdt_forward_cuda(*args, **kw)
        ones = torch.ones_like(zf)
        grad_args = args + (alphas, zf, zc, ones, -ones)
        dplane = K.fdt_dplane_cuda(*grad_args, **kw, planes=planes)
        dW = torch.empty((Wall.shape[0], u1 - u0 + 1), device=self.dev)
        rec = dict(ns=kw["ns"], P=kw["P"], clamp_ns=kw["clamp_ns"],
                   boundaries=True)
        # the library's calls for the same products on the same inputs,
        # [x; 1] made before the clock starts: planes = [x; 1] Wall^T,
        # dWall = dplane^T [x; 1]
        xu2 = self.wall.feats_xu(feats, u0, u1).reshape(B * T, u1 - u0 + 1)
        dp2 = dplane.reshape(B * T, -1)
        library = {
            "fdt_train_plane": lambda: torch.mm(xu2, Wall.T),
            "fdt_train_contract": lambda: torch.mm(dp2.T, xu2),
        }
        trainer = Trainer(cfg, TrainConfig(lr=0.5), params=params)

        def step(backend):
            # eager, as before the compiled step: phase (s) times the graph
            kernels.set_backend(backend)
            try:
                with graphs.disabled():
                    trainer.train_step(batch, 0.5)
            finally:
                kernels.set_backend("auto")

        # one step's launches and its peak device memory beyond what is
        # allocated before it: the planes live from the forward to the
        # backward, beside dplane
        step("auto")
        torch.cuda.synchronize()
        before = launches("fdt_train")
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step("auto")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ran = launches("fdt_train", since=before)
        log(f"train step B={B} T={T}: launches {ran}; peak device memory "
            f"{peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held "
            f"before it (planes {planes.numel() * 4 / 2**20:.1f} MiB, dplane "
            f"{dplane.numel() * 4 / 2**20:.1f} MiB)")
        if ran != {"fdt_train_fwd": 1, "fdt_train_plane": 1,
                   "fdt_train_bwd": 1, "fdt_train_contract": 1}:
            raise AssertionError(f"a train step launched {ran}: one plane "
                                 "kernel a step, none in K2's backward")

        fns = {
            "fdt_train_plane": (
                lambda: K.fdt_planes_cuda(Wall, feats, u0=u0, u1=u1),
                lambda: K.fdt_planes_torch(Wall, feats, u0=u0, u1=u1)),
            "fdt_train_fwd": (
                lambda: K.fdt_forward_planes_cuda(planes, labels, lengths,
                                                  **rec),
                lambda: K.fdt_forward_planes_torch(planes, labels, lengths,
                                                   **rec)),
            "K1 (planes + recursion)": (
                lambda: K.fdt_forward_cuda(*args, **kw),
                lambda: K.fdt_forward_wall_torch(*args, **kw)),
            "fdt_train_bwd": (lambda: K.fdt_dplane_cuda(*grad_args, **kw,
                                                        planes=planes),
                              lambda: K.fdt_dplane_wall_torch(*grad_args,
                                                              **kw)),
            "fdt_train_contract": (
                lambda: K.contract_cuda(dplane, feats, dW, mode=0, D=144,
                                        u0=u0, Du=u1 - u0),
                lambda: K.contract_wall_torch(dplane, feats, mode=0, u0=u0,
                                              u1=u1)),
            "K2 (recursion + contraction, on K1's planes)": (
                lambda: K.fdt_backward_grad_cuda(*grad_args, **kw,
                                                 planes=planes),
                lambda: K.fdt_backward_grad_wall_torch(*grad_args, **kw)),
            "train step (loss, backward, SGD)": (lambda: step("auto"),
                                                 lambda: step("torch")),
        }
        audio_s = B * T * FRAME_S
        shape = dict(B=B, T=T, L=cfg.num_states * dims["P"],
                     D=feats.shape[2], ns=cfg.num_states, Du=u1 - u0)
        for name in TRAIN_SRC:
            self.bounds[name] = self.bound(name, **shape)
        for name, (kern, plain) in fns.items():
            # plain, kernel, kernel, plain: compare within one call only
            p1 = self.cuda_ms(plain, 1)
            k1 = self.cuda_ms(kern, 5)
            k2 = self.cuda_ms(kern, 5)
            p2 = self.cuda_ms(plain, 1)
            ms, plain_ms = min(k1, k2), min(p1, p2)
            self.times[name] = (ms, plain_ms)
            tail = ""
            if name in library:
                # cuBLAS in fp32 (allow_tf32 is off), timed twice
                lib_ms = min(self.cuda_ms(library[name], 5),
                             self.cuda_ms(library[name], 5))
                self.library_ms[name] = lib_ms
                tail = f"; cuBLAS fp32 {lib_ms:.4f} ms"
            log(f"timing {name} B={B} T={T}: kernel {ms:.4f} ms "
                f"({k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms "
                f"({p1:.4f}, {p2:.4f}); {audio_s / ms * 1e3:.1f} vs "
                f"{audio_s / plain_ms * 1e3:.1f} audio-s/s{tail}")

    # -- (g) shared-transition parity ----------------------------------------
    def shared_configs(self):
        from asr_craft_tpu_torch import flagship
        return {"config1": flagship.timit_mono(),
                "config3": flagship.wsj_crandem(),
                "config5": flagship.swbd()}

    def shared_problem(self, cfg, B, T, seed, ragged=True):
        """A random model (scale 0.1), N(0, 1) frames, lengths (ragged with
        an empty last row, or all T) and the decode's own kernel inputs:
        the potentials with the boundaries folded in."""
        from asr_craft_tpu_torch.flagship import ragged_lengths, tiny_batch
        from asr_craft_tpu_torch.models.crf import apply_boundaries, potentials
        torch = self.torch
        params = cfg.init_params(torch.Generator().manual_seed(seed), 0.1,
                                 self.dev)
        feats = tiny_batch(cfg, B, T, seed, self.dev)["feats"]
        lengths = (torch.from_numpy(ragged_lengths(B, T, seed)).to(self.dev)
                   if ragged else torch.full((B,), T, dtype=torch.int32,
                                             device=self.dev))
        state, trans = potentials(cfg, params, feats)
        return (apply_boundaries(cfg, state, lengths).contiguous(),
                trans.contiguous(), lengths, params, feats)

    def check_shared(self, label, name, state, trans, lengths, ns, beams):
        from asr_craft_tpu_torch.kernels import viterbi as KV
        from asr_craft_tpu_torch.ops import fdt
        from asr_craft_tpu_torch.ops import viterbi as V
        torch = self.torch
        thr, bw = beams.get("beam_threshold"), beams.get("beam_width")
        rbp, rlast, rscores = V.viterbi_forward(state, trans, lengths, bw,
                                                thr)
        ref_paths = fdt.fdt_viterbi_traceback(rbp, rlast, lengths)
        if name == "viterbi_nstate_fwd":
            bp, last, scores = KV.viterbi_nstate_fwd(state, trans, lengths,
                                                     ns, thr, bw)
        else:
            bp, last, scores = KV.viterbi_dense_fwd(state, trans, lengths,
                                                    thr, bw)
        paths = KV.viterbi_traceback(bp, last, lengths)
        tb_paths = KV.viterbi_traceback(rbp, rlast, lengths)
        torch.cuda.synchronize()
        L = state.shape[-1]
        if not (torch.isfinite(scores).all() and paths.min() >= 0
                and paths.max() < L):
            raise AssertionError(f"{label}: non-finite scores or bad labels")
        err = float((scores - rscores).abs().max())
        if not torch.allclose(scores, rscores, **SCORE_TOL):
            raise AssertionError(f"{label}: scores differ, max abs {err}")
        diff = (paths != ref_paths).any(dim=1)
        n_diff = int(diff.sum())
        if n_diff:
            # near-tie rule: a differing path must rescore to the plain
            # optimum within the tolerance
            rescored = V.path_score(state, trans, paths, lengths)
            if bool((diff & (lengths == 0)).any()) or not torch.allclose(
                    rescored[diff], rscores[diff], **SCORE_TOL):
                raise AssertionError(f"{label}: {n_diff} paths differ and "
                                     "are not near-ties")
        tb_err = int((tb_paths - ref_paths).abs().max())
        if tb_err:
            raise AssertionError(f"{label}: traceback kernel differs on the "
                                 "plain backpointers")
        # the kernels do the plain version's fp32 adds and maxes in its
        # order and break ties as it does: its bits, paths included
        for what, got, want in (("backpointers", bp, rbp),
                                ("final labels", last, rlast),
                                ("scores", scores, rscores),
                                ("paths", paths, ref_paths)):
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: {name} {what} differ from "
                                     "the plain version's")
        self.err[name] = max(self.err[name], err)
        self.err["viterbi_traceback"] = max(self.err["viterbi_traceback"],
                                            tb_err)
        log(f"shared parity {label}: {name} backpointers, final labels, "
            f"scores and paths equal the plain version's (max |score - "
            f"plain| {err:.3e}); traceback exact")

    def phase_shared_parity(self):
        from asr_craft_tpu_torch.models.crf import CrfConfig
        for key, cfg in self.shared_configs().items():
            name = ("viterbi_nstate_fwd" if cfg.num_states > 1
                    else "viterbi_dense_fwd")
            state, trans, lengths, _, _ = self.shared_problem(
                cfg, self.B, self.T, seed=0)
            for mode, beams in (("exact", {}),
                                ("beam_threshold=8", {"beam_threshold": 8.0}),
                                ("beam_width=16", {"beam_width": 16})):
                self.check_shared(f"{key} {mode}", name, state, trans,
                                  lengths, cfg.num_states, beams)
        big = CrfConfig(num_labels=130, feat_dim=16, num_states=3)
        state, trans, lengths, _, _ = self.shared_problem(big, 4, 40, seed=1)
        for mode, beams in (("exact", {}), ("beam_width=40",
                                            {"beam_width": 40})):
            self.check_shared(f"P=130 ns=3 {mode}", "viterbi_dense_fwd",
                              state, trans, lengths, 3, beams)

    # -- (h) shared-transition end to end -------------------------------------
    def phase_shared_decode(self):
        from asr_craft_tpu_torch import kernels
        from asr_craft_tpu_torch.flagship import posterior_model, word_corpus
        from asr_craft_tpu_torch.models.crf import CrfConfig
        from asr_craft_tpu_torch.models.weights import (params_from_numpy,
                                                        save_raw)
        OUT.mkdir(parents=True, exist_ok=True)
        runs = {}
        for key, cfg in self.shared_configs().items():
            window, flags, _ = SHARED[key]
            wfile = OUT / f"{key}.dat"
            save_raw(wfile, cfg.fmap,
                     params_from_numpy(posterior_model(cfg, window)))
            argv = ["--synthetic_utts", "128", "--crf_label_size",
                    str(cfg.num_labels), "--crf_states",
                    str(cfg.num_states), "--window_extent", str(window),
                    "--batch_size", "64", "--weight_file", str(wfile),
                    "--device", "cuda"] + flags
            runs[key] = argv
        # the main path: every count 0 before it, read after it
        mark = launches("viterbi")
        recs = {key: self.run_cli(argv + ["--kernel_backend", "auto",
                                          "--out_mlf",
                                          str(OUT / f"{key}_auto.mlf")])
                for key, argv in runs.items()}
        self.shared_counts = launches("viterbi", since=mark)
        mark = launches("viterbi")
        for key, argv in runs.items():
            rec, secs = recs[key]
            rec_t, secs_t = self.run_cli(argv + [
                "--kernel_backend", "torch", "--out_mlf",
                str(OUT / f"{key}_torch.mlf")])
            kernels.set_backend("auto")
            log(f"shared decode CLI {key}: per {rec['per']} (kernels, "
                f"{secs:.3f} s wall); per {rec_t['per']} (plain, "
                f"{secs_t:.3f} s wall)")
            if (rec["errors"], rec["tokens"]) != SHARED[key][2]:
                raise AssertionError(f"{key}: errors/tokens {rec['errors']}/"
                                     f"{rec['tokens']}, JAX reference "
                                     f"{SHARED[key][2]}")
            if rec["per"] != rec_t["per"] or (
                    (OUT / f"{key}_auto.mlf").read_bytes()
                    != (OUT / f"{key}_torch.mlf").read_bytes()):
                raise AssertionError(f"{key}: kernel and plain PER or MLF "
                                     "differ")
        plain_counts = launches("viterbi", since=mark)
        log(f"shared decode CLI launches {self.shared_counts} (kernels), "
            f"{plain_counts} (plain)")
        if min(self.shared_counts.values()) < 1:
            raise AssertionError(f"a kernel never launched: "
                                 f"{self.shared_counts}")
        if max(plain_counts.values()) != 0:
            raise AssertionError(f"plain backend launched {plain_counts}")
        log("shared decode CLI: kernel and plain backends give the same PER "
            "and MLF; errors/tokens equal the JAX reference")

        words_dir = OUT / "words"
        P = word_corpus(words_dir)
        cfg = CrfConfig(num_labels=P, feat_dim=P)
        save_raw(words_dir / "w.dat", cfg.fmap,
                 params_from_numpy(posterior_model(cfg, 0)))
        rec, secs = self.run_cli([
            "--ftr1_file", str(words_dir / "test.pf"), "--crf_label_size",
            str(P), "--weight_file", str(words_dir / "w.dat"),
            "--batch_size", "8", "--bucket_sizes", "256",
            "--lexicon", str(words_dir / "lex.txt"),
            "--ref_words", str(words_dir / "refs.txt"), "--fst_backend",
            "py", "--device", "cuda",
            "--out_words", str(words_dir / "hyp.txt")])
        words = (words_dir / "hyp.txt").read_text()
        if (rec["errors"], rec["tokens"]) != JAX_WORD_ERRORS or \
                words != JAX_WORDS:
            raise AssertionError(f"word decode: {rec}, words {words!r}")
        log(f"word decode CLI: wer {rec['wer']} ({rec['errors']}/"
            f"{rec['tokens']}, {secs:.3f} s wall), words equal the JAX CLI's")

    # -- (i) shared-transition timing -----------------------------------------
    def phase_shared_timing(self):
        from asr_craft_tpu_torch.kernels import viterbi as KV
        from asr_craft_tpu_torch.models.crf import decode
        from asr_craft_tpu_torch.ops import fdt
        from asr_craft_tpu_torch.ops import viterbi as V
        B, T = self.B, self.T
        audio_s = B * T * FRAME_S
        for key, cfg in self.shared_configs().items():
            state, trans, lengths, params, feats = self.shared_problem(
                cfg, B, T, seed=0, ragged=False)
            ns = cfg.num_states
            name = ("viterbi_nstate_fwd" if ns > 1 else "viterbi_dense_fwd")

            def kern(kname, thr=None, bw=None):
                if kname == "viterbi_nstate_fwd":
                    return lambda: KV.viterbi_nstate_fwd(state, trans,
                                                         lengths, ns, thr, bw)
                return lambda: KV.viterbi_dense_fwd(state, trans, lengths,
                                                    thr, bw)

            def plain(thr=None, bw=None):
                return lambda: V.viterbi_forward(state, trans, lengths, bw,
                                                 thr)

            bp, last, _ = V.viterbi_forward(state, trans, lengths)
            # the main kernel exact and under each beam, K7 beside K8 on the
            # n-state problem
            fns = {name: (kern(name), plain()),
                   f"{name} beam_threshold=8": (kern(name, 8.0),
                                                plain(8.0)),
                   f"{name} beam_width=16": (kern(name, None, 16),
                                             plain(None, 16)),
                   "viterbi_traceback": (
                       lambda: KV.viterbi_traceback(bp, last, lengths),
                       lambda: fdt.fdt_viterbi_traceback(bp, last, lengths)),
                   "decode": (
                       lambda: decode(cfg, params, feats, lengths),
                       lambda: self._plain_decode(cfg, params, feats,
                                                  lengths))}
            if ns > 1:
                fns["viterbi_dense_fwd"] = (kern("viterbi_dense_fwd"),
                                            plain())
            shape = dict(B=B, T=T, L=state.shape[-1], ns=ns,
                         frames=int(lengths.sum()))
            for kname in ("viterbi_dense_fwd", "viterbi_traceback"):
                self.bounds[f"{key} {kname}"] = self.bound(kname, **shape)
            if ns > 1:     # the dead destinations this run's data re-scans
                rescans = KV.nstate_rescans(state, trans, lengths, ns)
                beam = KV.nstate_rescans(state, trans, lengths, ns, 8.0)
                width = KV.nstate_rescans(state, trans, lengths, ns, None,
                                          16)
                self.bounds[f"{key} viterbi_nstate_fwd"] = self.bound(
                    "viterbi_nstate_fwd", rescans=rescans, **shape)
                log(f"timing {key}: K8 re-scans {rescans} dead destinations "
                    f"exact, {beam} under beam_threshold=8, {width} under "
                    "beam_width=16")
            for fn_name, (k_fn, p_fn) in fns.items():
                p1 = self.cuda_ms(p_fn, 2)
                k1 = self.cuda_ms(k_fn, 10)
                k2 = self.cuda_ms(k_fn, 10)
                p2 = self.cuda_ms(p_fn, 2)
                ms, plain_ms = min(k1, k2), min(p1, p2)
                self.times[f"{key} {fn_name}"] = (ms, plain_ms)
                log(f"timing {key} {fn_name} B={B} T={T}: kernel "
                    f"{ms:.4f} ms ({k1:.4f}, {k2:.4f}; "
                    f"{ms * 1e3 / T:.4f} us a frame), plain "
                    f"{plain_ms:.4f} ms ({p1:.4f}, {p2:.4f}); "
                    f"{audio_s / ms * 1e3:.1f} vs "
                    f"{audio_s / plain_ms * 1e3:.1f} audio-s/s")
            # the traceback's own device time (its events read the
            # wrapper's host time), alone and inside decode()
            tb = "fdt_vit_tb_kernel"
            resident = self.kernel_ms(
                lambda: KV.viterbi_traceback(bp, last, lengths), tb)
            in_decode = self.kernel_ms(
                lambda: decode(cfg, params, feats, lengths), tb)
            self.times[f"{key} viterbi_traceback"] = (
                resident, self.times[f"{key} viterbi_traceback"][1])
            log(f"timing {key} viterbi_traceback B={B} T={T} "
                f"L'={state.shape[-1]} (trace): {resident:.4f} ms alone "
                f"({resident * 1e3 / T:.4f} us a dependent step), "
                f"{in_decode:.4f} ms inside decode() "
                f"({in_decode * 1e3 / T:.4f} us a step)")
            self.device_share(f"{key} decode B={B} T={T}",
                              lambda: decode(cfg, params, feats, lengths))

    # -- (j) shared-transition training parity ---------------------------------
    def fb_problem(self, cfg, B, T, seed, state_labels=False, ragged=True):
        """A random model (scale 0.1), N(0, 1) frames, topology-legal labels
        (phone runs of 4 frames, or their state walks [0, 0, 1, 2]) and the
        kernels' own inputs: the potentials with the boundaries folded in.
        ``ragged``: lengths on run ends with row 0 full, the last row empty
        and row 1 labelled with a phone no state admits (a dead clamped
        lattice); else all rows full and legal."""
        from asr_craft_tpu_torch.flagship import ragged_lengths, tiny_batch
        from asr_craft_tpu_torch.models.crf import apply_boundaries, potentials
        torch = self.torch
        params = cfg.init_params(torch.Generator().manual_seed(seed), 0.1,
                                 self.dev)
        batch = tiny_batch(cfg, B, T, seed, self.dev)
        labels = batch["labels"]
        if state_labels:
            walk = torch.tensor([0, 0, 1, 2], dtype=torch.int32,
                                device=self.dev).repeat(T // 4)
            labels = labels * cfg.num_states + walk
        if ragged:
            lengths = ragged_lengths(B, T, seed)
            lengths = (lengths + 3) // 4 * 4          # whole runs
            lengths[-1] = 0
            lengths = torch.from_numpy(lengths).to(self.dev)
            labels = labels.clone()
            labels[1] = cfg.fmap.num_expanded + 3
        else:
            lengths = batch["lengths"]
        with torch.no_grad():
            state, trans = potentials(cfg, params, batch["feats"])
            state = apply_boundaries(cfg, state, lengths)
        return (state.contiguous(), trans.contiguous(), labels.contiguous(),
                lengths, params, batch["feats"])

    def check_fb(self, label, cfg, seed, state_labels=False):
        from asr_craft_tpu_torch.kernels import fwdbwd as K
        torch = self.torch
        state, trans, labels, lengths, _, _ = self.fb_problem(
            cfg, 128, 512, seed, state_labels)
        cns = 1 if state_labels else cfg.num_states
        errs = {}

        def close(name, what, got, want, **tol):
            e = self.close(f"{label} {what}", got, want, **tol)
            errs[name] = max(errs.get(name, 0.0), e)

        single = (state, trans, lengths)
        dual = (state, trans, labels, lengths)
        alphas, z = K.forward_cuda(*single)
        ra, rz = K.forward_plain(*single)
        close("forward", "alphas", alphas, ra, **FB_Z_TOL)
        close("forward", "logZ", z, rz, **FB_Z_TOL)
        close("backward", "betas", K.backward_cuda(*single),
              K.backward_plain(*single), **FB_Z_TOL)
        af, ac, zf, zc = K.forward_dual_cuda(*dual, cns)
        raf, rac, rzf, rzc = (x.contiguous()
                              for x in K.forward_dual_plain(*dual, cns))
        for what, got, want in (("af", af, raf), ("ac", ac, rac),
                                ("zf", zf, rzf), ("zc", zc, rzc)):
            close("forward_dual", what, got, want, **FB_Z_TOL)
        if not (float(zc[1]) < -1e29 < float(zf[1])):
            raise AssertionError(f"{label}: row 1's clamped lattice is not "
                                 f"dead (zf {float(zf[1])}, zc "
                                 f"{float(zc[1])})")
        bf, bc = K.backward_dual_cuda(*dual, cns)
        rbf, rbc = K.backward_dual_plain(*dual, cns)
        close("backward_dual", "bf", bf, rbf, **FB_Z_TOL)
        close("backward_dual", "bc", bc, rbc, **FB_Z_TOL)
        wf, wc = torch.ones_like(zf), -torch.ones_like(zf)   # d(zf - zc)
        grad_in = (raf, rac, rzf, rzc, wf, wc)
        rg, rUV = K.backward_dual_grad_plain(*dual, *grad_in, cns)
        before = launches("fwdbwd")
        g, UV = K.backward_dual_grad_cuda(*dual, *grad_in, cns)
        ran = launches("fwdbwd", since=before)
        if ran != {**dict.fromkeys(before, 0), "backward_dual_grad": 1,
                   "backward_dual_contract": 1}:
            raise AssertionError(f"{label}: backward_dual_grad launched "
                                 f"{ran}, not one recursion and one "
                                 "contraction")
        g2, UV2 = K.backward_dual_grad_cuda(*dual, *grad_in, cns)
        close("backward_dual_grad", "g_state", g, rg, rtol=0.0,
              atol=FB_G_ATOL)
        uv_err = self.close(f"{label} UV", UV, rUV, RTOL,
                            REL_MAX * float(rUV.abs().max()))
        if not (torch.equal(UV, UV2) and torch.equal(g, g2)):
            raise AssertionError(f"{label}: K5 differs between two runs")
        # the contraction alone, on the recursion's own rows
        L = state.shape[-1]
        _, U, V = K.backward_dual_grad_rows_cuda(*dual, *grad_in, cns)
        cUV = K.backward_dual_contract_cuda(U, V, L)
        pUV = K.backward_dual_contract_plain(U, V, L)
        errs["backward_dual_contract"] = self.close(
            f"{label} contraction", cUV, pUV, RTOL,
            REL_MAX * float(pUV.abs().max()))
        # the dead lattice alone: zero gradient, exactly
        one = lambda x: x[1:2].contiguous()
        dead = (one(state), trans, one(labels), one(lengths), one(af),
                one(ac), one(zf), one(zc), torch.zeros_like(one(zf)),
                torch.ones_like(one(zf)), cns)
        dg, dUV = K.backward_dual_grad_cuda(*dead)
        _, dU, _ = K.backward_dual_grad_rows_cuda(*dead)
        torch.cuda.synchronize()
        if (float(dg.abs().max()) != 0.0 or float(dUV.abs().max()) != 0.0
                or float(dU[..., :L].abs().max()) != 0.0):
            raise AssertionError(f"{label}: dead lattice gradient "
                                 f"{float(dg.abs().max())}, "
                                 f"{float(dUV.abs().max())}, rows "
                                 f"{float(dU[..., :L].abs().max())}")
        for name, e in errs.items():
            self.err[name] = max(self.err[name], e)
        log(f"fb parity {label}: max |kernel - plain| {errs}, |UV - plain| "
            f"{uv_err:.3e} (largest |UV| {float(rUV.abs().max()):.3e}); K5 "
            "bit-equal on two runs, one recursion and one contraction a "
            "call; dead lattice gradient and rows 0")

    def check_shared_loss_grads(self, key, cfg):
        """The shared crf_loss + backward(): the K4/K5 path against the
        plain path (backend 'torch') on every parameter gradient."""
        from asr_craft_tpu_torch import kernels
        from asr_craft_tpu_torch.models.crf import crf_loss
        torch = self.torch
        _, _, labels, lengths, params, feats = self.fb_problem(
            cfg, 128, 512, 0)
        labels[1] = labels[2]               # every lattice lives
        grads = {}
        for backend in ("auto", "torch"):
            kernels.set_backend(backend)
            try:
                p = {k: v.clone().requires_grad_(True)
                     for k, v in params.items()}
                loss, _ = crf_loss(cfg, p, feats, labels, lengths)
                loss.backward()
                grads[backend] = (loss.item(), {k: v.grad
                                                for k, v in p.items()})
            finally:
                kernels.set_backend("auto")
        (lk, gk), (lp, gp) = grads["auto"], grads["torch"]
        if not abs(lk) < 1e3:
            raise AssertionError(f"{key} crf_loss {lk}: a lattice is dead")
        if abs(lk - lp) > 1e-5 * abs(lp):
            raise AssertionError(f"{key} crf_loss {lk} vs plain {lp}")
        errs = {k: self.close(f"{key} grad {k}", gk[k], gp[k], RTOL,
                              REL_MAX * float(gp[k].abs().max()))
                for k in gk}
        log(f"fb parity {key} crf_loss B=128 T=512: loss {lk:.7f} (plain "
            f"{lp:.7f}); max |grad - plain| {errs}")

    def phase_fb_parity(self):
        for seed, (key, cfg) in enumerate(self.shared_configs().items()):
            self.check_fb(f"{key} phone labels", cfg, seed)
            self.check_shared_loss_grads(key, cfg)
        self.check_fb("config5 state labels", self.shared_configs()["config5"],
                      3, state_labels=True)

    # -- (k) shared-transition training end to end ------------------------------
    def run_shared_train_cli(self, key, backend, tag=""):
        from asr_craft_tpu_torch.cli.train import main
        model, optim = SHARED_TRAIN[key][:2]
        flags = model + optim + SHARED_TRAIN_CORPUS
        out = OUT / f"train_{key}_{backend}{tag}"
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(flags + ["--device", "cuda", "--kernel_backend",
                               backend, "--out_dir", str(out)])
        self.torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]
        for r in recs:
            if r["kind"] in ("train_epoch", "eval"):
                log(f"  cli ({key}, {backend}): {json.dumps(r)}")
        if rc != 0:
            raise AssertionError(f"{key}: train CLI rc={rc}")
        losses = [r["mean_loss"] for r in recs if r["kind"] == "train_epoch"]
        evals = [r for r in recs if r["kind"] == "eval"]
        return losses, evals, out / "weights.final.dat", secs

    def trained_problem(self, cfg, wfile):
        """A trained model and one batch (B=16, T=128, rows full) for it."""
        from asr_craft_tpu_torch.flagship import tiny_batch
        from asr_craft_tpu_torch.models.weights import load_raw
        B, T = 16, 128
        batch = tiny_batch(cfg, B, T, 0, self.dev)
        lengths = self.torch.full((B,), T, dtype=self.torch.int32,
                                  device=self.dev)
        return (load_raw(wfile, cfg.fmap, self.dev), batch["feats"],
                batch["labels"], lengths)

    def check_trained_posteriors(self, key, cfg, problem, post, betas):
        """What the two calls on a trained model gave: the frame posteriors
        equal the plain version's and sum to 1 on every frame; so do the
        clamped lattice's, formed from K4's alphas and K14's betas."""
        from asr_craft_tpu_torch import kernels
        from asr_craft_tpu_torch.kernels import fwdbwd as K
        from asr_craft_tpu_torch.models.crf import (apply_boundaries,
                                                    frame_posteriors,
                                                    potentials)
        torch = self.torch
        params, feats, labels, lengths = problem
        with torch.no_grad():
            state, trans = potentials(cfg, params, feats)
            state = apply_boundaries(cfg, state, lengths).contiguous()
            _, ac, _, zc = K.forward_dual(state, trans.contiguous(), labels,
                                          lengths, cfg.num_states)
            aligned = torch.exp(ac + betas[1] - zc[:, None, None])
            kernels.set_backend("torch")
            try:
                ref = frame_posteriors(cfg, params, feats, lengths)
            finally:
                kernels.set_backend("auto")
        self.close(f"{key} trained posteriors", post, ref, 0.0, 1e-3)
        for what, x in (("posteriors", post), ("clamped posteriors",
                                               aligned)):
            sums = x.sum(-1)
            if not torch.allclose(sums, torch.ones_like(sums), atol=1e-3):
                raise AssertionError(f"{key}: {what} sum to "
                                     f"{float(sums.min())}.."
                                     f"{float(sums.max())}")
        log(f"shared train {key}: the trained model's posteriors "
            f"{tuple(post.shape)} equal the plain version's and sum to 1; "
            "clamped posteriors sum to 1")

    def phase_shared_train_cli(self):
        from asr_craft_tpu_torch import kernels
        from asr_craft_tpu_torch.kernels import fwdbwd
        from asr_craft_tpu_torch.models.crf import (apply_boundaries,
                                                    frame_posteriors,
                                                    potentials)
        torch = self.torch
        configs = self.shared_configs()
        def require(path, counts, names):
            log(f"{path} launches {counts}")
            missing = [n for n in names if counts[n] < 1]
            if missing:
                raise AssertionError(f"{path} never launched {missing}")

        # Three paths, each with every count 0 before it and read after it.
        # The train CLI: K4, K5 and the CV decode's K7 / K8 + traceback.
        mark = launches("fwdbwd", "viterbi")
        runs = {key: self.run_shared_train_cli(key, "auto")
                for key in configs}
        train_counts = launches("fwdbwd", "viterbi", since=mark)
        require("shared train CLI", train_counts,
                ("forward_dual", "backward_dual_grad",
                 "backward_dual_contract", "viterbi_dense_fwd",
                 "viterbi_nstate_fwd", "viterbi_traceback"))
        # frame_posteriors of the trained models: K6a, K6b.
        problems = {key: self.trained_problem(cfg, runs[key][2])
                    for key, cfg in configs.items()}
        mark = launches("fwdbwd")
        with torch.no_grad():
            posts = {key: frame_posteriors(cfg, *problems[key][:2],
                                           problems[key][3])
                     for key, cfg in configs.items()}
        post_counts = launches("fwdbwd", since=mark)
        require("frame_posteriors", post_counts, ("forward", "backward"))
        # kernels.fwdbwd.backward_dual on the same potentials: K14.  It is
        # a public function that no higher entry point calls (the training
        # path takes the fused K5), so its count comes from calling it.
        duals = {}
        with torch.no_grad():
            for key, cfg in configs.items():
                params, feats, labels, lengths = problems[key]
                state, trans = potentials(cfg, params, feats)
                state = apply_boundaries(cfg, state, lengths)
                duals[key] = (state, trans, labels, lengths, cfg.num_states)
        mark = launches("fwdbwd")
        betas = {key: fwdbwd.backward_dual(*duals[key]) for key in configs}
        dual_counts = launches("fwdbwd", since=mark)
        require("kernels.fwdbwd.backward_dual", dual_counts,
                ("backward_dual",))
        self.fb_counts = {
            "forward": post_counts["forward"],
            "backward": post_counts["backward"],
            "forward_dual": train_counts["forward_dual"],
            "backward_dual": dual_counts["backward_dual"],
            "backward_dual_grad": train_counts["backward_dual_grad"],
            "backward_dual_contract": train_counts["backward_dual_contract"]}
        for key, cfg in configs.items():
            self.check_trained_posteriors(key, cfg, problems[key],
                                          posts[key], betas[key])
        mark = launches("fwdbwd", "viterbi")
        for key, cfg in configs.items():
            jax_losses, jax_per = SHARED_TRAIN[key][2:]
            losses, evals, wfile, secs = runs[key]
            plosses, pevals, _, psecs = self.run_shared_train_cli(key,
                                                                  "torch")
            kernels.set_backend("auto")
            log(f"shared train CLI {key}: losses {losses}, final PER "
                f"{evals[-1]['per']} (kernels, {secs:.3f} s wall); losses "
                f"{plosses}, final PER {pevals[-1]['per']} (plain, "
                f"{psecs:.3f} s wall); JAX CPU {jax_losses}, {jax_per}")
            if len(losses) != len(jax_losses):
                raise AssertionError(f"{key}: {len(losses)} epochs")
            for got, want in zip(losses, jax_losses):
                if abs(got - want) > 1e-3 * want:
                    raise AssertionError(f"{key}: epoch losses {losses}, "
                                         f"JAX reference {jax_losses} "
                                         "(rtol 1e-3)")
            for ev in (evals, pevals):
                if abs(ev[-1]["per"] - jax_per) > 0.02:
                    raise AssertionError(f"{key}: final PER "
                                         f"{ev[-1]['per']}, JAX reference "
                                         f"{jax_per} (+-0.02)")
            for a, b in zip(losses, plosses):
                if abs(a - b) > 1e-4 * abs(b):
                    raise AssertionError(f"{key}: kernel losses {losses} vs "
                                         f"plain {plosses} (rtol 1e-4)")
        plain_counts = launches("fwdbwd", "viterbi", since=mark)
        log(f"shared train CLI launches {plain_counts} (plain)")
        if max(plain_counts.values()) != 0:
            raise AssertionError(f"plain backend launched {plain_counts}")
        for key in configs:
            decode = (["--synthetic_utts", "128", "--batch_size", "64",
                       "--seed", "0", "--weight_file", str(runs[key][2]),
                       "--device", "cuda"] + SHARED_TRAIN[key][0])
            mlfs = [OUT / f"train_{key}_{b}.mlf" for b in ("auto", "torch")]
            rec, _ = self.run_cli(decode + ["--kernel_backend", "auto",
                                            "--out_mlf", str(mlfs[0])])
            rec_t, _ = self.run_cli(decode + ["--kernel_backend", "torch",
                                              "--out_mlf", str(mlfs[1])])
            kernels.set_backend("auto")
            if rec["per"] != rec_t["per"] or (mlfs[0].read_bytes()
                                              != mlfs[1].read_bytes()):
                raise AssertionError(f"{key}: the trained weights decode "
                                     "differently under the kernels and "
                                     "the plain version")
            log(f"shared train CLI {key}: within rtol 1e-3 of the JAX "
                f"losses, PER within 0.02; weights.final.dat decodes to "
                f"PER {rec['per']} and the same MLF under both backends")
            from asr_craft_tpu_torch.train import graphs
            with graphs.disabled():
                eager = self.run_shared_train_cli(key, "auto", "_eager")
            self.same_run(f"shared train CLI {key}", runs[key], eager)

    # -- (l) shared-transition training timing ----------------------------------
    def phase_fb_timing(self):
        from asr_craft_tpu_torch import kernels
        from asr_craft_tpu_torch.kernels import fwdbwd as K
        from asr_craft_tpu_torch.train import TrainConfig, Trainer, graphs
        torch = self.torch
        B, T = 128, 512
        audio_s = B * T * FRAME_S
        for key, cfg in self.shared_configs().items():
            state, trans, labels, lengths, params, feats = self.fb_problem(
                cfg, B, T, 0, ragged=False)
            cns, L = cfg.num_states, state.shape[-1]
            single = (state, trans, lengths)
            dual = (state, trans, labels, lengths)
            af, ac, zf, zc = K.forward_dual_cuda(*dual, cns)
            ones = torch.ones_like(zf)
            grad_in = (af, ac, zf, zc, ones, -ones)
            batch = {"feats": feats, "labels": labels, "lengths": lengths}
            trainer = Trainer(cfg, TrainConfig(lr=0.03), params=params)

            def step(backend):
                # eager: phase (s) times the graph
                kernels.set_backend(backend)
                try:
                    with graphs.disabled():
                        trainer.train_step(batch, 0.03)
                finally:
                    kernels.set_backend("auto")

            # K5's rows, prebuilt by its recursion; the contraction on them
            # beside one cuBLAS fp32 product of the same rows
            _, U, V = K.backward_dual_grad_rows_cuda(*dual, *grad_in, cns)
            U2 = U[..., :L].reshape(-1, L).contiguous()
            V2 = V[..., :L].reshape(-1, L).contiguous()
            cublas = min(self.cuda_ms(lambda: U2.T @ V2, 20)
                         for _ in range(2))
            bounds = {name: self.bound(name, B=B, T=T, L=L)
                      for name in FB_SRC}
            fns = {
                "forward": (lambda: K.forward_cuda(*single),
                            lambda: K.forward_plain(*single)),
                "backward": (lambda: K.backward_cuda(*single),
                             lambda: K.backward_plain(*single)),
                "forward_dual": (lambda: K.forward_dual_cuda(*dual, cns),
                                 lambda: K.forward_dual_plain(*dual, cns)),
                "backward_dual": (lambda: K.backward_dual_cuda(*dual, cns),
                                  lambda: K.backward_dual_plain(*dual, cns)),
                "backward_dual_grad": (
                    lambda: K.backward_dual_grad_rows_cuda(*dual, *grad_in,
                                                           cns),
                    lambda: K.backward_dual_grad_rows_plain(*dual, *grad_in,
                                                            cns)),
                "backward_dual_contract": (
                    lambda: K.backward_dual_contract_cuda(U, V, L),
                    lambda: K.backward_dual_contract_plain(U, V, L)),
                "K5 whole (backward_dual_grad)": (
                    lambda: K.backward_dual_grad_cuda(*dual, *grad_in, cns),
                    lambda: K.backward_dual_grad_plain(*dual, *grad_in,
                                                       cns)),
                "train step (loss, backward, SGD)": (lambda: step("auto"),
                                                     lambda: step("torch")),
            }
            log(f"timing {key} cuBLAS U^T V on K5's rows ({U2.shape[0]} x "
                f"{L})^T ({U2.shape[0]} x {L}): {cublas:.4f} ms")
            for name, (kern, plain) in fns.items():
                # plain, kernel, kernel, plain: compare within one call only
                p1 = self.cuda_ms(plain, 1)
                k1 = self.cuda_ms(kern, 10)
                k2 = self.cuda_ms(kern, 10)
                p2 = self.cuda_ms(plain, 1)
                ms, plain_ms = min(k1, k2), min(p1, p2)
                self.times[f"{key} {name}"] = (ms, plain_ms)
                tail = ""
                if name in bounds:
                    self.bounds[f"{key} {name}"] = bounds[name]
                    b_ms, b_by = bounds[name]
                    tail = f"; bound {b_ms:.4f} ms by {b_by}"
                log(f"timing {key} {name} B={B} T={T}: kernel {ms:.4f} ms "
                    f"({k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms "
                    f"({p1:.4f}, {p2:.4f}); {audio_s / ms * 1e3:.1f} vs "
                    f"{audio_s / plain_ms * 1e3:.1f} audio-s/s{tail}")
            self.library_ms[f"{key} backward_dual_contract"] = cublas
            # how much of the step the device works, and on what
            self.device_share(f"{key} train step", lambda: step("auto"))

    # -- (m) segmental parity ---------------------------------------------------
    def seg_problem(self, B, T, seed, ragged=True, pooling="mean"):
        """A config-4 model that finds the batch's runs, and the kernels' own
        inputs (the frame scores and the combined bias).  The segmental
        bench's batch (N(0, 1) frames, labels in runs of 4; ``ragged``:
        lengths on run ends, row 0 full, the last row empty) with each
        frame's label marked in the first L dims (+3); parameters N(0, 1)
        at scale 0.1, with those dims feeding their labels (+2), every
        segment boundary costing 2 and, under mean pooling (where a
        segment's score does not grow with its length), each further frame
        of a segment earning 5.  Without these the best path of a random
        model is one segment a frame, and the duration argmaxes all 0."""
        import dataclasses

        from asr_craft_tpu_torch import flagship
        from asr_craft_tpu_torch.models.segmental import _frame_scores_and_bias
        torch = self.torch
        cfg = dataclasses.replace(flagship.scrf(), pooling=pooling)
        L = cfg.num_labels
        params = cfg.init_params(torch.Generator().manual_seed(seed), 0.1,
                                 self.dev)
        params["w_frame"][:L] += 2.0 * torch.eye(L, device=self.dev)
        params["b_trans"] -= 2.0
        if pooling == "mean":
            params["b_dur"] += 5.0 * torch.arange(
                cfg.max_dur, device=self.dev, dtype=torch.float32)[:, None]
        batch = flagship.scrf_batch(cfg, B, T, seed, self.dev, ragged)
        batch["feats"][..., :L] += 3.0 * torch.nn.functional.one_hot(
            batch["labels"].long(), L)
        with torch.no_grad():
            frame, bias = _frame_scores_and_bias(cfg, params, batch["feats"])
        return (cfg, params, batch, frame.contiguous(),
                params["b_trans"].contiguous(), bias.contiguous())

    def check_segmental(self, pooling, seed):
        from asr_craft_tpu_torch.kernels import segmental as K
        from asr_craft_tpu_torch.ops.segmental_stream import (
            _pack_segment_markers)
        torch = self.torch
        cfg, _, batch, frame, trans, bias = self.seg_problem(
            128, 512, seed, pooling=pooling)
        lengths, mean_pool = batch["lengths"], pooling == "mean"
        args = (frame, trans, bias, lengths)
        errs = {}

        def close(name, what, got, want, **tol):
            e = self.close(f"segmental {pooling} {what}", got, want, **tol)
            errs[name] = max(errs.get(name, 0.0), e)

        alphas, logZ = K.segmental_forward_cuda(*args, mean_pool)
        ra, rz = K.segmental_forward_plain(*args, mean_pool)
        close("segmental_forward", "alphas", alphas, ra, **FB_Z_TOL)
        close("segmental_forward", "logZ", logZ, rz, **FB_Z_TOL)
        rb = K.segmental_backward_plain(*args, mean_pool)
        close("segmental_backward", "betas",
              K.segmental_backward_cuda(*args, mean_pool), rb, **FB_Z_TOL)
        g = torch.ones_like(rz)
        grad_in = (ra.contiguous(), rb.contiguous(), rz.contiguous(), g)
        A, S, gd, gt = K.segmental_grad_cuda(*args, *grad_in, mean_pool)
        again = K.segmental_grad_cuda(*args, *grad_in, mean_pool)
        rA, rS, rgd, rgt = K.segmental_grad_plain(*args, *grad_in, mean_pool)
        close("segmental_grad", "A", A, rA, rtol=0.0, atol=SEG_G_ATOL)
        close("segmental_grad", "S", S, rS, rtol=0.0, atol=SEG_G_ATOL)
        gd_err = self.close(f"segmental {pooling} gd", gd, rgd, RTOL,
                            REL_MAX * float(rgd.abs().max()))
        gt_err = self.close(f"segmental {pooling} gt", gt, rgt, RTOL,
                            REL_MAX * float(rgt.abs().max()))
        if not all(torch.equal(x, y) for x, y in zip((A, S, gd, gt), again)):
            raise AssertionError(f"segmental {pooling}: K11 differs between "
                                 "two runs")
        if float(A[-1].abs().max()) != 0.0 or float(S[-1].abs().max()) != 0.0:
            raise AssertionError(f"segmental {pooling}: the empty row has a "
                                 "gradient")
        self.check_grad_parts(pooling, args, grad_in, mean_pool, errs)
        n_segs = {}
        for mode, thr in (("exact", None), ("beam_threshold=8", 8.0)):
            got = K.segmental_viterbi_cuda(*args, mean_pool, thr)
            want = K.segmental_viterbi_plain(*args, mean_pool, thr)
            names = ("deltas", "arg_d", "lab0", "scores")
            bad = [n for n, x, y in zip(names, got, want)
                   if not torch.equal(x, y)]
            tb = K.segmental_viterbi_traceback_cuda(got[0], got[1], trans,
                                                    got[2], lengths)
            rtb = K.segmental_viterbi_traceback_plain(want[0], want[1],
                                                      trans, want[2], lengths)
            bad += [n for n, x, y in zip(("end_lab", "end_start"), tb, rtb)
                    if not torch.equal(x, y)]
            packed = _pack_segment_markers(*tb)
            bad += [n for n, x, y in zip(("starts", "labels", "n_segs"),
                                         packed, _pack_segment_markers(*rtb))
                    if not torch.equal(x, y)]
            torch.cuda.synchronize()
            if bad:
                raise AssertionError(f"segmental {pooling} {mode}: {bad} "
                                     "differ from the plain version")
            if not torch.isfinite(got[3][:-1]).all() or int(packed[2][-1]):
                raise AssertionError(f"segmental {pooling} {mode}: bad "
                                     "scores or a segment in the empty row")
            errs["segmental_viterbi"] = max(
                errs.get("segmental_viterbi", 0.0),
                float((got[0] - want[0]).abs().max()))
            errs["segmental_viterbi_traceback"] = max(
                errs.get("segmental_viterbi_traceback", 0),
                int((tb[0] - rtb[0]).abs().max()))
            n_segs[mode] = int(packed[2].sum())
            if not int(lengths.sum()) // 8 < n_segs[mode] < \
                    int(lengths.sum()) * 3 // 4:
                raise AssertionError(f"segmental {pooling} {mode}: "
                                     f"{n_segs[mode]} segments in "
                                     f"{int(lengths.sum())} frames: the "
                                     "best paths do not follow the runs")
        for name, e in errs.items():
            self.err[name] = max(self.err[name], e)
        log(f"segmental parity {pooling} pooling: max |kernel - plain| "
            f"{errs}; |gd - plain| {gd_err:.3e} (largest "
            f"{float(rgd.abs().max()):.3e}), |gt - plain| {gt_err:.3e} "
            f"(largest {float(rgt.abs().max()):.3e}); K11 bit-equal on two "
            f"runs; deltas, arg_d, markers and packed segments equal "
            f"(segments {n_segs})")

    def check_grad_parts(self, pooling, args, grad_in, mean_pool, errs):
        """K11's three parts, each on its plain twin's inputs: the message
        pass (E within 1e-5, the messages as alphas, the running sums and
        row maxima equal on the live rows), the xi pass (A and S as K11's,
        F and gd as gt) and the contraction (on the tensor cores: as K5's
        alone, CONTRACT_REL_MAX of its largest entry)."""
        from asr_craft_tpu_torch.kernels import segmental as K
        torch = self.torch
        frame, trans, bias, lengths = args
        ra, rb, rz, g = grad_in
        B, T, L = frame.shape
        live = (torch.arange(T, device=self.dev)[None, :]
                < lengths[:, None].long())
        E, q, cs, m = K.segmental_grad_message_cuda(*args, ra)
        rE, rq, rcs, rm = K.segmental_grad_message_plain(*args, ra)
        self.close(f"segmental {pooling} message E", E, rE, 0.0, 1e-5)
        q_err = self.close(f"segmental {pooling} message q", q[live],
                           rq[live], **FB_Z_TOL)
        if not (torch.equal(cs[live], rcs[live])
                and torch.equal(m[live], rm[live])):
            raise AssertionError(f"segmental {pooling}: the message pass's "
                                 "running sums or row maxima differ")
        A, S, F, gd = K.segmental_grad_xi_cuda(rq, rcs, rm, rb, rz, g, bias,
                                               lengths, mean_pool)
        rA, rS, rF, rgd = K.segmental_grad_xi_plain(rq, rcs, rm, rb, rz, g,
                                                    bias, lengths, mean_pool)
        xi_err = max(self.close(f"segmental {pooling} xi A", A, rA, 0.0,
                                SEG_G_ATOL),
                     self.close(f"segmental {pooling} xi S", S, rS, 0.0,
                                SEG_G_ATOL))
        self.close(f"segmental {pooling} xi F", F[..., :L], rF[..., :L],
                   RTOL, REL_MAX * float(rF.abs().max()))
        self.close(f"segmental {pooling} xi gd", gd, rgd, RTOL,
                   REL_MAX * float(rgd.abs().max()))
        if float(F[-1].abs().max()) != 0.0:
            raise AssertionError(f"segmental {pooling}: the empty row has F "
                                 "rows")
        gt = K.segmental_grad_contract_cuda(rE, rF, L)
        rgt = K.segmental_grad_contract_plain(rE, rF, L)
        c_err = self.close(f"segmental {pooling} contraction gt", gt, rgt,
                           RTOL, CONTRACT_REL_MAX * float(rgt.abs().max()))
        for name, e in (("segmental_grad_message", q_err),
                        ("segmental_grad", xi_err),
                        ("segmental_grad_contract", c_err)):
            errs[name] = max(errs.get(name, 0.0), e)
        log(f"segmental parity {pooling} K11 parts alone: |q - plain| "
            f"{q_err:.3e}, |A, S - plain| {xi_err:.3e}, |gt - plain| "
            f"{c_err:.3e} (largest {float(rgt.abs().max()):.3e})")

    def check_scrf_loss_grads(self, pooling):
        """scrf_loss_fused + backward(): the K9-K11 path against the plain
        path (backend 'torch') on every parameter gradient."""
        from asr_craft_tpu_torch import kernels
        from asr_craft_tpu_torch.models.segmental import scrf_loss_fused
        cfg, params, batch, _, _, _ = self.seg_problem(128, 512, 1,
                                                       pooling=pooling)
        grads = {}
        for backend in ("auto", "torch"):
            kernels.set_backend(backend)
            try:
                p = {k: v.clone().requires_grad_(True)
                     for k, v in params.items()}
                loss, _ = scrf_loss_fused(cfg, p, batch["feats"],
                                          batch["labels"], batch["lengths"])
                loss.backward()
                grads[backend] = (loss.item(), {k: v.grad
                                                for k, v in p.items()})
            finally:
                kernels.set_backend("auto")
        (lk, gk), (lp, gp) = grads["auto"], grads["torch"]
        if not 0.0 < lk < 1e3:
            raise AssertionError(f"scrf_loss_fused {lk}: a gold run is "
                                 "inexpressible")
        if abs(lk - lp) > 1e-5 * abs(lp):
            raise AssertionError(f"scrf_loss_fused {lk} vs plain {lp}")
        errs = {k: self.close(f"scrf grad {k}", gk[k], gp[k], RTOL,
                              REL_MAX * float(gp[k].abs().max()))
                for k in gk}
        log(f"segmental parity scrf_loss_fused {pooling} pooling B=128 "
            f"T=512: loss {lk:.7f} (plain {lp:.7f}); max |grad - plain| "
            f"{errs}")

    def phase_seg_parity(self):
        for seed, pooling in enumerate(("mean", "sum")):
            self.check_segmental(pooling, seed)
            self.check_scrf_loss_grads(pooling)

    # -- (n) segmental end to end -----------------------------------------------
    def run_scrf(self, tag, backend, extra):
        from asr_craft_tpu_torch.recipes.scrf import main
        out = OUT / f"scrf_{tag}"
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(SCRF_FLAGS + extra + [
                "--device", "cuda", "--kernel_backend", backend, "--out_dir",
                str(out)])
        self.torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]
        if rc != 0:
            raise AssertionError(f"scrf recipe ({tag}) rc={rc}")
        losses = {r["epoch"]: r["loss"] for r in recs
                  if r["kind"] == "train_epoch"}
        evals = [r for r in recs if r["kind"] == "eval"]
        if len(evals) != 1:
            raise AssertionError(f"scrf recipe ({tag}): {len(evals)} evals")
        log(f"  scrf ({tag}, {backend}): {secs:.3f} s wall, losses "
            f"{json.dumps(losses)}, eval {json.dumps(evals[0])}")
        return losses, evals[0], out / "scrf_weights.npz"

    def phase_seg_recipe(self):
        from asr_craft_tpu_torch import kernels
        # the main path: the counts it added
        mark = launches("segmental")
        losses, ev, wfile = self.run_scrf("train", "auto",
                                          ["--epochs", "300"])
        self.seg_counts = launches("segmental", since=mark)
        log(f"scrf recipe launches {self.seg_counts}")
        if min(self.seg_counts.values()) < 1:
            raise AssertionError(f"a kernel never launched: "
                                 f"{self.seg_counts}")
        if sorted(losses) != sorted(JAX_SCRF_LOSSES):
            raise AssertionError(f"logged epochs {sorted(losses)}")
        for epoch, want in JAX_SCRF_LOSSES.items():
            if abs(losses[epoch] - want) > 1e-3 * want:
                raise AssertionError(f"epoch {epoch}: loss {losses[epoch]}, "
                                     f"JAX reference {want} (rtol 1e-3)")
        if ev["tokens"] != JAX_SCRF_TOKENS or \
                abs(ev["per"] - JAX_SCRF_PER) > 0.003:
            raise AssertionError(f"eval {ev}, JAX reference PER "
                                 f"{JAX_SCRF_PER} (+-0.003) on "
                                 f"{JAX_SCRF_TOKENS} tokens")
        mark = launches("segmental")
        _, dec, _ = self.run_scrf("decode_auto", "auto",
                                  ["--decode_only", str(wfile)])
        dec_counts = launches("segmental", since=mark)
        mark = launches("segmental")
        _, dec_t, _ = self.run_scrf("decode_torch", "torch",
                                    ["--decode_only", str(wfile)])
        l30, _, _ = self.run_scrf("train30_torch", "torch",
                                  ["--epochs", "30"])
        plain_counts = launches("segmental", since=mark)
        kernels.set_backend("auto")
        k30, _, _ = self.run_scrf("train30", "auto", ["--epochs", "30"])
        if (dec_counts["segmental_viterbi"],
                dec_counts["segmental_viterbi_traceback"]) != (1, 1):
            raise AssertionError(f"--decode_only launched {dec_counts}")
        if max(plain_counts.values()) != 0:
            raise AssertionError(f"plain backend launched {plain_counts}")
        for a, b in ((dec, ev), (dec_t, ev)):
            if (a["errors"], a["tokens"]) != (b["errors"], b["tokens"]):
                raise AssertionError(f"the same weights decode to {a} and "
                                     f"{b}")
        for epoch, want in l30.items():
            if abs(k30[epoch] - want) > 1e-4 * abs(want):
                raise AssertionError(f"kernel losses {k30} vs plain {l30} "
                                     "(rtol 1e-4)")
        log(f"scrf recipe: within rtol 1e-3 of the JAX losses, PER "
            f"{ev['per']} ({ev['errors']}/{ev['tokens']}; JAX "
            f"{JAX_SCRF_PER}); scrf_weights.npz decodes to the same counts "
            "under both backends; kernel and plain losses within rtol 1e-4 "
            "over 30 epochs")
        import numpy as np

        from asr_craft_tpu_torch.train import graphs
        with graphs.disabled():
            elosses, eev, ewfile = self.run_scrf("train_eager", "auto",
                                                 ["--epochs", "300"])
        w, ew = np.load(wfile), np.load(ewfile)
        exact = elosses == losses and all(
            np.array_equal(w[k], ew[k]) for k in w.files)
        if not exact and not (
                all(abs(elosses[e] - v) <= 1e-6 * abs(v)
                    for e, v in losses.items())
                and all(np.allclose(w[k], ew[k], rtol=1e-6, atol=0)
                        for k in w.files)):
            raise AssertionError(f"scrf recipe: graph losses {losses}, "
                                 f"eager {elosses}")
        if (eev["errors"], eev["tokens"]) != (ev["errors"], ev["tokens"]):
            raise AssertionError(f"scrf recipe: graph eval {ev}, eager "
                                 f"{eev}")
        log("scrf recipe: the Adam step through the CUDA graph and eagerly "
            "give the same losses, eval counts and weights "
            + ("bit for bit" if exact else "within rtol 1e-6 (cuBLAS)"))

    # -- (o) segmental timing ---------------------------------------------------
    def phase_seg_timing(self):
        from asr_craft_tpu_torch import kernels
        from asr_craft_tpu_torch.kernels import segmental as K
        from asr_craft_tpu_torch.models.segmental import (scrf_decode,
                                                          scrf_loss_fused)
        torch = self.torch
        B, T = 128, 512
        audio_s = B * T * FRAME_S
        cfg, params, batch, frame, trans, bias = self.seg_problem(
            B, T, 0, ragged=False)
        lengths = batch["lengths"]
        args = (frame, trans, bias, lengths)
        alphas, logZ = K.segmental_forward_cuda(*args)
        betas = K.segmental_backward_cuda(*args)
        grad_in = (alphas, betas, logZ, torch.ones_like(logZ))
        deltas, arg_d, lab0, _ = K.segmental_viterbi_cuda(*args)
        end_lab, _ = K.segmental_viterbi_traceback_cuda(deltas, arg_d, trans,
                                                        lab0, lengths)
        segments = int((end_lab >= 0).sum())
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        opt = torch.optim.SGD(p.values(), lr=0.05)

        def step(backend):
            kernels.set_backend(backend)
            try:
                opt.zero_grad(set_to_none=True)
                loss, _ = scrf_loss_fused(cfg, p, batch["feats"],
                                          batch["labels"], lengths)
                loss.backward()
                opt.step()
            finally:
                kernels.set_backend("auto")

        def decode(backend):
            kernels.set_backend(backend)
            try:
                return scrf_decode(cfg, p, batch["feats"], lengths)
            finally:
                kernels.set_backend("auto")

        frames = int(lengths.sum())
        bounds = {name: self.bound(name, B=B, T=T, L=cfg.num_labels,
                                   Dmax=cfg.max_dur, frames=frames,
                                   segments=segments)
                  for name in SEG_SRC}
        # K11's parts on their own inputs (the message pass's outputs); the
        # contraction beside one cuBLAS fp32 product of the same rows
        L = cfg.num_labels
        E, q, cs, m = K.segmental_grad_message_cuda(*args, alphas)
        xi_in = (q, cs, m, betas, logZ, grad_in[3], bias, lengths)
        F = K.segmental_grad_xi_cuda(*xi_in)[2]
        E2 = E[..., :L].reshape(-1, L).contiguous()
        F2 = F[..., :L].reshape(-1, L).contiguous()
        cublas = min(self.cuda_ms(lambda: E2.T @ F2, 20) for _ in range(2))
        self.library_ms["segmental_grad_contract"] = cublas
        log(f"timing cuBLAS E^T F on K11's rows ({E2.shape[0]} x {L})^T "
            f"({E2.shape[0]} x {L}): {cublas:.4f} ms")
        fns = {
            "segmental_forward": (
                lambda: K.segmental_forward_cuda(*args),
                lambda: K.segmental_forward_plain(*args)),
            "segmental_backward": (
                lambda: K.segmental_backward_cuda(*args),
                lambda: K.segmental_backward_plain(*args)),
            "segmental_grad_message": (
                lambda: K.segmental_grad_message_cuda(*args, alphas),
                lambda: K.segmental_grad_message_plain(*args, alphas)),
            "segmental_grad": (
                lambda: K.segmental_grad_xi_cuda(*xi_in),
                lambda: K.segmental_grad_xi_plain(*xi_in)),
            "segmental_grad_contract": (
                lambda: K.segmental_grad_contract_cuda(E, F, L),
                lambda: K.segmental_grad_contract_plain(E, F, L)),
            "K11 whole (segmental_grad)": (
                lambda: K.segmental_grad_cuda(*args, *grad_in),
                lambda: K.segmental_grad_plain(*args, *grad_in)),
            "segmental_viterbi": (
                lambda: K.segmental_viterbi_cuda(*args),
                lambda: K.segmental_viterbi_plain(*args)),
            "segmental_viterbi_traceback": (
                lambda: K.segmental_viterbi_traceback_cuda(
                    deltas, arg_d, trans, lab0, lengths),
                lambda: K.segmental_viterbi_traceback_plain(
                    deltas, arg_d, trans, lab0, lengths)),
            "scrf train step (loss, backward, SGD)": (
                lambda: step("auto"), lambda: step("torch")),
            "scrf_decode": (lambda: decode("auto"),
                            lambda: decode("torch")),
        }
        log(f"timing segmental: {frames} frames, {segments} segments on the "
            "best paths")
        for name, (kern, plain) in fns.items():
            # plain, kernel, kernel, plain: compare within one call only
            p1 = self.cuda_ms(plain, 1)
            k1 = self.cuda_ms(kern, 10)
            k2 = self.cuda_ms(kern, 10)
            p2 = self.cuda_ms(plain, 1)
            ms, plain_ms = min(k1, k2), min(p1, p2)
            self.times[name] = (ms, plain_ms)
            tail = ""
            if name in bounds:
                self.bounds[name] = bounds[name]
                b_ms, b_by = bounds[name]
                tail = f"; bound {b_ms:.4f} ms by {b_by}"
            log(f"timing {name} B={B} T={T}: kernel {ms:.4f} ms "
                f"({k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms "
                f"({p1:.4f}, {p2:.4f}); {audio_s / ms * 1e3:.1f} vs "
                f"{audio_s / plain_ms * 1e3:.1f} audio-s/s{tail}")
        # K13's own device time (its events read the wrapper's host time)
        # and us a dependent step: a segment of the best path
        tb = "seg_traceback_kernel"
        resident = self.kernel_ms(lambda: K.segmental_viterbi_traceback_cuda(
            deltas, arg_d, trans, lab0, lengths), tb)
        in_decode = self.kernel_ms(lambda: decode("auto"), tb)
        self.times["segmental_viterbi_traceback"] = (
            resident, self.times["segmental_viterbi_traceback"][1])
        per_utt = segments / B
        log(f"timing segmental_viterbi_traceback B={B} T={T} (trace, C = "
            f"{K.traceback_plan(trans.shape[0])[0]} frames a stream block): "
            f"{resident:.4f} ms alone ({resident * 1e3 / per_utt:.4f} us a "
            f"dependent step: {per_utt:.1f} segments an utterance), "
            f"{in_decode:.4f} ms inside scrf_decode "
            f"({in_decode * 1e3 / per_utt:.4f} us a segment)")
        t = {k: v[0] for k, v in self.times.items()}
        rest_step = (t["scrf train step (loss, backward, SGD)"]
                     - t["segmental_forward"] - t["segmental_backward"]
                     - t["K11 whole (segmental_grad)"])
        rest_dec = (t["scrf_decode"] - t["segmental_viterbi"]
                    - t["segmental_viterbi_traceback"])
        self.device_share("scrf train step", lambda: step("auto"))
        self.device_share("scrf_decode", lambda: decode("auto"))
        log(f"timing segmental: the step minus K9, K10, K11 (frame scores, "
            f"gold numerator, gradient assembly, SGD) {rest_step:.4f} ms; "
            f"scrf_decode minus K12, K13 (frame scores, marker packing) "
            f"{rest_dec:.4f} ms")


    # -- (s) the compiled step ---------------------------------------------------
    def same(self, label, got, want):
        """``got`` (a CUDA graph's) against ``want`` (eager): equal bit for
        bit, or, where a cuBLAS product differs under capture, floats
        within rtol 1e-6 (integers always equal).  Returns the largest
        relative difference."""
        from asr_craft_tpu_torch.train.graphs import leaves
        torch, worst = self.torch, 0.0
        for g, w in zip(leaves(got), leaves(want), strict=True):
            if torch.equal(g, w):
                continue
            if not g.dtype.is_floating_point or \
                    not torch.allclose(g, w, rtol=1e-6, atol=0):
                raise AssertionError(f"compiled {label}: graph and eager "
                                     f"differ: {g} vs {w}")
            worst = max(worst, float(((g - w).abs() / w.abs()).max()))
        return worst

    def compiled_path(self, label, make, warm, run, reps, timed=None):
        """One path of phase (s).  ``make()`` builds its state and
        ``warm(state)`` makes its first call (the graph's warm-up: eager
        by design, then the capture); ``run(state)`` is the compared call.
        Eager (``graphs.disabled()``) and through the graph, each with the
        launches ``run`` added to the counters: the results and the counts
        must agree.  Then the timing rows of ``timed(state)``
        (default ``run``): ms a call by events (eager, graph, graph,
        eager), and from a trace (``ab_timing.trace``) the wall and
        device-busy ms a call, the busy share, kernels a call and host
        launches a call."""
        from asr_craft_tpu_torch.train import graphs
        from asr_craft_tpu_torch.utils.ab_timing import trace
        torch = self.torch
        out = {}
        for mode in ("eager", "graph"):
            ctx = graphs.disabled() if mode == "eager" else \
                contextlib.nullcontext()
            with ctx:
                state = make()
                warm(state)
                torch.cuda.synchronize()
                mark = launches()
                got = run(state)
                torch.cuda.synchronize()
                counts = {k: v for k, v in launches(since=mark).items() if v}
            out[mode] = (state, got, counts)
        (_, want, ecounts), (state, got, gcounts) = out["eager"], \
            out["graph"]
        worst = self.same(label, got, want)
        if gcounts != ecounts or not gcounts:
            raise AssertionError(f"compiled {label}: launches {gcounts} "
                                 f"through the graph, {ecounts} eagerly")
        self.compiled_counts[label] = gcounts

        timed = timed or run

        def eager_fn():
            with graphs.disabled():
                timed(state)

        graph_fn = lambda: timed(state)
        e1 = self.cuda_ms(eager_fn, reps)
        g1 = self.cuda_ms(graph_fn, reps)
        g2 = self.cuda_ms(graph_fn, reps)
        e2 = self.cuda_ms(eager_fn, reps)
        ms, eager_ms = min(g1, g2), min(e1, e2)
        self.times[f"compiled {label}"] = (ms, eager_ms)
        rec = {mode: trace(self.dev, fn) for mode, fn in
               (("graph", graph_fn), ("eager", eager_fn))}
        self.compiled[label] = {"graph_ms": ms, "eager_ms": eager_ms,
                                **{f"{m} trace": r for m, r in rec.items()}}
        same = ("bit for bit" if worst == 0.0 else
                f"within rtol {worst:.2e} (cuBLAS)")
        traced = "; ".join(
            f"{m}: wall {r['wall_ms']:.4f} ms, busy {r['busy_ms']:.4f} ms "
            f"({r['pct']:.1f}%), {r['kernels']:g} kernels, "
            f"{r['host_launches']:g} host launches a call"
            if r else f"{m}: not measured (no device time in the trace)"
            for m, r in rec.items())
        log(f"compiled {label}: graph {ms:.4f} ms ({g1:.4f}, {g2:.4f}), "
            f"eager {eager_ms:.4f} ms ({e1:.4f}, {e2:.4f}) a call; graph = "
            f"eager {same}, launches {gcounts}; traced {traced}")

    def phase_compiled(self):
        from asr_craft_tpu_torch import flagship
        from asr_craft_tpu_torch.bench import captured_decode
        from asr_craft_tpu_torch.models.segmental import scrf_decode
        from asr_craft_tpu_torch.train import (TrainConfig, Trainer, graphs,
                                               make_train_step)
        from asr_craft_tpu_torch.train.trainer import scrf_loss_fn
        from asr_craft_tpu_torch.utils.logging import MetricsLogger
        torch, dev = self.torch, self.dev
        B, T, STEPS = 128, 512, 8
        quiet = MetricsLogger(quiet=True)

        def stacked(ms):
            return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

        def train_path(label, cfg, lr, spc, scale):
            params = cfg.init_params(torch.Generator().manual_seed(0),
                                     scale, dev)
            batches = [flagship.tiny_batch(cfg, B, T, s, dev)
                       for s in range(STEPS)]

            def make():
                return Trainer(cfg, TrainConfig(lr=lr), params=params,
                               logger=quiet)

            if spc == 1:
                warm = lambda tr: tr.train_step(batches[0], lr)
                run = lambda tr: (stacked([tr.train_step(b, lr)
                                           for b in batches]), tr.params)
                self.compiled_path(label, make, warm, run, 5, warm)
            else:
                warm = lambda tr: tr.multi_step(batches, lr)
                run = lambda tr: (tr.multi_step(batches, lr), tr.params)
                self.compiled_path(label, make, warm, run, 2)

        # the config-2 step alone and eight steps in one replay, the shared
        # steps: phases (f) and (l)'s shapes, learning rates and models
        train_path("config2 step", self.cfg, 0.5, 1, 0.01)
        train_path("config2 8 steps", self.cfg, 0.5, STEPS, 0.01)
        for key, cfg in self.shared_configs().items():
            train_path(f"{key} step", cfg, 0.03, 1, 0.1)

        # the config-4 step (the bench's: SGD at 0.05) and scrf_decode
        scfg = flagship.scrf()
        sparams = scfg.init_params(torch.Generator().manual_seed(0), 0.1,
                                   dev)
        sbatch = flagship.scrf_batch(scfg, B, T, 0, dev)

        def make_scrf():
            p = {k: v.clone().requires_grad_(True)
                 for k, v in sparams.items()}
            step, opt = make_train_step(scfg, TrainConfig(lr=0.05),
                                        loss_fn=scrf_loss_fn(scfg))
            return step, p, opt.init(p)

        def scrf_steps(st):
            step, p, state = st
            return stacked([step(p, state, {}, sbatch, 0.05)[3]
                            for _ in range(STEPS)]), p

        scrf_step = lambda st: st[0](st[1], st[2], {}, sbatch, 0.05)
        self.compiled_path("config4 step", make_scrf, scrf_step, scrf_steps,
                           5, scrf_step)

        def decode_path(label, dec, params, inputs):
            self.compiled_path(label, lambda: dec, lambda d: d(params,
                                                               inputs),
                               lambda d: d(params, inputs), 10)

        sinputs = {"feats": sbatch["feats"], "lengths": sbatch["lengths"]}
        decode_path("scrf_decode", graphs.Graphed(
            lambda q, b: scrf_decode(scfg, q, b["feats"], b["lengths"]),
            name="scrf_decode"), sparams, sinputs)
        for key, cfg, scale in (("config2", self.cfg, 0.01),
                                *((k, c, 0.1) for k, c in
                                  self.shared_configs().items())):
            params = cfg.init_params(torch.Generator().manual_seed(0), scale,
                                     dev)
            batch = flagship.tiny_batch(cfg, self.B, self.T, 0, dev)
            decode_path(f"{key} decode", captured_decode(cfg), params,
                        {"feats": batch["feats"],
                         "lengths": batch["lengths"]})
        log("compiled: " + json.dumps(self.compiled))

    # -- (p) calibration parity ---------------------------------------------------
    def phase_bench_calibrate(self):
        import numpy as np

        from asr_craft_tpu_torch.kernels import calibrate as K
        torch = self.torch
        Dmax, Ls, Bk, passes = 16, 48, 128, 16
        x = torch.from_numpy(np.random.default_rng(0).uniform(
            0.0, 1.0, size=(Ls, Bk)).astype(np.float32)).to(self.dev)
        before = launches("calibrate")["calibrate"]
        for label, steps in (("a short chain (grid_n=1, frames=2)", 2),
                             ("grid_n=2, frames=32", 64)):
            got = K.calibrate_chain_cuda(x, Dmax, passes, steps)
            want = K.calibrate_chain_plain(x, Dmax, passes, steps)
            torch.cuda.synchronize()
            err = self.close(f"calibrate {label}", got, want, 0.0, CAL_ATOL)
            if not torch.equal(got, got[:1].expand_as(got)):
                raise AssertionError(f"calibrate {label}: the window's "
                                     "slots differ")
            self.err["calibrate"] = max(self.err["calibrate"], err)
            log(f"calibrate parity {label}: max |kernel - plain| {err:.3e} "
                f"over the whole ({Dmax}, {Ls}, {Bk}) window (atol "
                f"{CAL_ATOL})")
        now = launches("calibrate")["calibrate"]
        if now != before + 2:
            raise AssertionError(f"calibrate launch count {now} after 2 "
                                 f"launches from {before}")
        # dead work: half the slots must take half the time
        recs = {d: K.measure(Dmax=d, Ls=Ls, Bk=Bk, passes=passes,
                             device=self.dev) for d in (8, 16)}
        r8, r16 = recs[8]["geps"], recs[16]["geps"]
        log(f"calibrate Dmax=16: {recs[16]['ms_per_launch']:.4f} ms a "
            f"launch, {r16:.1f} giga-element-operations/s; Dmax=8: "
            f"{recs[8]['ms_per_launch']:.4f} ms, {r8:.1f}")
        if not abs(r8 - r16) <= 0.25 * max(r8, r16):
            raise AssertionError(f"calibrate: rates {r8} (Dmax=8) and {r16} "
                                 "(Dmax=16) differ by more than 25%: some "
                                 "slots' work was not done")
        # the plain version at the full 8192 steps would take minutes: it is
        # timed at 8 steps and scaled by 8192 / 8
        steps = recs[16]["steps"]
        plain = min(self.cuda_ms(
            lambda: K.calibrate_chain_plain(x, Dmax, passes, 8), 2)
            for _ in range(2)) * steps / 8
        self.times["calibrate"] = (recs[16]["ms_per_launch"], plain)
        self.bounds["calibrate"] = self.rl.calibrate_phase(
            Dmax, Ls, Bk, passes, 32, steps // 32)[1]
        b_ms, b_by = self.bounds["calibrate"]
        log(f"timing calibrate Dmax={Dmax} Ls={Ls} Bk={Bk} steps={steps}: "
            f"kernel {recs[16]['ms_per_launch']:.4f} ms, plain "
            f"{plain:.4f} ms (8 steps timed, scaled); bound {b_ms:.4f} ms "
            f"by {b_by}")

    # -- (q) bench end to end -----------------------------------------------------
    def run_recipe(self, name):
        """One recipe twin at its own size, from a scratch directory (its
        ``--out_dir`` is relative): (losses, final CV PER, decode record)."""
        import importlib
        mod = importlib.import_module(f"asr_craft_tpu_torch.recipes.{name}")
        cwd = OUT / "recipes"
        cwd.mkdir(parents=True, exist_ok=True)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.chdir(cwd), contextlib.redirect_stdout(buf):
            mod.main(["--device", "cuda"])
        self.torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]
        losses = [r["mean_loss"] for r in recs if r["kind"] == "train_epoch"]
        evals = [r for r in recs if r["kind"] == "eval"]
        done = [r for r in recs if r["kind"] == "decode_done"]
        return losses, evals[-1]["per"], (done[0] if done else None), secs

    def check_bench_lines(self, lines):
        """Hold the bench's records to what no card can break."""
        recs = {}
        for ln in lines:
            if ln.startswith("{"):
                recs.update(json.loads(ln))
        missing = [k for k in ("calibration", "device_busy", "decode_floor",
                               "roofline_train", "roofline_decode", "scrf",
                               "aux", "metric") if k not in recs]
        if missing:
            raise AssertionError(f"bench printed no {missing}")
        scrf = recs["scrf"]
        shares = {}
        for label, rec in (("train", recs["roofline_train"]),
                           ("decode", recs["roofline_decode"]),
                           ("scrf train", scrf["roofline_train"]),
                           ("scrf decode", scrf["roofline_decode"])):
            for key in ("pct_of_sol", "pct_of_achievable_sol"):
                shares[f"{label} {key}"] = rec[key]
        shares["train pct_of_tile_floor"] = \
            recs["roofline_train"]["pct_of_tile_floor"]
        for key in ("train_pct_of_floor", "decode_pct_of_floor"):
            shares[f"scrf {key}"] = scrf["tile_floor"][key]
        bad = {k: v for k, v in shares.items() if not 0.0 < v <= 100.0}
        if bad:
            raise AssertionError(f"bench: shares outside (0, 100]: {bad}")
        cal = recs["calibration"]
        bw, el = cal["stream_gbps"], cal["elementwise"]
        if not 1000.0 < bw <= self.rl.H100.hbm_gbps:
            raise AssertionError(f"bench: stream bandwidth {bw} GB/s")
        fma_peak = self.rl.H100.fp32_tflops * 1e3 / 2       # 1e9 FMA a second
        if el["calibration"] != "kernel" or not 0.0 < el["geps"] < fma_peak:
            raise AssertionError(f"bench: elementwise record {el}")
        for label, fit, want in (("decode_floor", recs["decode_floor"],
                                  FDT_FRAME_US),
                                 ("scrf decode_floor", scrf["decode_floor"],
                                  SCRF_FRAME_US)):
            if fit["r2"] < 0.98 or \
                    abs(fit["per_frame_us"] - want) > 0.3 * want:
                raise AssertionError(f"bench {label}: {fit}, expected "
                                     f"{want} us a frame (+-30%), r2 >= "
                                     "0.98")
        if recs["vs_baseline"] is not None or not recs["value"] > 0 \
                or recs["metric"] != "train_audio_s_per_s_per_chip":
            raise AssertionError("bench: the metric line is not the last "
                                 "record")
        # Against phase (s)'s graph times of the same paths, where it ran:
        # within 1.5x.  Like with like: the bench's train step is a step of
        # its 8-step multi_step replay, its decodes and segmental step are
        # captured too.  (The bench trains at bf16x3, phase (s) at highest:
        # the precision changes the two products of a step, not its
        # recursions.)
        pairs = (("train step", recs["roofline_train"]["measured_ms"],
                  "compiled config2 8 steps", 8),
                 ("decode", recs["roofline_decode"]["measured_ms"],
                  "compiled config2 decode", 1),
                 ("scrf train step", scrf["train_ms"],
                  "compiled config4 step", 1),
                 ("scrf_decode", scrf["decode_ms"], "compiled scrf_decode",
                  1))
        for label, ms, key, steps in pairs:
            if key not in self.times:
                log(f"bench {label}: {ms:.4f} ms (phase (s) did not run: "
                    "not compared)")
                continue
            ref = self.times[key][0] / steps
            if not ref / 1.5 <= ms <= ref * 1.5:
                raise AssertionError(f"bench {label} {ms} ms through the "
                                     f"graphs, phase (s) read {ref} ms "
                                     "(1.5x)")
            log(f"bench {label}: {ms:.4f} ms through the graphs, phase (s) "
                f"read {ref:.4f} ms")
        log(f"bench: shares of the rooflines and floors {shares}; stream "
            f"{bw:.1f} GB/s, elementwise {el['geps']:.1f} Geps "
            f"({el['ms_per_launch']:.4f} ms a launch); decode floor "
            f"{recs['decode_floor']['per_frame_us']} us a frame (r2 "
            f"{recs['decode_floor']['r2']}), scrf decode floor "
            f"{scrf['decode_floor']['per_frame_us']} us a frame (r2 "
            f"{scrf['decode_floor']['r2']}); device busy "
            + json.dumps({k: v and v["pct"]
                          for k, v in recs["device_busy"].items()}))

    def phase_bench(self):
        from asr_craft_tpu_torch import bench
        mods = ("calibrate", "fdt_train", "fdt_viterbi", "segmental")
        # the main path: the counts it added
        mark = launches(*mods)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(["--device", "cuda"])
        self.torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        self.bench_counts = launches(*mods, since=mark)
        lines = buf.getvalue().splitlines()
        for ln in lines:
            log(f"  bench: {ln}")
        log(f"bench main: {secs:.3f} s wall, launches {self.bench_counts}")
        if rc != 0:
            raise AssertionError(f"bench main rc={rc}")
        missing = [k for k, v in self.bench_counts.items() if v < 1]
        if missing:
            raise AssertionError(f"bench main never launched {missing}")
        if not lines or "vs_baseline" not in lines[-1]:
            raise AssertionError("bench: the metric line is not last")
        self.check_bench_lines(lines)
        for name, (jax_losses, jax_per, jax_dec) in JAX_RECIPES.items():
            losses, per, dec, secs = self.run_recipe(name)
            log(f"recipe {name}: {secs:.3f} s wall, losses {losses}, final "
                f"CV PER {per}, decode "
                f"{dec and (dec['errors'], dec['tokens'])}; JAX CPU "
                f"{jax_losses[-1]}, {jax_per}, {jax_dec}")
            if len(losses) != len(jax_losses):
                raise AssertionError(f"recipe {name}: {len(losses)} epochs")
            for got, want in zip(losses, jax_losses):
                if abs(got - want) > 1e-3 * want:
                    raise AssertionError(f"recipe {name}: losses {losses}, "
                                         f"JAX reference {jax_losses} "
                                         "(rtol 1e-3)")
            if abs(per - jax_per) > 0.02:
                raise AssertionError(f"recipe {name}: final CV PER {per}, "
                                     f"JAX reference {jax_per} (+-0.02)")
            if jax_dec is not None:
                if dec is None or dec["tokens"] != jax_dec[1] or \
                        abs(dec["per"] - jax_dec[0] / jax_dec[1]) > 0.02:
                    raise AssertionError(f"recipe {name}: decode {dec}, "
                                         f"JAX reference {jax_dec} (PER "
                                         "+-0.02)")
        log("recipes: the four twins are within rtol 1e-3 of the JAX CPU "
            "losses and within 0.02 of its PERs")

    # -- (r) diagnostics ----------------------------------------------------------
    def phase_bench_diagnostics(self):
        from asr_craft_tpu_torch.cli.train import main
        from asr_craft_tpu_torch.models.weights import save_raw
        from asr_craft_tpu_torch.utils import diagnostics
        flags = ["--synthetic_utts", "64", "--crf_label_size", "48",
                 "--crf_states", "3", "--window_extent", "1",
                 "--crf_transftr_end", "144", "--batch_size", "64",
                 "--crf_epochs", "1", "--crf_lr", "0.5", "--seed", "0",
                 "--device", "cuda"]

        def run(tag, extra):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(flags + ["--out_dir", str(OUT / f"diag_{tag}")]
                          + extra)
            self.torch.cuda.synchronize()
            return rc, [json.loads(ln) for ln in buf.getvalue().splitlines()
                        if ln.startswith("{")]

        prof = OUT / "diag_profile"
        rc, recs = run("trace", ["--profile_dir", str(prof)])
        trace = prof / "trace.json"
        if rc != 0 or not trace.is_file() or trace.stat().st_size == 0:
            raise AssertionError(f"--profile_dir: rc {rc}, no trace at "
                                 f"{trace}")
        text = trace.read_text()
        if "fdt_train_fwd_kernel" not in text:
            raise AssertionError("--profile_dir: the trace does not name "
                                 "fdt_train_fwd_kernel")
        events = json.loads(text)["traceEvents"]
        kernel_us = sum(e.get("dur", 0) for e in events
                        if e.get("cat") == "kernel")
        spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("ph") == "X" and "ts" in e]
        traced_us = max(b for _, b in spans) - min(a for a, _ in spans)
        epoch = [r for r in recs if r["kind"] == "train_epoch"][0]
        log(f"diagnostics --profile_dir: {trace.stat().st_size} bytes, "
            f"names fdt_train_fwd_kernel; the traced epoch loop (one epoch "
            f"on 64 utterances, its CV pass and checkpoint) spans "
            f"{traced_us / 1e3:.3f} ms, the device was busy "
            f"{kernel_us / 1e3:.3f} ms of it "
            f"({100 * kernel_us / traced_us:.1f}%); the CLI's own epoch "
            f"wall {epoch['wall_s'] * 1e3:.3f} ms")
        # one NaN in the initial weights
        params = self.cfg.init_params(device="cpu")
        params["w_state"][0, 0] = float("nan")
        bad = OUT / "diag_nan.dat"
        save_raw(bad, self.cfg.fmap, params)
        try:
            try:
                run("nan_flag", ["--init_weight_file", str(bad),
                                 "--debug_nans"])
            finally:
                diagnostics.enable_debug_nans(False)
        except FloatingPointError as exc:
            log(f"diagnostics --debug_nans: FloatingPointError ({exc})")
        else:
            raise AssertionError("--debug_nans: a NaN weight raised nothing")
        rc, recs = run("nan_plain", ["--init_weight_file", str(bad)])
        if rc != 0 or not any(r["kind"] == "done" for r in recs):
            raise AssertionError(f"without --debug_nans the run did not end "
                                 f"(rc {rc})")
        log("diagnostics: without --debug_nans the same run ends (mean "
            f"loss {[r['mean_loss'] for r in recs if r['kind'] == 'train_epoch']})")

    # -- (u) precision --------------------------------------------------------
    def precision_batch(self, B, T, seed=0):
        """A synthetic corpus batch at the flagship's widths: B utterances
        of T frames of 48 posterior-like dims in a +/-1 window (144 dims),
        their frame labels and phone sequences (the train CLI's data:
        phones of at least 3 frames, one a state)."""
        import numpy as np
        from asr_craft_tpu_torch import data
        torch = self.torch
        scfg = data.SyntheticConfig(num_labels=48, feat_dim=48, min_len=T,
                                    max_len=T, seed=seed,
                                    min_dur=self.cfg.num_states)
        feats, labels, phones = data.generate_corpus(scfg, B)
        x = np.stack([data.context_window(f, 1) for f in feats])
        return ({"feats": torch.from_numpy(x.astype(np.float32)).to(self.dev),
                 "labels": torch.from_numpy(np.stack(labels).astype(
                     np.int32)).to(self.dev),
                 "lengths": torch.full((B,), T, dtype=torch.int32,
                                       device=self.dev)}, phones)

    def phase_precision(self):
        import dataclasses

        import numpy as np
        from asr_craft_tpu_torch.decode.scorer import (ErrorRateScorer,
                                                       score_batch)
        from asr_craft_tpu_torch.flagship import tiny_batch
        from asr_craft_tpu_torch.kernels import fdt_train as K
        from asr_craft_tpu_torch.kernels import fdt_viterbi as KV
        from asr_craft_tpu_torch.models.crf import decode
        from asr_craft_tpu_torch.ops import precision as prec
        from asr_craft_tpu_torch.train import TrainConfig, Trainer
        from asr_craft_tpu_torch.utils import diagnostics
        torch, cfg = self.torch, self.cfg
        modes = ("bf16x3", "default")
        self.precision = {}
        # 1. the kernels against their plain versions at each mode
        B, T = 128, 512
        params = cfg.init_params(torch.Generator().manual_seed(0), 0.01,
                                 self.dev)
        batch, _ = self.precision_batch(B, T)
        feats, labels, lengths = (batch["feats"], batch["labels"],
                                  batch["lengths"])
        Wall, u0, u1, dims = self.wall.build_wall(params, cfg.fmap,
                                                  cfg.num_states)
        kw = dict(u0=u0, u1=u1, ns=cfg.num_states, P=dims["P"],
                  clamp_ns=cfg.num_states, boundaries=True)
        R, Du, D = Wall.shape[0], u1 - u0, feats.shape[2]
        small = self.problem(dataclasses.replace(cfg, num_labels=128), 2, 24,
                             5)
        a64 = lambda x: x.double().abs()

        def within(label, got, want, mag):
            err = float((got - want).abs().max())
            if not bool(torch.isfinite(got).all()) or not bool(
                    ((got.double() - want).abs()
                     <= CONTRACT_REL_MAX * mag).all()):
                raise AssertionError(f"{label}: max abs difference {err} "
                                     f"(1e-5 of the terms' magnitudes)")
            return err

        for mode in modes:
            errs = {}
            for label, (W, f) in (("flagship", (Wall, feats)),
                                  ("P=128", small[:2])):
                got = K.fdt_planes_cuda(W, f, u0=u0, u1=u1, precision=mode)
                want = K.fdt_planes_torch(W, f, u0=u0, u1=u1,
                                          precision=mode)
                mag = K.fdt_planes_torch(a64(W), a64(f), u0=u0, u1=u1)
                errs[f"planes {label}"] = within(
                    f"{mode} planes {label}", got[..., :want.shape[-1]],
                    want, mag)
                del got, want, mag
            alphas, zf, zc, planes = K.fdt_forward_cuda(
                Wall, feats, labels, lengths, **kw, precision=mode)
            ones = torch.ones_like(zf)
            dplane = K.fdt_dplane_cuda(Wall, feats, labels, lengths, alphas,
                                       zf, zc, ones, -ones, **kw,
                                       planes=planes)
            dW = torch.empty((R, Du + 1), device=self.dev)
            dX = torch.zeros_like(feats)
            for m, out, src, plain_src in ((0, dW, feats, feats),
                                           (1, dX, Wall, (Wall, feats))):
                got = K.contract_cuda(dplane, src, out, mode=m, D=D, u0=u0,
                                      Du=Du, precision=mode)
                want = K.contract_wall_torch(dplane, plain_src, mode=m,
                                             u0=u0, u1=u1, precision=mode)
                errs[f"contract mode {m}"] = self.close(
                    f"{mode} contraction mode {m}", got, want, RTOL,
                    REL_MAX * float(want.abs().max()))
                del want
            # K3: the decode's planes at this mode, then its recursion and
            # traceback, against the plain version (near-tie rule)
            dB = self.B
            before = launches("fdt_viterbi")["fdt_viterbi_plane"]
            dkw = dict(u0=u0, u1=u1, ns=cfg.num_states, P=dims["P"],
                       precision=mode)
            paths, scores = KV.fdt_viterbi_cuda(Wall, feats[:dB],
                                                lengths[:dB], **dkw)
            rpaths, rscores = KV.fdt_viterbi_wall_torch(Wall, feats[:dB],
                                                        lengths[:dB], **dkw)
            torch.cuda.synchronize()
            if launches("fdt_viterbi")["fdt_viterbi_plane"] <= before:
                raise AssertionError("K3 launched no plane kernel")
            errs["K3 scores"] = self.close(f"{mode} K3 scores", scores,
                                           rscores, SCORE_TOL["rtol"],
                                           SCORE_TOL["atol"])
            diff = (paths != rpaths).any(dim=1)
            if bool(diff.any()):
                rplanes = self.wall.plane_blocks(K.fdt_planes_torch(
                    Wall, feats[:dB], u0=u0, u1=u1, precision=mode),
                    cfg.num_states, dims["P"])
                rescored = self.fdt.path_score(*rplanes, paths,
                                               lengths[:dB], cfg.num_states)
                self.close(f"{mode} K3 near-ties", rescored[diff],
                           rscores[diff], SCORE_TOL["rtol"],
                           SCORE_TOL["atol"])
            self.precision[f"parity {mode}"] = errs
            log(f"precision parity {mode}: max |kernel - plain| "
                + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})
                + f"; K3 paths differing {int(diff.sum())}/{dB} "
                "(near-ties)")

        # 2. three config-2 train steps and a decode at each mode, one
        #    start, beside highest's
        scorer_of = {}
        losses = {}
        counts = {}
        tbatch, phones = self.precision_batch(B, T, seed=1)
        for mode in ("highest",) + modes:
            mcfg = dataclasses.replace(cfg, precision=mode)
            mark = launches("fdt_train", "fdt_viterbi")
            tr = Trainer(mcfg, TrainConfig(lr=0.5), device=self.dev)
            ls = [float(tr.train_step(tbatch, 0.5)["loss"])
                  for _ in range(3)]
            with torch.no_grad():
                ph, _, _ = decode(mcfg, tr.params, tbatch["feats"],
                                  tbatch["lengths"])
            torch.cuda.synchronize()
            counts[mode] = launches("fdt_train", "fdt_viterbi", since=mark)
            sc = ErrorRateScorer()
            score_batch(sc, phones, ph.cpu().numpy(),
                        tbatch["lengths"].cpu().numpy())
            losses[mode], scorer_of[mode] = ls, sc.error_rate
            log(f"precision steps {mode}: losses {ls}, decode PER "
                f"{sc.error_rate:.6f}; launches {counts[mode]}")
        for mode in modes:
            if min(counts[mode].values()) < 1:
                raise AssertionError(f"{mode}: a kernel never launched: "
                                     f"{counts[mode]}")
            delta = [abs(a - b) for a, b in zip(losses[mode],
                                                losses["highest"])]
            self.precision[f"steps {mode}"] = {
                "loss_delta": delta,
                "per": scorer_of[mode], "per_highest": scorer_of["highest"]}
            if any(d > PREC_LOSS_RTOL * abs(h)
                   for d, h in zip(delta, losses["highest"])):
                raise AssertionError(f"{mode}: losses {losses[mode]} vs "
                                     f"highest {losses['highest']} (rtol "
                                     f"{PREC_LOSS_RTOL})")
            if abs(scorer_of[mode] - scorer_of["highest"]) > PREC_PER_TOL:
                raise AssertionError(f"{mode}: PER {scorer_of[mode]} vs "
                                     f"highest {scorer_of['highest']}")
            log(f"precision steps {mode}: |loss - highest's| {delta} "
                f"(rtol {PREC_LOSS_RTOL}); PER {scorer_of[mode]:.6f} vs "
                f"{scorer_of['highest']:.6f} (+-{PREC_PER_TOL})")

        # 3. one shared-config step (config 5) at bf16x3 beside highest
        shared = self.shared_configs()["config5"]
        sp = {}
        for mode in ("highest", "bf16x3"):
            scfg = dataclasses.replace(shared, precision=mode)
            mark = launches("fwdbwd")
            sbatch = tiny_batch(scfg, B, T, 3, self.dev)
            params5 = scfg.init_params(torch.Generator().manual_seed(3), 0.1,
                                       self.dev)
            tr = Trainer(scfg, TrainConfig(lr=0.03), params=params5)
            sp[mode] = float(tr.train_step(sbatch, 0.03)["loss"])
            ran = launches("fwdbwd", since=mark)
            if mode == "bf16x3" and min(
                    ran[k] for k in ("forward_dual",
                                     "backward_dual_grad")) < 1:
                raise AssertionError(f"config 5 step: {ran}")
        d5 = abs(sp["bf16x3"] - sp["highest"])
        self.precision["config5 step bf16x3 loss_delta"] = d5
        if d5 > 2e-4 * (1 + abs(sp["highest"])):
            raise AssertionError(f"config 5 step at bf16x3: loss {sp}")
        log(f"precision config5 step: loss {sp['bf16x3']} at bf16x3, "
            f"{sp['highest']} at highest, delta {d5:.3e} (rtol = atol "
            "2e-4)")

        # 4. the train CLI at --optimizer lbfgs against the JAX CPU run
        from asr_craft_tpu_torch.cli.train import main
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(TRAIN_FLAGS + ["--device", "cuda", "--optimizer",
                                     "lbfgs", "--out_dir",
                                     str(OUT / "train_lbfgs")])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]
        lb = [r["mean_loss"] for r in recs if r["kind"] == "train_epoch"]
        per = [r["per"] for r in recs if r["kind"] == "eval"]
        log(f"precision lbfgs CLI: {secs:.3f} s wall, losses {lb}, final PER "
            f"{per[-1] if per else None}; JAX CPU {list(JAX_LBFGS_LOSSES)}, "
            f"{JAX_LBFGS_PER}")
        if rc != 0 or len(lb) != len(JAX_LBFGS_LOSSES):
            raise AssertionError(f"lbfgs CLI rc={rc}, {len(lb)} epochs")
        for got, want in zip(lb, JAX_LBFGS_LOSSES):
            if abs(got - want) > 1e-3 * want:
                raise AssertionError(f"lbfgs losses {lb}, JAX reference "
                                     f"{JAX_LBFGS_LOSSES} (rtol 1e-3)")
        if abs(per[-1] - JAX_LBFGS_PER) > 0.02:
            raise AssertionError(f"lbfgs PER {per[-1]}, JAX {JAX_LBFGS_PER}")
        self.precision["lbfgs"] = {"losses": lb, "per": per[-1]}

        # 5. times: the plane kernel (train and decode batches) and the
        #    contraction at each mode, the plain version, one torch.mm with
        #    TF32 allowed, and the bound at the mode
        xu2 = self.wall.feats_xu(feats, u0, u1).reshape(B * T, Du + 1)
        dp2 = dplane.reshape(B * T, R)
        xu_dec = xu2[:self.B * T]
        shape = dict(T=T, L=cfg.num_states * dims["P"], D=D,
                     ns=cfg.num_states, Du=Du)
        for mode in ("highest",) + modes:
            rows = {
                "fdt_train_plane": (
                    lambda: K.fdt_planes_cuda(Wall, feats, u0=u0, u1=u1,
                                              precision=mode),
                    lambda: K.fdt_planes_torch(Wall, feats, u0=u0, u1=u1,
                                               precision=mode),
                    lambda: torch.mm(xu2, Wall.T), B),
                "fdt_viterbi_plane": (
                    lambda: K.fdt_planes_cuda(Wall, feats[:self.B], u0=u0,
                                              u1=u1, precision=mode),
                    lambda: K.fdt_planes_torch(Wall, feats[:self.B], u0=u0,
                                               u1=u1, precision=mode),
                    lambda: torch.mm(xu_dec, Wall.T), self.B),
                "fdt_train_contract": (
                    lambda: K.contract_cuda(dplane, feats, dW, mode=0, D=D,
                                            u0=u0, Du=Du, precision=mode),
                    lambda: K.contract_wall_torch(dplane, feats, mode=0,
                                                  u0=u0, u1=u1,
                                                  precision=mode),
                    lambda: torch.mm(dp2.T, xu2), B),
            }
            for name, (kern, plain, lib, nb) in rows.items():
                p1 = self.cuda_ms(plain, 1)
                before = diagnostics.launches()
                k1, k2 = self.cuda_ms(kern, 10), self.cuda_ms(kern, 10)
                took = [k[k.index("[") + 1:-1] for k, v in
                        diagnostics.launches().items()
                        if "_plane[" in k and v > before.get(k, 0)]
                p2 = self.cuda_ms(plain, 1)
                lib_ms = None
                if mode != "bf16x3":
                    # the library call of the same function: cuBLAS in
                    # fp32 (highest) or with TF32 allowed (default)
                    with prec.tf32(mode == "default"):
                        lib_ms = min(self.cuda_ms(lib, 10),
                                     self.cuda_ms(lib, 10))
                bound_ms, bound_by = self.rl.bound(
                    self.rl.kernel_phase(name, B=nb, **shape), mode=mode)
                row = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": lib_ms, "path": ",".join(took) or None}
                self.precision[f"time {name} {mode}"] = row
                log(f"precision timing {name} {mode} B={nb} T={T}: kernel "
                    f"{row['ms']:.4f} ms ({k1:.4f}, {k2:.4f}"
                    + (f"; {row['path']}" if took else "") + "), plain "
                    f"{row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                    f"({bound_by}), torch.mm "
                    + (f"{lib_ms:.4f} ms" if lib_ms is not None else
                       "none (no single call computes bf16x3)"))
        log("precision: " + json.dumps(self.precision))

    # -- (t) multi-GPU ------------------------------------------------------
    def dp_path(self, mesh, label, cfg, lr):
        """The data-parallel step against the single-process one (phase
        (s)'s): 8 steps one a replay, then 8 in one multi_step, each side
        with the launches it added counted; bit-equal metrics and
        parameters, equal counts; ms a step through the graphs."""
        from asr_craft_tpu_torch import flagship
        from asr_craft_tpu_torch.train import TrainConfig, Trainer
        from asr_craft_tpu_torch.utils.logging import MetricsLogger
        torch, dev = self.torch, self.dev
        B, T, STEPS = 128, 512, 8
        params = cfg.init_params(torch.Generator().manual_seed(0), 0.01, dev)
        batches = [flagship.tiny_batch(cfg, B, T, s, dev)
                   for s in range(STEPS)]
        out = {}
        for side in ("dp", "single"):
            tr = Trainer(cfg, TrainConfig(lr=lr), params=params,
                         logger=MetricsLogger(quiet=True),
                         mesh=mesh if side == "dp" else None)
            tr.train_step(batches[0], lr)           # warm-up and capture
            tr.multi_step(batches, lr)
            torch.cuda.synchronize()
            mark = launches()
            ms = [tr.train_step(b, lr) for b in batches]
            multi = tr.multi_step(batches, lr)
            torch.cuda.synchronize()
            counts = {k: v for k, v in launches(since=mark).items() if v}
            step_ms = self.cuda_ms(lambda: tr.train_step(batches[0], lr), 5)
            multi_ms = self.cuda_ms(lambda: tr.multi_step(batches, lr),
                                    2) / STEPS
            got = ({k: torch.stack([m[k] for m in ms]) for k in ms[0]},
                   multi, {k: v.detach() for k, v in tr.params.items()})
            out[side] = (got, counts, step_ms, multi_ms)
        (dp, dcounts, d_ms, d_multi), (one, scounts, s_ms, s_multi) = \
            out["dp"], out["single"]
        for part in range(2):
            for k in ("loss", "grad_norm", "frames"):
                if not torch.equal(dp[part][k], one[part][k]):
                    raise AssertionError(f"multi-GPU {label}: {k} "
                                         f"{dp[part][k]} data-parallel, "
                                         f"{one[part][k]} single")
        for k, v in one[2].items():
            if not torch.equal(dp[2][k], v):
                raise AssertionError(f"multi-GPU {label}: parameter {k} "
                                     "differs")
        if dcounts != scounts or not dcounts:
            raise AssertionError(f"multi-GPU {label}: launches {dcounts} "
                                 f"data-parallel, {scounts} single")
        ref = self.times.get(f"compiled {label} step")
        self.multigpu[label] = {"dp_step_ms": d_ms, "single_step_ms": s_ms,
                                "dp_multi_step_ms": d_multi,
                                "single_multi_step_ms": s_multi,
                                "phase_s_step_ms": ref and ref[0],
                                "launches": dcounts}
        log(f"multi-GPU {label} step (B={B}, T={T}, one NCCL rank): losses, "
            f"gradient norms, frames and parameters after 8 steps and 8 in "
            f"one multi_step bit-equal to the single-process step; "
            f"launches {dcounts}; through the graphs {d_ms:.4f} ms a step "
            f"data-parallel, {s_ms:.4f} single ("
            + (f"phase (s): {ref[0]:.4f}" if ref else "phase (s) not run")
            + f"); in one 8-step replay {d_multi:.4f} / {s_multi:.4f} ms a "
            "step")

    def posterior_inputs(self, cfg, B, T, seed=0):
        """Phone-posterior frames (one-hot phones in runs of 4 frames plus
        N(0, 0.3) noise, a +/-2 window) and ``flagship.posterior_model``
        at window 2: a model whose pruned lattice stays alive, where a
        random model's K=12 survivors of 138 states connect no path
        through the 3-state topology (the lattice dies: every score a sum
        of NEG_INF terms on both sides, which nothing can compare)."""
        import numpy as np

        from asr_craft_tpu_torch.flagship import posterior_model
        from asr_craft_tpu_torch.models.weights import params_from_numpy
        torch, P = self.torch, cfg.num_labels
        rng = np.random.default_rng(seed)
        phones = np.repeat(rng.integers(0, P, size=(B, T // 4 + 1)), 4,
                           axis=1)[:, :T + 4]
        onehot = np.eye(P, dtype=np.float32)[phones]        # (B, T+4, P)
        feats = np.concatenate([onehot[:, w:w + T] for w in range(5)],
                               axis=-1)
        feats += rng.normal(0.0, 0.3, size=feats.shape).astype(np.float32)
        params = params_from_numpy(posterior_model(cfg, 2, seed), self.dev)
        return params, torch.from_numpy(feats).to(self.dev)

    def sharded_path(self, label, cfg, params, B, T, N, beam_labels,
                     feats=None):
        """``sharded_decode`` against the unsharded decode at config 5, by
        the near-tie rule; its time, decode()'s and the chunk product's.  A
        row whose reference lattice is dead (score below NEG_INF / 2) must
        be dead on both sides; every other row is compared."""
        from asr_craft_tpu_torch.flagship import ragged_lengths, tiny_batch
        from asr_craft_tpu_torch.kernels.viterbi import viterbi_shared
        from asr_craft_tpu_torch.models.crf import (apply_boundaries, decode,
                                                    potentials)
        from asr_craft_tpu_torch.ops.semiring import NEG_INF, TROPICAL
        from asr_craft_tpu_torch.ops.viterbi import path_score
        from asr_craft_tpu_torch.parallel import timeshard as TS
        torch, dev = self.torch, self.dev
        if feats is None:
            feats = tiny_batch(cfg, B, T, 0, dev)["feats"]
        lengths = torch.from_numpy(ragged_lengths(B, T, 0)).to(dev)
        # a row that ends mid-way where ragged_lengths leaves one empty:
        # an empty row scores 0 sharded (and its logZ is 0) where the
        # unsharded recursions read frame 0 (the JAX package's contract,
        # parallel.timeshard.sharded_decode)
        lengths[-1] = T // 3
        run = lambda: TS.sharded_decode(cfg, params, feats, lengths, N,
                                        beam_labels=beam_labels)
        _, path, score = run()
        state, trans = potentials(cfg, params, feats)
        state = apply_boundaries(cfg, state, lengths).contiguous()
        trans = trans.contiguous()
        base = state
        if beam_labels is not None:     # K8 on the survivor-masked lattice
            mask = TS.survivor_mask(state, lengths, N, beam_labels)
            base = torch.where(mask, state, NEG_INF).contiguous()
        rpath, rscore = viterbi_shared(base, trans, lengths, cfg.num_states)
        ref_run = lambda: decode(cfg, params, feats, lengths)
        torch.cuda.synchronize()
        alive = rscore > NEG_INF / 2
        if not torch.equal(alive, score > NEG_INF / 2) or not bool(
                alive.any()):
            raise AssertionError(f"multi-GPU {label}: rows alive "
                                 f"{alive.tolist()} unsharded, "
                                 f"{(score > NEG_INF / 2).tolist()} sharded")
        # the scores are fp32 sums over a row's frames, associated chunk by
        # chunk on one side and frame by frame on the other: ~sqrt(T) eps
        # relative apart, 7.7e-6 at T=16384 and heavier in the tail; the
        # paths, rescored in one order, are held to 1e-5 at any T
        rtol = SHARD_RTOL if T <= 512 else SHARD_LONG_RTOL
        self.close(f"multi-GPU {label} scores", score[alive], rscore[alive],
                   rtol, 0.0)
        rel = float(((score - rscore).abs() / rscore.abs())[alive].max())
        differ = (path != rpath).any(dim=1) & alive
        if bool(differ.any()):
            a = path_score(base, trans, path, lengths)[differ]
            b = path_score(base, trans, rpath, lengths)[differ]
            self.close(f"multi-GPU {label} near ties", a, b, SHARD_RTOL, 0.0)
        ms = self.cuda_ms(run, 1)
        ref_ms = self.cuda_ms(ref_run, 3)
        # the chunk product alone, on the same chunks
        mesh = TS.time_mesh(N, "cuda")
        st, tr, ln = TS._inputs(state, trans, lengths, mesh)
        state_c, offsets = TS._chunks(st, mesh)
        if beam_labels is None:
            prod = lambda: TS._local_chunk_product(state_c, tr, ln, offsets,
                                                   TROPICAL)
        else:
            surv = TS._chunk_survivors(state_c, ln, offsets, beam_labels)
            prod = lambda: TS._pruned_chunk_product(state_c, tr, ln, offsets,
                                                    TROPICAL, surv)
        prod_ms = self.cuda_ms(prod, 1)
        n_alive = int(alive.sum())
        self.multigpu[label] = {
            "sharded_ms": ms, "decode_ms": ref_ms, "chunk_product_ms": prod_ms,
            "chunk_product_share": prod_ms / ms, "rows_alive": n_alive,
            "rows_differing": int(differ.sum()), "score_max_rel": rel}
        log(f"multi-GPU {label} (config 5, B={B}, T={T}, N={N}, "
            f"beam_labels={beam_labels}): {n_alive} of {B} rows alive, their "
            f"scores within rtol {rtol:g} of K8's (max {rel:.3e})"
            + (" on survivor_mask's lattice" if beam_labels else "")
            + f", {int(differ.sum())} paths differ (near ties, rescored "
            f"within rtol 1e-5); sharded_decode {ms:.3f} ms, decode() "
            f"{ref_ms:.3f} ms; the chunk product {prod_ms:.3f} ms "
            f"({100 * prod_ms / ms:.1f}% of the sharded decode)")

    def phase_multigpu(self):
        import tempfile

        import torch.distributed as dist
        from asr_craft_tpu_torch import bench, flagship
        from asr_craft_tpu_torch.kernels import fwdbwd as KF
        from asr_craft_tpu_torch.models.crf import (apply_boundaries,
                                                    potentials)
        from asr_craft_tpu_torch.parallel import (initialize_distributed,
                                                  make_mesh)
        from asr_craft_tpu_torch.parallel import timeshard as TS
        torch, dev = self.torch, self.dev
        self.multigpu = {}
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            initialize_distributed(f"file://{tmp}/store", 1, 0, "cuda")
            try:
                mesh = make_mesh(1)
                if dist.get_backend() != "nccl" or \
                        mesh.device.type != "cuda":
                    raise AssertionError(f"multi-GPU: backend "
                                         f"{dist.get_backend()}, device "
                                         f"{mesh.device}")
                self.dp_path(mesh, "config2", self.cfg, 0.5)
                self.dp_path(mesh, "config5", flagship.swbd(), 0.03)
                t1 = time.perf_counter()
                loss = flagship.dryrun_multichip(1)
                log(f"multi-GPU dryrun_multichip(1): loss {loss:.6f}, "
                    f"{time.perf_counter() - t1:.3f} s with its spawned rank")
                buf = io.StringIO()
                t1 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = bench.main(["--scaling", "--check"])
                rows = json.loads(buf.getvalue().splitlines()[-1])["scaling"]
                if rc != 0 or not rows.get("check_ok") or "1" not in rows:
                    raise AssertionError(f"bench --scaling --check: rc {rc}, "
                                         f"{rows}")
                self.multigpu["scaling"] = rows
                log(f"multi-GPU bench --scaling --check: "
                    f"{json.dumps(rows)} ({time.perf_counter() - t1:.3f} s)")
            finally:
                dist.destroy_process_group()
        cfg = flagship.swbd()
        params = cfg.init_params(torch.Generator().manual_seed(0), 0.1, dev)
        self.sharded_path("sharded decode", cfg, params, 64, 512, 8, None)
        self.sharded_path("sharded decode long", cfg, params, 4, 16384, 8,
                          None)
        pparams, pfeats = self.posterior_inputs(cfg, 4, 16384)
        self.sharded_path("sharded decode long pruned", cfg, pparams, 4,
                          16384, 8, 12, pfeats)
        feats = flagship.tiny_batch(cfg, 64, 512, 1, dev)["feats"]
        lengths = torch.from_numpy(flagship.ragged_lengths(64, 512, 1)).to(
            dev)
        lengths[-1] = 512 // 3          # an empty row's logZ: as above
        state, trans = potentials(cfg, params, feats)
        state = apply_boundaries(cfg, state, lengths).contiguous()
        z = TS.sharded_log_partition(state, trans, lengths,
                                     TS.time_mesh(8, "cuda"))
        _, rz = KF.forward_cuda(state, trans.contiguous(), lengths)
        err = self.close("multi-GPU sharded_log_partition", z, rz, 1e-5, 0.0)
        log(f"multi-GPU sharded_log_partition (config 5, B=64, T=512, N=8): "
            f"within rtol 1e-5 of K6a's logZ, max abs diff {err:.3e}")
        secs = time.perf_counter() - t0
        self.multigpu["seconds"] = secs
        log(f"multi-GPU: phase (t) took {secs:.3f} s; "
            + json.dumps(self.multigpu, default=str))

    def kernels_line(self):
        out = []

        def add(name, source, replaces, launches, key=None):
            """``key``: the times / bounds entry (the kernel's name, or
            'config name' for a kernel timed per config)."""
            key = key or name
            ms, plain_ms = self.times[key]
            bound_ms, bound_by = self.bounds[key]
            out.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": self.err[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "library_ms": self.library_ms.get(key)})

        add("fdt_viterbi_plane", MMA_CU, VIT_PLANE_SRC,
            self.counts["fdt_viterbi_plane"])
        for name, replaces in (("fdt_viterbi_fwd", FWD_SRC),
                               ("fdt_viterbi_traceback", TB_SRC)):
            add(name, CU_SRC, replaces, self.counts[name])
        for name, (source, replaces) in TRAIN_SRC.items():
            add(name, source, replaces, self.train_counts[name])
        # times at config 1 (K7), config 5 (K8) and config 1 (traceback)
        for name, key, src in (("viterbi_dense_fwd", "config1", SHARED_CU),
                               ("viterbi_nstate_fwd", "config5", SHARED_CU),
                               ("viterbi_traceback", "config1", CU_SRC)):
            add(name, src, SHARED_SRC[name], self.shared_counts[name],
                f"{key} {name}")
        # times at config 5, the widest lattice
        for name, replaces in FB_SRC.items():
            add(name, FB_MMA_CU if name == "backward_dual_contract" else FB_CU,
                replaces, self.fb_counts[name], f"config5 {name}")
        for name, replaces in SEG_SRC.items():
            add(name, SEG_CU, replaces, self.seg_counts[name])
        add("calibrate", CAL_CU, CAL_SRC, self.bench_counts["calibrate"])
        return {"kernels": out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 1
    # IEEE fp32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from asr_craft_tpu_torch.kernels import _build, fdt_viterbi

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    fdt_viterbi._library()
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_info.get('seconds', 0.0):.2f} s)")
    for ln in _build.build_info.get("log", "").splitlines():
        if "registers" in ln or "spill" in ln or "error" in ln:
            log(f"  ptxas: {ln.strip()}")

    smoke = Smoke(torch)
    failed = []
    only = sys.argv[2] if sys.argv[1:2] == ["--only"] else None
    for name, phase in (("parity", smoke.phase_parity),
                        ("decode", smoke.phase_decode),
                        ("timing", smoke.phase_timing),
                        ("train parity", smoke.phase_train_parity),
                        ("train", smoke.phase_train_cli),
                        ("train timing", smoke.phase_train_timing),
                        ("shared parity", smoke.phase_shared_parity),
                        ("shared decode", smoke.phase_shared_decode),
                        ("shared timing", smoke.phase_shared_timing),
                        ("fb parity", smoke.phase_fb_parity),
                        ("shared train", smoke.phase_shared_train_cli),
                        ("fb timing", smoke.phase_fb_timing),
                        ("segmental parity", smoke.phase_seg_parity),
                        ("segmental recipe", smoke.phase_seg_recipe),
                        ("segmental timing", smoke.phase_seg_timing),
                        ("compiled step", smoke.phase_compiled),
                        ("bench calibration parity",
                         smoke.phase_bench_calibrate),
                        ("bench end to end", smoke.phase_bench),
                        ("bench diagnostics",
                         smoke.phase_bench_diagnostics),
                        ("precision", smoke.phase_precision),
                        ("multi-GPU", smoke.phase_multigpu)):
        if only is not None and only not in name:
            continue
        try:
            phase()
        except Exception:       # report every phase, then fail as a whole
            traceback.print_exc()
            failed.append(name)
    if any(m.split(".")[0] in ("jax", "asr_craft_tpu") for m in sys.modules):
        log("chip_smoke: jax or the JAX package was imported")
        failed.append("no-jax")
    if failed:
        print(f"chip_smoke: FAILED {failed}", file=sys.stderr)
        return 1
    if only is not None:
        log(f"chip_smoke: the phases named '{only}' passed; a partial run "
            "prints no result")
        return 2
    log(json.dumps(smoke.kernels_line()))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
