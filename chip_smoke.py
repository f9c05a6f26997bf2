#!/usr/bin/env python3
"""Drive the port's decode and training (configs 1-5) once on one NVIDIA
GPU.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

It builds the CUDA kernels from ``asr_craft_tpu_torch/csrc`` and then runs,
in phases:

(a) parity — the K3 kernels (``fdt_viterbi_fwd`` + ``fdt_viterbi_traceback``)
    against their plain PyTorch version on the card: the config-2 flagship
    (B=64, T=512, P=48, ns=3, ragged lengths with an empty row) exact, with
    ``beam_threshold=8`` and with ``beam_width=16``, and P=128 at small B, T;
(b) end to end — ``asr_craft_tpu_torch.cli.decode.main`` on a synthetic
    corpus at flagship widths with a hand-set posterior model, through the
    kernels (launch counts must rise) and again with ``--kernel_backend
    torch`` (same PER, same MLF);
(c) timing — kernels and plain version at B=64, T=512 (CUDA events);
(d) training parity — the K1 kernel (``fdt_train_fwd``) and K2's two
    kernels (``fdt_train_bwd``, the beta/xi/gamma recursion, and
    ``fdt_train_contract``, the dWall / dfeats contraction) against their
    plain PyTorch versions: the flagship (B=128, T=512, ragged lengths with
    an empty row and a dead clamped lattice) with phone labels (clamp_ns =
    ns, and once with ``grad_feats``) and state labels (clamp_ns = 1), P=128
    at small B, T, and the parameter gradients of ``crf_loss`` end to end;
(e) training end to end — ``asr_craft_tpu_torch.cli.train.main`` with the
    flags of the JAX reference run (256 synthetic utterances, 3 epochs),
    held to the JAX CPU losses and PER; K1, K2 and K3 launch counts must
    rise; again with ``--kernel_backend torch`` (same losses); the final
    weights decode to the same PER and MLF under both backends;
(f) training timing — K1, K2 (recursion, contraction, both) and a full
    train step (loss, backward, SGD update), kernels against the plain
    version at B=128, T=512, all rows full;
(g) shared-transition parity — the K7 kernel (``viterbi_dense_fwd``, configs
    1 and 3), the K8 kernel (``viterbi_nstate_fwd``, config 5) and the
    traceback kernel (``viterbi_traceback``) against their plain version
    (``ops/viterbi``) on the potentials of random models at B=64, T=512
    (ragged lengths, an empty row), exact, ``beam_threshold=8`` and
    ``beam_width=16``, and K7 at P=130, ns=3 (L'=390) at small B, T;
(h) shared-transition end to end — ``cli.decode.main`` for configs 1, 3
    (``--normalize utt --beam_threshold 8``) and 5 on a synthetic corpus
    with the hand-set posterior model, through the kernels and with
    ``--kernel_backend torch`` (same PER, same MLF, the JAX CPU counts),
    and the ``--lexicon`` word decode of the word fixture (the JAX CLI's
    words and WER);
(i) shared-transition timing — K7, K8, the traceback and ``decode()``
    against the plain version at B=64, T=512 for configs 1, 3 and 5;
(j) shared-transition training parity — the K6a / K6b kernels (``forward``,
    ``backward``), K4 / K14 (``forward_dual``, ``backward_dual``) and K5
    (``backward_dual_grad``) against their plain versions on the potentials
    of random models of configs 1, 3 and 5 at B=128, T=512 (ragged lengths,
    an empty row, a row whose labels no state admits: zero gradient), with
    phone labels and, for config 5, state labels; UV and g_state bit-equal
    on two runs; the parameter gradients of the shared ``crf_loss``;
(k) shared-transition training end to end — ``cli.train.main`` for configs
    1, 3 and 5 with their recipes' model flags (256 synthetic utterances, 3
    epochs), held to the JAX CPU losses and PER: K4, K5, K7, K8 and the
    traceback must launch; then, each with its own launch counts, the
    trained models' ``frame_posteriors`` (K6a, K6b must launch) and
    ``kernels.fwdbwd.backward_dual`` (K14: no higher entry point calls it,
    here or in the JAX package); the train CLI again with
    ``--kernel_backend torch`` (same losses); the trained weights decode to
    the same PER and MLF under both backends;
(l) shared-transition training timing — the five kernels and a full train
    step (loss, backward, SGD update) against the plain version at B=128,
    T=512, all rows full, for configs 1, 3 and 5, and cuBLAS on the
    ``U^T V`` contraction alone;
(m) segmental parity — the K9-K13 kernels (``segmental_forward``,
    ``segmental_backward``, ``segmental_grad``, ``segmental_viterbi``,
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
    under both backends (the same losses);
(o) segmental timing — the five kernels, one train step
    (``scrf_loss_fused``, backward, SGD) and one ``scrf_decode`` against the
    plain version at B=128, T=512, L=48, D=144, Dmax=16, all rows full.

Every kernel's time stands beside its bound on this card: the larger of the
bytes it must move (each input read once, each output written once) over
the memory rate and its operations over the fp32 rate, from this run's
shapes.

Prints the card (``nvidia-smi``), the build time, one line per check, a
``{"kernels": [...]}`` JSON line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero, without the last line, if there is no CUDA device, if the
package is missing, or if any phase fails.  ``--only WORD`` (for work on one
family of kernels) runs the phases whose names hold WORD and exits 2 after
them, with their lines but no result line: only the whole run is a result.
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
TB_SRC = "asr_craft_tpu/kernels/fdt_pallas.py:1003"     # _fdt_vit_bwd_kernel
CU_SRC = "asr_craft_tpu_torch/csrc/fdt_viterbi.cu"
TRAIN_CU = "asr_craft_tpu_torch/csrc/fdt_train.cu"
TRAIN_SRC = {                       # the TPU kernel bodies they replace
    "fdt_train_fwd": "asr_craft_tpu/kernels/fdt_pallas.py:263",
    "fdt_train_bwd": "asr_craft_tpu/kernels/fdt_pallas.py:324",
    "fdt_train_contract": "asr_craft_tpu/kernels/fdt_pallas.py:466",
}
# Log-partitions: sums over up to 512 frames of ~2.5e3 magnitude (fp32 ulp
# 2.4e-4 there); the kernel forms planes by sequential FMAs and takes a
# three-way lse where the plain loop chains logaddexp.
Z_TOL = dict(rtol=1e-5, atol=1e-3)
# dplane holds posteriors (|v| <= |w| = 1) gated by exp(s - z), where s - z
# is a difference of two such sums: ~1e-4 relative error at worst.
DPLANE_ATOL = 1e-3
# dWall / dfeats / parameter gradients: sums over B*T = 65,536 frames in
# another order; held to their largest entry (REL_MAX of it) and RTOL.
REL_MAX, RTOL = 1e-4, 1e-3
# The contraction alone, on one dplane: only the summation order differs.
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
FB_SRC = {                          # the TPU kernel bodies they replace
    "forward": "asr_craft_tpu/kernels/fwdbwd_pallas.py:65",
    "backward": "asr_craft_tpu/kernels/fwdbwd_pallas.py:136",
    "forward_dual": "asr_craft_tpu/kernels/dual_pallas.py:39",
    "backward_dual": "asr_craft_tpu/kernels/dual_pallas.py:134",
    "backward_dual_grad": "asr_craft_tpu/kernels/dual_pallas.py:172",
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
    "segmental_grad": "asr_craft_tpu/kernels/segmental_pallas.py:382",
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
# Published peaks of one H100 SXM: device memory bytes/s and fp32 FLOP/s
# outside the tensor cores (every kernel here is fp32 on the CUDA cores).
HBM_BYTES_S, FP32_FLOP_S = 3.35e12, 67e12


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the least time the card could take for this
    many bytes and fp32 operations."""
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    B, T = 64, 512                        # the flagship decode batch

    def __init__(self, torch):
        from asr_craft_tpu_torch.flagship import flagship
        from asr_craft_tpu_torch.kernels import fdt_viterbi as K
        from asr_craft_tpu_torch.kernels import wall
        from asr_craft_tpu_torch.ops import fdt
        self.torch, self.K, self.fdt, self.wall = torch, K, fdt, wall
        self.dev = torch.device("cuda")
        self.cfg = flagship()
        self.err = {"fdt_viterbi_fwd": 0.0, "fdt_viterbi_traceback": 0,
                    "fdt_train_fwd": 0.0, "fdt_train_bwd": 0.0,
                    "fdt_train_contract": 0.0}
        self.counts = {}
        self.train_counts = {}
        self.shared_counts = {}
        self.fb_counts = {}
        self.seg_counts = {}
        self.times = {}
        self.bounds = {}
        self.library_ms = {}
        self.err.update({k: 0.0 for k in SHARED_SRC})
        self.err.update({k: 0.0 for k in FB_SRC})
        self.err.update({k: 0.0 for k in SEG_SRC})

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
        torch, K, fdt = self.torch, self.K, self.fdt
        ns = kw["ns"]
        planes = self.wall.wall_planes(Wall, feats, kw["u0"], kw["u1"], ns,
                                       kw["P"])
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
                and paths.max() < ns * kw["P"]):
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
        self.err["fdt_viterbi_fwd"] = max(self.err["fdt_viterbi_fwd"], err)
        self.err["fdt_viterbi_traceback"] = max(
            self.err["fdt_viterbi_traceback"], tb_err)
        log(f"parity {label}: max |score - plain| {err:.3e}, "
            f"paths differing {n_diff}/{len(paths)} (near-ties), "
            f"traceback exact")

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
        K.reset_launches()
        rec, secs = self.run_cli(argv + ["--kernel_backend", "auto",
                                         "--out_mlf", str(OUT / "auto.mlf")])
        self.counts = dict(K.launches)
        K.reset_launches()
        rec_t, secs_t = self.run_cli(argv + ["--kernel_backend", "torch",
                                             "--out_mlf",
                                             str(OUT / "torch.mlf")])
        plain_counts = dict(K.launches)
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

    def device_share(self, label, fn, reps=5):
        """Trace ``reps`` calls of ``fn`` with torch.profiler and log the
        wall time per call, the time the device was busy in it and the
        kernels that took most of that.  A measurement aid: where the
        profiler gives no device times it says so and nothing fails."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / reps * 1e3
            rows = [(e.key, e.device_time_total / reps / 1e3, e.count // reps)
                    for e in prof.key_averages()
                    if e.device_time_total > 0
                    and e.device_type == torch.autograd.DeviceType.CUDA]
        except Exception as exc:        # the tracer, not the program
            log(f"device share {label}: not measured ({exc!r})")
            return
        if not rows:
            log(f"device share {label}: not measured (the trace holds no "
                "device time)")
            return
        busy = sum(ms for _, ms, _ in rows)
        top = sorted(rows, key=lambda r: -r[1])[:6]
        log(f"device share {label}: {wall:.4f} ms wall per call (traced), "
            f"device busy {busy:.4f} ms in {sum(n for _, _, n in rows)} "
            f"kernels ({100 * busy / wall:.1f}%); most of it: "
            + "; ".join(f"{k[:48]} {ms:.4f} ms x{n}" for k, ms, n in top))

    def phase_timing(self):
        from asr_craft_tpu_torch.models.crf import decode
        torch, K, fdt, cfg = self.torch, self.K, self.fdt, self.cfg
        B, T = self.B, self.T
        Wall, feats, _, kw = self.problem(cfg, B, T, seed=0)
        lengths = torch.full((B,), T, dtype=torch.int32, device=self.dev)
        params = cfg.init_params(torch.Generator().manual_seed(0), 0.01,
                                 self.dev)
        ns, bw, thr = kw["ns"], None, None

        def plain_fwd():
            return fdt.fdt_viterbi_forward(
                *self.wall.wall_planes(Wall, feats, kw["u0"], kw["u1"], ns,
                               kw["P"]), lengths, ns, True, bw, thr)

        bp, last, _ = plain_fwd()
        fns = {
            "fdt_viterbi_fwd": (
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
        frames, Lp = int(lengths.sum()), ns * kw["P"]
        plane_flops = 2 * Wall.shape[0] * Wall.shape[1]   # Wall @ [x; 1]
        self.bounds["fdt_viterbi_fwd"] = bound(
            4 * (Wall.numel() + feats.numel() + bp.numel() + 3 * B),
            frames * (plane_flops + 2 * (2 * Lp + kw["P"] ** 2)))
        self.bounds["fdt_viterbi_traceback"] = self.traceback_bound(B, T)
        for name, (kern, plain, nk, npl) in fns.items():
            # plain, kernel, kernel, plain: compare within one call only
            p1 = self.cuda_ms(plain, npl)
            k1 = self.cuda_ms(kern, nk)
            k2 = self.cuda_ms(kern, nk)
            p2 = self.cuda_ms(plain, npl)
            ms, plain_ms = min(k1, k2), min(p1, p2)
            self.times[name] = (ms, plain_ms)
            log(f"timing {name} B={B} T={T}: kernel {ms:.4f} ms "
                f"({k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms "
                f"({p1:.4f}, {p2:.4f}); {audio_s / ms * 1e3:.1f} vs "
                f"{audio_s / plain_ms * 1e3:.1f} audio-s/s")

    @staticmethod
    def traceback_bound(B, T):
        """The traceback follows one backpointer per frame: B * T entries
        read (what this walk needs, not the whole (B, T, L') array) and
        B * T labels written."""
        return bound(4 * (2 * B * T + 2 * B), B * T)

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
        alphas, zf, zc = K.fdt_forward_cuda(*args, **kw)
        ra, rzf, rzc = K.fdt_forward_wall_torch(*args, **kw)
        z_err = max(self.close(f"{label} zf", zf, rzf, **Z_TOL),
                    self.close(f"{label} zc", zc, rzc, **Z_TOL))
        if not (float(zc[1]) < -1e29 < float(zf[1])):
            raise AssertionError(f"{label}: row 1's clamped lattice is not "
                                 f"dead (zf {float(zf[1])}, zc "
                                 f"{float(zc[1])})")
        wf, wc = torch.ones_like(zf), -torch.ones_like(zf)   # d(zf - zc)
        grad_args = args + (ra, rzf, rzc, wf, wc)
        dplane = K.fdt_dplane_cuda(*grad_args, **kw)
        rdplane = K.fdt_dplane_wall_torch(*grad_args, **kw)
        dp_err = self.close(f"{label} dplane", dplane, rdplane, 0.0,
                            DPLANE_ATOL)
        dW = torch.empty((Wall.shape[0], u1 - u0 + 1), device=self.dev)
        K.contract_cuda(dplane, feats, dW, mode=0, D=feats.shape[2], u0=u0,
                        Du=u1 - u0)
        ref = K.contract_wall_torch(dplane, feats, mode=0, u0=u0, u1=u1)
        c_err = self.close(f"{label} contraction", dW, ref, 0.0,
                           CONTRACT_REL_MAX * float(ref.abs().max()))
        out = K.fdt_backward_grad_cuda(*args, alphas, zf, zc, wf, wc, **kw,
                                       want_dfeats=grad_feats)
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
        for name, e in (("fdt_train_fwd", z_err), ("fdt_train_bwd", dp_err),
                        ("fdt_train_contract", c_err)):
            self.err[name] = max(self.err[name], e)
        log(f"train parity {label}: max |z - plain| {z_err:.3e}, |dplane - "
            f"plain| {dp_err:.3e}, |contraction - matmul| {c_err:.3e}; "
            f"dWall{' and dfeats' if grad_feats else ''} within tolerance; "
            "dead lattice gradient 0")

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
    def run_train_cli(self, backend):
        from asr_craft_tpu_torch.cli.train import main
        out = OUT / f"train_{backend}"
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

    def phase_train_cli(self):
        from asr_craft_tpu_torch import kernels
        from asr_craft_tpu_torch.kernels import fdt_train, fdt_viterbi
        for K in (fdt_train, fdt_viterbi):
            K.reset_launches()
        losses, evals, wfile, secs = self.run_train_cli("auto")
        self.train_counts = {**fdt_train.launches, **fdt_viterbi.launches}
        for K in (fdt_train, fdt_viterbi):
            K.reset_launches()
        plosses, pevals, _, psecs = self.run_train_cli("torch")
        plain_counts = {**fdt_train.launches, **fdt_viterbi.launches}
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

    # -- (f) training timing -------------------------------------------------
    def phase_train_timing(self):
        from asr_craft_tpu_torch import kernels
        from asr_craft_tpu_torch.flagship import tiny_batch
        from asr_craft_tpu_torch.kernels import fdt_train as K
        from asr_craft_tpu_torch.train import TrainConfig, Trainer
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
        alphas, zf, zc = K.fdt_forward_cuda(*args, **kw)
        ones = torch.ones_like(zf)
        grad_args = args + (alphas, zf, zc, ones, -ones)
        dplane = K.fdt_dplane_cuda(*grad_args, **kw)
        dW = torch.empty((Wall.shape[0], u1 - u0 + 1), device=self.dev)
        trainer = Trainer(cfg, TrainConfig(lr=0.5), params=params)

        def step(backend):
            kernels.set_backend(backend)
            try:
                trainer.train_step(batch, 0.5)
            finally:
                kernels.set_backend("auto")

        fns = {
            "fdt_train_fwd": (lambda: K.fdt_forward_cuda(*args, **kw),
                              lambda: K.fdt_forward_wall_torch(*args, **kw)),
            "fdt_train_bwd": (lambda: K.fdt_dplane_cuda(*grad_args, **kw),
                              lambda: K.fdt_dplane_wall_torch(*grad_args,
                                                              **kw)),
            "fdt_train_contract": (
                lambda: K.contract_cuda(dplane, feats, dW, mode=0, D=144,
                                        u0=u0, Du=u1 - u0),
                lambda: K.contract_wall_torch(dplane, feats, mode=0, u0=u0,
                                              u1=u1)),
            "K2 (recursion + contraction)": (
                lambda: K.fdt_backward_grad_cuda(*grad_args, **kw),
                lambda: K.fdt_backward_grad_wall_torch(*grad_args, **kw)),
            "train step (loss, backward, SGD)": (lambda: step("auto"),
                                                 lambda: step("torch")),
        }
        audio_s = B * T * FRAME_S
        frames, Lp = B * T, cfg.num_states * dims["P"]
        plane_flops = 2 * Wall.shape[0] * Wall.shape[1]   # Wall @ [x; 1]
        dp_flops = 2 * (2 * Lp + dims["P"] ** 2)          # one lattice's DP
        io = 4 * (Wall.numel() + feats.numel() + labels.numel()
                  + alphas.numel() + 4 * B)
        self.bounds["fdt_train_fwd"] = bound(
            io, frames * (plane_flops + 2 * dp_flops))
        self.bounds["fdt_train_bwd"] = bound(
            io + 4 * dplane.numel(), frames * (plane_flops + 6 * dp_flops))
        self.bounds["fdt_train_contract"] = bound(
            4 * (dplane.numel() + feats.numel() + dW.numel()),
            frames * plane_flops)
        for name, (kern, plain) in fns.items():
            # plain, kernel, kernel, plain: compare within one call only
            p1 = self.cuda_ms(plain, 1)
            k1 = self.cuda_ms(kern, 5)
            k2 = self.cuda_ms(kern, 5)
            p2 = self.cuda_ms(plain, 1)
            ms, plain_ms = min(k1, k2), min(p1, p2)
            self.times[name] = (ms, plain_ms)
            if name == "fdt_train_contract":
                # its plain version is one cuBLAS product, dplane^T @ [x; 1]
                self.library_ms[name] = plain_ms
            log(f"timing {name} B={B} T={T}: kernel {ms:.4f} ms "
                f"({k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms "
                f"({p1:.4f}, {p2:.4f}); {audio_s / ms * 1e3:.1f} vs "
                f"{audio_s / plain_ms * 1e3:.1f} audio-s/s")

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
        bp_same = bool(torch.equal(bp, rbp))
        self.err[name] = max(self.err[name], err)
        self.err["viterbi_traceback"] = max(self.err["viterbi_traceback"],
                                            tb_err)
        log(f"shared parity {label}: {name} max |score - plain| {err:.3e}, "
            f"paths differing {n_diff}/{len(paths)} (near-ties), "
            f"backpointers {'equal' if bp_same else 'differ'}; traceback "
            "exact")

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
        from asr_craft_tpu_torch.kernels import viterbi as KV
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
        KV.reset_launches()
        recs = {key: self.run_cli(argv + ["--kernel_backend", "auto",
                                          "--out_mlf",
                                          str(OUT / f"{key}_auto.mlf")])
                for key, argv in runs.items()}
        self.shared_counts = dict(KV.launches)
        KV.reset_launches()
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
        plain_counts = dict(KV.launches)
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
            fwd = {"viterbi_nstate_fwd": lambda: KV.viterbi_nstate_fwd(
                       state, trans, lengths, ns),
                   "viterbi_dense_fwd": lambda: KV.viterbi_dense_fwd(
                       state, trans, lengths)}
            bp, last, _ = V.viterbi_forward(state, trans, lengths)
            fns = {name: (fwd[name],
                          lambda: V.viterbi_forward(state, trans, lengths)),
                   "viterbi_traceback": (
                       lambda: KV.viterbi_traceback(bp, last, lengths),
                       lambda: fdt.fdt_viterbi_traceback(bp, last, lengths)),
                   "decode": (
                       lambda: decode(cfg, params, feats, lengths),
                       lambda: self._plain_decode(cfg, params, feats,
                                                  lengths))}
            if ns > 1:     # K7 on the same n-state problem, for comparison
                fns["viterbi_dense_fwd"] = (
                    fwd["viterbi_dense_fwd"],
                    lambda: V.viterbi_forward(state, trans, lengths))
            L, frames = state.shape[-1], int(lengths.sum())
            io = 4 * (state.numel() + trans.numel() + bp.numel() + 3 * B)
            self.bounds[f"{key} viterbi_dense_fwd"] = bound(
                io, frames * 2 * L * L)
            self.bounds[f"{key} viterbi_nstate_fwd"] = bound(
                io, frames * 2 * (2 * L + cfg.num_labels ** 2))
            self.bounds[f"{key} viterbi_traceback"] = self.traceback_bound(
                B, T)
            for fn_name, (kern, plain) in fns.items():
                p1 = self.cuda_ms(plain, 2)
                k1 = self.cuda_ms(kern, 10)
                k2 = self.cuda_ms(kern, 10)
                p2 = self.cuda_ms(plain, 2)
                ms, plain_ms = min(k1, k2), min(p1, p2)
                self.times[f"{key} {fn_name}"] = (ms, plain_ms)
                log(f"timing {key} {fn_name} B={B} T={T}: kernel "
                    f"{ms:.4f} ms ({k1:.4f}, {k2:.4f}), plain "
                    f"{plain_ms:.4f} ms ({p1:.4f}, {p2:.4f}); "
                    f"{audio_s / ms * 1e3:.1f} vs "
                    f"{audio_s / plain_ms * 1e3:.1f} audio-s/s")

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
        g, UV = K.backward_dual_grad_cuda(*dual, *grad_in, cns)
        g2, UV2 = K.backward_dual_grad_cuda(*dual, *grad_in, cns)
        close("backward_dual_grad", "g_state", g, rg, rtol=0.0,
              atol=FB_G_ATOL)
        uv_err = self.close(f"{label} UV", UV, rUV, RTOL,
                            REL_MAX * float(rUV.abs().max()))
        if not (torch.equal(UV, UV2) and torch.equal(g, g2)):
            raise AssertionError(f"{label}: K5 differs between two runs")
        # the dead lattice alone: zero gradient, exactly
        one = lambda x: x[1:2].contiguous()
        dg, dUV = K.backward_dual_grad_cuda(
            one(state), trans, one(labels), one(lengths), one(af), one(ac),
            one(zf), one(zc), torch.zeros_like(one(zf)),
            torch.ones_like(one(zf)), cns)
        torch.cuda.synchronize()
        if float(dg.abs().max()) != 0.0 or float(dUV.abs().max()) != 0.0:
            raise AssertionError(f"{label}: dead lattice gradient "
                                 f"{float(dg.abs().max())}, "
                                 f"{float(dUV.abs().max())}")
        for name, e in errs.items():
            self.err[name] = max(self.err[name], e)
        log(f"fb parity {label}: max |kernel - plain| {errs}, |UV - plain| "
            f"{uv_err:.3e} (largest |UV| {float(rUV.abs().max()):.3e}); K5 "
            "bit-equal on two runs; dead lattice gradient 0")

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
    def run_shared_train_cli(self, key, backend):
        from asr_craft_tpu_torch.cli.train import main
        model, optim = SHARED_TRAIN[key][:2]
        flags = model + optim + SHARED_TRAIN_CORPUS
        out = OUT / f"train_{key}_{backend}"
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
        from asr_craft_tpu_torch.kernels import fwdbwd, viterbi
        from asr_craft_tpu_torch.models.crf import (apply_boundaries,
                                                    frame_posteriors,
                                                    potentials)
        torch = self.torch
        configs = self.shared_configs()
        mods = (fwdbwd, viterbi)

        def reset():
            for K in mods:
                K.reset_launches()

        def require(path, counts, names):
            log(f"{path} launches {counts}")
            missing = [n for n in names if counts[n] < 1]
            if missing:
                raise AssertionError(f"{path} never launched {missing}")

        # Three paths, each with every count 0 before it and read after it.
        # The train CLI: K4, K5 and the CV decode's K7 / K8 + traceback.
        reset()
        runs = {key: self.run_shared_train_cli(key, "auto")
                for key in configs}
        train_counts = {**fwdbwd.launches, **viterbi.launches}
        require("shared train CLI", train_counts,
                ("forward_dual", "backward_dual_grad", "viterbi_dense_fwd",
                 "viterbi_nstate_fwd", "viterbi_traceback"))
        # frame_posteriors of the trained models: K6a, K6b.
        problems = {key: self.trained_problem(cfg, runs[key][2])
                    for key, cfg in configs.items()}
        reset()
        with torch.no_grad():
            posts = {key: frame_posteriors(cfg, *problems[key][:2],
                                           problems[key][3])
                     for key, cfg in configs.items()}
        post_counts = dict(fwdbwd.launches)
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
        reset()
        betas = {key: fwdbwd.backward_dual(*duals[key]) for key in configs}
        dual_counts = dict(fwdbwd.launches)
        require("kernels.fwdbwd.backward_dual", dual_counts,
                ("backward_dual",))
        self.fb_counts = {
            "forward": post_counts["forward"],
            "backward": post_counts["backward"],
            "forward_dual": train_counts["forward_dual"],
            "backward_dual": dual_counts["backward_dual"],
            "backward_dual_grad": train_counts["backward_dual_grad"]}
        for key, cfg in configs.items():
            self.check_trained_posteriors(key, cfg, problems[key],
                                          posts[key], betas[key])
        reset()
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
        plain_counts = {**fwdbwd.launches, **viterbi.launches}
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

    # -- (l) shared-transition training timing ----------------------------------
    def phase_fb_timing(self):
        from asr_craft_tpu_torch import kernels
        from asr_craft_tpu_torch.kernels import fwdbwd as K
        from asr_craft_tpu_torch.train import TrainConfig, Trainer
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
                kernels.set_backend(backend)
                try:
                    trainer.train_step(batch, 0.03)
                finally:
                    kernels.set_backend("auto")

            # the xi contraction alone, as one cuBLAS product over both
            # lattices' frames: what K5's U^T V would cost a library
            U = torch.rand((2 * B * (T - 1), L), device=self.dev)
            V = torch.rand((2 * B * (T - 1), L), device=self.dev)
            cublas = min(self.cuda_ms(lambda: U.T @ V, 20) for _ in range(2))
            frames, n, mat = B * T, state.numel(), L * L
            small = 4 * (mat + L + 2 * B)
            bounds = {
                "forward": bound(4 * 2 * n + small, frames * 2 * mat),
                "backward": bound(4 * 2 * n + small, frames * 2 * mat),
                "forward_dual": bound(4 * (3 * n + labels.numel()) + small,
                                      frames * 4 * mat),
                "backward_dual": bound(4 * (3 * n + labels.numel()) + small,
                                       frames * 4 * mat),
                "backward_dual_grad": bound(
                    4 * (4 * n + labels.numel() + mat) + small,
                    frames * 8 * mat),
            }
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
                    lambda: K.backward_dual_grad_cuda(*dual, *grad_in, cns),
                    lambda: K.backward_dual_grad_plain(*dual, *grad_in,
                                                       cns)),
                "train step (loss, backward, SGD)": (lambda: step("auto"),
                                                     lambda: step("torch")),
            }
            log(f"timing {key} cuBLAS U^T V alone ({2 * B * (T - 1)} x {L})^T "
                f"({2 * B * (T - 1)} x {L}): {cublas:.4f} ms")
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
            self.library_ms[f"{key} backward_dual_grad"] = cublas

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
        from asr_craft_tpu_torch.kernels import segmental as K
        # the main path: every count 0 before it, read after it
        K.reset_launches()
        losses, ev, wfile = self.run_scrf("train", "auto",
                                          ["--epochs", "300"])
        self.seg_counts = dict(K.launches)
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
        K.reset_launches()
        _, dec, _ = self.run_scrf("decode_auto", "auto",
                                  ["--decode_only", str(wfile)])
        dec_counts = dict(K.launches)
        K.reset_launches()
        _, dec_t, _ = self.run_scrf("decode_torch", "torch",
                                    ["--decode_only", str(wfile)])
        l30, _, _ = self.run_scrf("train30_torch", "torch",
                                  ["--epochs", "30"])
        plain_counts = dict(K.launches)
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

        L, Dmax = cfg.num_labels, cfg.max_dur
        frames, n = int(lengths.sum()), frame.numel()
        small = 4 * (L * L + Dmax * L + Dmax + 2 * B)
        # per frame: one (L) x (L, L) product (2 L^2) and Dmax * L window
        # terms (sub, mul, two adds, the max and the exp-sum: 6 each; K12
        # compares where K9 sums; K11 also scatters A, S, gd and F: 12 each,
        # and adds the outer product of the retiring frame, 2 L^2)
        bounds = {
            "segmental_forward": bound(4 * 2 * n + small, frames * (
                2 * L * L + 6 * Dmax * L)),
            "segmental_backward": bound(4 * 2 * n + small, frames * (
                2 * L * L + 6 * Dmax * L)),
            "segmental_grad": bound(4 * 5 * n + small + 4 * (L * L + Dmax * L),
                                    frames * (4 * L * L + 12 * Dmax * L)),
            "segmental_viterbi": bound(4 * 3 * n + small, frames * (
                2 * L * L + 5 * Dmax * L)),
            # the walk reads, per segment of this run, one duration, one
            # delta row and one transition column, and writes two (B, T)
            # marker arrays
            "segmental_viterbi_traceback": bound(
                4 * (segments * (1 + L) + L * L + 2 * B + 2 * B * T),
                segments * 2 * L),
        }
        fns = {
            "segmental_forward": (
                lambda: K.segmental_forward_cuda(*args),
                lambda: K.segmental_forward_plain(*args)),
            "segmental_backward": (
                lambda: K.segmental_backward_cuda(*args),
                lambda: K.segmental_backward_plain(*args)),
            "segmental_grad": (
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
        t = {k: v[0] for k, v in self.times.items()}
        rest_step = (t["scrf train step (loss, backward, SGD)"]
                     - t["segmental_forward"] - t["segmental_backward"]
                     - t["segmental_grad"])
        rest_dec = (t["scrf_decode"] - t["segmental_viterbi"]
                    - t["segmental_viterbi_traceback"])
        self.device_share("scrf train step", lambda: step("auto"))
        self.device_share("scrf_decode", lambda: decode("auto"))
        log(f"timing segmental: the step minus K9, K10, K11 (frame scores, "
            f"gold numerator, gradient assembly, SGD) {rest_step:.4f} ms; "
            f"scrf_decode minus K12, K13 (frame scores, marker packing) "
            f"{rest_dec:.4f} ms")

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

        for name, replaces in (("fdt_viterbi_fwd", FWD_SRC),
                               ("fdt_viterbi_traceback", TB_SRC)):
            add(name, CU_SRC, replaces, self.counts[name])
        for name, replaces in TRAIN_SRC.items():
            add(name, TRAIN_CU, replaces, self.train_counts[name])
        # times at config 1 (K7), config 5 (K8) and config 1 (traceback)
        for name, key, src in (("viterbi_dense_fwd", "config1", SHARED_CU),
                               ("viterbi_nstate_fwd", "config5", SHARED_CU),
                               ("viterbi_traceback", "config1", CU_SRC)):
            add(name, src, SHARED_SRC[name], self.shared_counts[name],
                f"{key} {name}")
        # times at config 5, the widest lattice
        for name, replaces in FB_SRC.items():
            add(name, FB_CU, replaces, self.fb_counts[name],
                f"config5 {name}")
        for name, replaces in SEG_SRC.items():
            add(name, SEG_CU, replaces, self.seg_counts[name])
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
                        ("segmental timing", smoke.phase_seg_timing)):
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
