#!/usr/bin/env python3
"""Drive the port's config-2 decode and training once on one NVIDIA GPU.

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
    version at B=128, T=512, all rows full.

Prints the card (``nvidia-smi``), the build time, one line per check, a
``{"kernels": [...]}`` JSON line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero, without the last line, if there is no CUDA device, if the
package is missing, or if any phase fails.  Writes its weight file and MLFs
under ``asr_craft_tpu_torch/_build/chip_smoke/`` (git-ignored).
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
        self.times = {}

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
                lambda: self._plain_decode(decode, params, feats, lengths),
                10, 3),
        }
        audio_s = B * T * FRAME_S
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

    def _plain_decode(self, decode, params, feats, lengths):
        from asr_craft_tpu_torch import kernels
        kernels.set_backend("torch")
        try:
            return decode(self.cfg, params, feats, lengths)
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
        for name, (kern, plain) in fns.items():
            # plain, kernel, kernel, plain: compare within one call only
            p1 = self.cuda_ms(plain, 1)
            k1 = self.cuda_ms(kern, 5)
            k2 = self.cuda_ms(kern, 5)
            p2 = self.cuda_ms(plain, 1)
            ms, plain_ms = min(k1, k2), min(p1, p2)
            self.times[name] = (ms, plain_ms)
            log(f"timing {name} B={B} T={T}: kernel {ms:.4f} ms "
                f"({k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms "
                f"({p1:.4f}, {p2:.4f}); {audio_s / ms * 1e3:.1f} vs "
                f"{audio_s / plain_ms * 1e3:.1f} audio-s/s")

    def kernels_line(self):
        out = []
        for name, replaces in (("fdt_viterbi_fwd", FWD_SRC),
                               ("fdt_viterbi_traceback", TB_SRC)):
            ms, plain_ms = self.times[name]
            out.append({"name": name, "route": "cuda", "source": CU_SRC,
                        "replaces": replaces,
                        "launches": self.counts[name],
                        "max_abs_err": self.err[name],
                        "ms": ms, "plain_ms": plain_ms})
        for name, replaces in TRAIN_SRC.items():
            ms, plain_ms = self.times[name]
            out.append({"name": name, "route": "cuda", "source": TRAIN_CU,
                        "replaces": replaces,
                        "launches": self.train_counts[name],
                        "max_abs_err": self.err[name],
                        "ms": ms, "plain_ms": plain_ms})
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
    for name, phase in (("parity", smoke.phase_parity),
                        ("decode", smoke.phase_decode),
                        ("timing", smoke.phase_timing),
                        ("train parity", smoke.phase_train_parity),
                        ("train", smoke.phase_train_cli),
                        ("train timing", smoke.phase_train_timing)):
        try:
            phase()
        except Exception:       # report every phase, then fail as a whole
            traceback.print_exc()
            failed.append(name)
    if "jax" in sys.modules:
        log("chip_smoke: jax was imported")
        failed.append("no-jax")
    if failed:
        print(f"chip_smoke: FAILED {failed}", file=sys.stderr)
        return 1
    log(json.dumps(smoke.kernels_line()))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
