#!/usr/bin/env python3
"""Drive the port's config-2 phone decode once on one NVIDIA GPU.

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
(c) timing — kernels and plain version at B=64, T=512 (CUDA events).

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
        from asr_craft_tpu_torch.ops import fdt
        self.torch, self.K, self.fdt = torch, K, fdt
        self.dev = torch.device("cuda")
        self.cfg = flagship()
        self.err = {"fdt_viterbi_fwd": 0.0, "fdt_viterbi_traceback": 0}
        self.counts = {}
        self.times = {}

    # -- (a) parity ---------------------------------------------------------
    def problem(self, cfg, B, T, seed):
        from asr_craft_tpu_torch.flagship import ragged_lengths, tiny_batch
        torch = self.torch
        params = cfg.init_params(torch.Generator().manual_seed(seed), 0.01,
                                 self.dev)
        feats = tiny_batch(cfg, B, T, seed, self.dev)["feats"]
        lengths = torch.from_numpy(ragged_lengths(B, T, seed)).to(self.dev)
        Wall, u0, u1, dims = self.K.build_wall(params, cfg.fmap,
                                               cfg.num_states)
        kw = dict(u0=u0, u1=u1, ns=cfg.num_states, P=dims["P"],
                  boundaries=True)
        return Wall, feats, lengths, kw

    def check(self, label, Wall, feats, lengths, kw, beams):
        torch, K, fdt = self.torch, self.K, self.fdt
        ns = kw["ns"]
        planes = K.wall_planes(Wall, feats, kw["u0"], kw["u1"], ns, kw["P"])
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
                *K.wall_planes(Wall, feats, kw["u0"], kw["u1"], ns,
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
                        ("timing", smoke.phase_timing)):
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
