"""Training loop: batched SGD on the CRF log-likelihood, in PyTorch.

Counterpart of :mod:`asr_craft_tpu.train.trainer`, with the same numbers:
one step computes loss + gradient over a padded utterance batch
(``crf_loss`` -> the K1/K2 or K4/K5 kernels on the card) and applies the
optimizer;
the optimizer is built at lr 1 and its update scaled by the epoch's
schedule value; optional Polyak averaging; ``grad_norm`` is the global L2
norm of the gradient; per-epoch weight files and CV evaluation (frame
accuracy and PER).  Step metrics stay device tensors and are fetched once
at epoch end, so the host never waits on the card inside an epoch.

PyTorch runs eagerly, so ``steps_per_call > 1`` runs its K steps one by
one: the same numbers as the JAX package's fused ``lax.scan`` (a CUDA graph
of K steps is later work).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from asr_craft_tpu_torch.decode.scorer import ErrorRateScorer, score_batch
from asr_craft_tpu_torch.models import crf as crf_mod
from asr_craft_tpu_torch.models import weights as weights_mod
from asr_craft_tpu_torch.models.crf import CrfConfig
from asr_craft_tpu_torch.utils import diagnostics
from asr_craft_tpu_torch.utils.logging import MetricsLogger


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's ``crf_lr`` / ``crf_epochs`` / trainer-selection
    flags; the fields and defaults are the JAX ``TrainConfig``'s."""

    lr: float = 0.05
    lr_decay: float = 1.0          # multiplicative per-epoch decay
    momentum: float = 0.0
    optimizer: str = "sgd"          # "sgd" | "adam" | "adagrad"
    l2: float = 0.0                 # weight decay (reference gaussian prior)
    epochs: int = 5
    weight_avg: bool = False        # Polyak averaging of lambdas
    avg_decay: float = 0.999
    accum_steps: int = 1            # micro-batches summed per update
    steps_per_call: int = 1         # run one by one (see the module doc)
    log_every: int = 50
    frame_shift_s: float = 0.01     # 10ms frames: audio-seconds metric
    out_dir: Optional[str] = None   # per-epoch weight files + metrics.jsonl
    profile_dir: Optional[str] = None   # torch.profiler trace of fit()
    check_sync_every: int = 0       # assert_replicated every N steps
    prefetch: int = 2               # background batch-assembly depth


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad``'s update, which ``torch.optim.Adagrad`` does not
    give: the accumulator starts at ``initial_accumulator_value`` (0.1) and
    ``eps`` sits inside the root, ``p -= lr * g / sqrt(acc + g^2 + eps)``."""

    def __init__(self, params, lr: float = 1.0,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(
                        p, group["initial_accumulator_value"])
                acc = state["sum"]
                acc.add_(p.grad * p.grad)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                                    0.0)
                p.sub_(group["lr"] * p.grad * scale)


def make_optimizer(tc: TrainConfig, params, epoch: int = 0):
    """The optimizer of ``tc`` over ``params`` (a dict of leaf tensors) at
    the schedule value of ``epoch``.  ``sgd`` / momentum and ``adam`` are
    ``torch.optim``'s (the same updates as ``optax.sgd`` / ``optax.adam``);
    ``adagrad`` is :class:`Adagrad`.  ``l2`` is added to the gradient by
    the trainer (``optax.add_decayed_weights`` before the optimizer)."""
    lr = tc.lr * (tc.lr_decay ** epoch)
    leaves = list(params.values())
    if tc.optimizer == "sgd":
        return torch.optim.SGD(leaves, lr=lr, momentum=tc.momentum)
    if tc.optimizer == "adam":
        return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if tc.optimizer == "adagrad":
        return Adagrad(leaves, lr=lr)
    if tc.optimizer == "lbfgs":
        raise NotImplementedError(
            "optimizer 'lbfgs' (optax.scale_by_lbfgs without line search) "
            "has no torch.optim counterpart with the same numbers; it is "
            "not ported yet (ROADMAP.md Queue 1, slice 2, still open)")
    raise ValueError(f"unknown optimizer {tc.optimizer!r}")


# batch dict keys moved to the device for the steps
BATCH_KEYS = ("feats", "labels", "lengths", "sparse_idx", "sparse_val")


def to_device(batch: dict, device) -> dict:
    """The step's keys of a loader batch as tensors on ``device`` (pinned
    and copied without blocking on a GPU)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if k in BATCH_KEYS:
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                out[k] = t.pin_memory().to(device, non_blocking=True)
            else:
                out[k] = t.to(device)
    return out


def _prefetch(batches, convert, depth: int):
    """Iterate ``convert(b) for b in batches`` with a background thread
    running ``depth`` items ahead, so batch assembly and the host-to-device
    copies overlap the current step; ``depth == 0`` is the synchronous
    loop.  If the consumer abandons the generator, a stop event ends the
    worker within a second (bounded ``put`` timeouts)."""
    if depth <= 0:
        for b in batches:
            yield convert(b)
        return
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=1.0)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not put(convert(b)):
                    return
            put(end)
        except BaseException as e:          # surface loader errors
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()
    finally:
        stop.set()


def _batch_sparse(batch):
    """(indices, values) from a sparse batch, else None (dense)."""
    if "sparse_idx" in batch:
        return (batch["sparse_idx"], batch["sparse_val"])
    return None


def make_eval_step(cfg: CrfConfig, label_kind: str = "phone") -> Callable:
    """``eval_step(params, batch)``: loss, correct / valid frame counts and
    the decoded phones, all device tensors."""
    @torch.no_grad()
    def eval_step(params, batch):
        sparse = _batch_sparse(batch)
        loss, aux = crf_mod.crf_loss(cfg, params, batch.get("feats"),
                                     batch["labels"], batch["lengths"],
                                     sparse=sparse, label_kind=label_kind)
        phones, _, _ = crf_mod.decode(cfg, params, batch.get("feats"),
                                      batch["lengths"], sparse=sparse)
        labels = batch["labels"]
        T = labels.shape[-1]
        valid = (torch.arange(T, device=labels.device)[None, :]
                 < batch["lengths"][:, None])
        ref = (cfg.topology.phone_of(labels) if label_kind == "state"
               else labels)
        return {"loss": loss, "correct": ((phones == ref) & valid).sum(),
                "valid": valid.sum(), "phones": phones,
                "frames": aux["frames"]}
    return eval_step


class Trainer:
    """Epoch-loop runner (the ``CRF_SGTrainer::train()`` analogue).

    ``params``: a dict of tensors (copied into leaves that require grad),
    or None for the reference's zero start on ``device``, the card unless
    asked for the CPU (it raises without one)."""

    def __init__(self, cfg: CrfConfig, tc: TrainConfig,
                 params: Optional[dict] = None, label_kind: str = "phone",
                 logger: Optional[MetricsLogger] = None, device=None):
        self.cfg, self.tc = cfg, tc
        self.label_kind = label_kind
        if params is None:
            device = torch.device(device or "cuda")
            if device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"Trainer(device={device}): no CUDA "
                                   "device is available; pass device='cpu' "
                                   "to train on the CPU")
            params = cfg.init_params(device=device)
        self.params = {k: v.detach().clone().to(device or v.device)
                       .requires_grad_(True) for k, v in params.items()}
        self.device = next(iter(self.params.values())).device
        self.opt = make_optimizer(tc, self.params)
        self.eval_fn = make_eval_step(cfg, label_kind)
        self.avg_params = {k: v.detach().clone()
                           for k, v in self.params.items()}
        self.step = 0
        self.epoch = 0
        self.logger = logger or MetricsLogger(
            os.path.join(tc.out_dir, "metrics.jsonl") if tc.out_dir else None)

    def current_lr(self) -> float:
        return self.tc.lr * (self.tc.lr_decay ** self.epoch)

    def loss(self, batch: dict):
        return crf_mod.crf_loss(self.cfg, self.params, batch.get("feats"),
                                batch["labels"], batch["lengths"],
                                sparse=_batch_sparse(batch),
                                label_kind=self.label_kind)

    def grad_step(self, batch: dict) -> dict:
        """Add one micro-batch's gradient into the params' ``.grad``."""
        loss, aux = self.loss(batch)
        if diagnostics.debug_nans_enabled():
            diagnostics.check_finite("train step", self.step, loss=loss)
            try:
                loss.backward()
            except RuntimeError as e:      # autograd's anomaly detection
                if "nan" not in str(e).lower():
                    raise
                raise FloatingPointError(
                    f"train step: {e} at step {self.step} "
                    "(--debug_nans)") from e
        else:
            loss.backward()
        return {"loss": loss.detach(), "frames": aux["frames"],
                "mean_logZ": aux["logZ"].detach().mean()}

    @torch.no_grad()
    def apply_step(self, lr: float) -> None:
        """Apply the gradient in ``.grad`` scaled by ``lr`` (``l2`` added
        first), update the average, and clear the gradient."""
        if self.tc.l2:
            for p in self.params.values():
                p.grad.add_(p, alpha=self.tc.l2)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        if self.tc.weight_avg:
            d = self.tc.avg_decay
            for k, p in self.params.items():
                self.avg_params[k].mul_(d).add_(p, alpha=1 - d)
        for p in self.params.values():
            p.grad = None

    def train_step(self, batch: dict, lr: float) -> dict:
        """One optimizer step on one batch; metrics as device tensors."""
        m = self.grad_step(batch)
        grads = [p.grad for p in self.params.values()]
        m["grad_norm"] = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        if diagnostics.debug_nans_enabled():
            diagnostics.check_finite(
                "train step", self.step, grad_norm=m["grad_norm"],
                params=torch.stack([torch.linalg.vector_norm(p.detach())
                                    for p in self.params.values()]))
        self.apply_step(lr)
        return m

    def train_epoch(self, loader, put: Optional[Callable] = None) -> Dict:
        """One epoch over ``loader.epoch_batches()``.  ``put``: optional
        batch placement (default: :func:`to_device` on the params'
        device)."""
        t_start = time.time()
        losses, frame_counts = [], []    # device tensors; fetched at the end
        lr = self.current_lr()
        accum = max(1, self.tc.accum_steps)
        n_acc = 0
        convert = put or (lambda b: to_device(b, self.device))
        for batch in _prefetch(loader.epoch_batches(self.epoch), convert,
                               self.tc.prefetch):
            with diagnostics.step_annotation("train", self.step):
                if accum == 1:
                    m = self.train_step(batch, lr)
                else:
                    m = self.grad_step(batch)
                    n_acc += 1
                    if n_acc == accum:
                        self.apply_step(lr / accum)
                        n_acc = 0
            self.step += 1
            losses.append(m["loss"].reshape(1))
            frame_counts.append(m["frames"].reshape(1))
            if (self.tc.check_sync_every
                    and self.step % self.tc.check_sync_every == 0):
                diagnostics.assert_replicated(self.params)
            if self.step % self.tc.log_every == 0:
                self.logger.log("train_step", step=self.step,
                                epoch=self.epoch, loss=float(m["loss"]),
                                grad_norm=float(m.get("grad_norm", 0.0)),
                                mean_logZ=float(m["mean_logZ"]))
        if n_acc:
            # trailing partial accumulation at epoch end
            self.apply_step(lr / n_acc)
        # one host fetch for the whole epoch's metrics
        if losses:
            all_loss = torch.cat(losses).cpu().numpy()
            frames = int(torch.cat(frame_counts).sum())
        else:
            all_loss, frames = np.zeros((0,)), 0
        wall = time.time() - t_start
        audio_s = frames * self.tc.frame_shift_s
        out = {"epoch": self.epoch,
               "mean_loss": float(np.mean(all_loss)) if len(all_loss)
               else 0.0,
               "frames": frames, "wall_s": wall,
               "audio_s_per_s": audio_s / max(wall, 1e-9)}
        self.logger.log("train_epoch", **out)
        if self.tc.out_dir:
            os.makedirs(self.tc.out_dir, exist_ok=True)
            # reference-style per-epoch flat weight file
            weights_mod.save_raw(
                os.path.join(self.tc.out_dir, f"weights.i{self.epoch}.dat"),
                self.cfg.fmap, self.params)
        self.epoch += 1
        return out

    def evaluate(self, loader, ref_phone_seqs: Optional[dict] = None,
                 fold: Optional[np.ndarray] = None) -> Dict:
        """CV pass: mean loss, frame accuracy, and (if references given)
        PER.  ``ref_phone_seqs``: uid -> phone sequence."""
        losses, correct, valid = [], 0, 0
        scorer = ErrorRateScorer()
        for batch in loader.epoch_batches(0):
            m = self.eval_fn(self.params, to_device(batch, self.device))
            losses.append(float(m["loss"]))
            correct += int(m["correct"])
            valid += int(m["valid"])
            if ref_phone_seqs is not None:
                refs = [ref_phone_seqs.get(int(u)) for u in batch["uids"]]
                score_batch(scorer, refs, m["phones"].cpu().numpy(),
                            batch["lengths"], fold=fold)
        out = {"cv_loss": float(np.mean(losses)) if losses else float("nan"),
               "frame_accuracy": correct / max(valid, 1)}
        if ref_phone_seqs is not None:
            out["per"] = scorer.error_rate
            out.update({f"per_{k}": v for k, v in scorer.summary().items()
                        if k in ("sub", "ins", "del")})
        self.logger.log("eval", epoch=self.epoch, **out)
        return out

    def fit(self, train_loader, cv_loader=None, ref_phone_seqs=None,
            fold=None, put=None) -> Dict:
        last = {}
        with diagnostics.profiler_session(self.tc.profile_dir):
            for _ in range(self.tc.epochs):
                last = self.train_epoch(train_loader, put=put)
                if cv_loader is not None:
                    last.update(self.evaluate(cv_loader, ref_phone_seqs,
                                              fold))
        return last

    @property
    def inference_params(self) -> dict:
        src = self.avg_params if self.tc.weight_avg else self.params
        return {k: v.detach() for k, v in src.items()}
