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

:func:`make_train_step` is the counterpart of the JAX package's jitted
steps: the step, ``grad_step`` / ``apply_step`` and ``multi_step`` (K
steps in one call, ``lax.scan``'s counterpart) are CUDA graphs on the card
(:mod:`asr_craft_tpu_torch.train.graphs`), one a batch shape, replayed;
the same code runs eagerly on the CPU, under :func:`graphs.disabled`,
``--debug_nans`` and ``check_sync_every``.  ``steps_per_call`` groups
same-shape batches into one ``multi_step`` replay, as the JAX trainer
groups them into one ``lax.scan``.

Data parallelism (a :class:`asr_craft_tpu_torch.parallel.Mesh` given to
:func:`make_train_step` or :class:`Trainer`): each rank runs the same
compiled step on its own rows, and the step itself issues the collectives,
inside the CUDA graph (NCCL collectives capture), so ``multi_step`` stays
one replay: first the sum of the frame and row counts over the ranks, then
the gradient of the rank's summed NLL over the GLOBAL frame count, summed
over the ranks tensor by tensor, and the metrics' sums.  That is the
gradient of the global batch's mean, as XLA's psum over a sharded batch
gives it; the mean of the ranks' means (``DistributedDataParallel``'s
average) differs whenever the ranks hold different frame counts.  Every
rank applies the same reduced gradient, so parameters, optimizer state and
averages stay bit-identical; ``loss``, ``grad_norm`` and ``mean_logZ`` are
the global batch's."""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from asr_craft_tpu_torch.decode.scorer import ErrorRateScorer, score_batch
from asr_craft_tpu_torch.models import crf as crf_mod
from asr_craft_tpu_torch.models import segmental as seg_mod
from asr_craft_tpu_torch.models import weights as weights_mod
from asr_craft_tpu_torch.models.crf import CrfConfig
from asr_craft_tpu_torch.parallel import mesh as mesh_mod
from asr_craft_tpu_torch.train import graphs
from asr_craft_tpu_torch.utils import diagnostics
from asr_craft_tpu_torch.utils.logging import MetricsLogger


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's ``crf_lr`` / ``crf_epochs`` / trainer-selection
    flags; the fields and defaults are the JAX ``TrainConfig``'s."""

    lr: float = 0.05
    lr_decay: float = 1.0          # multiplicative per-epoch decay
    momentum: float = 0.0
    optimizer: str = "sgd"          # "sgd" | "adam" | "adagrad" | "lbfgs"
    l2: float = 0.0                 # weight decay (reference gaussian prior)
    epochs: int = 5
    weight_avg: bool = False        # Polyak averaging of lambdas
    avg_decay: float = 0.999
    accum_steps: int = 1            # micro-batches summed per update
    steps_per_call: int = 1         # steps a multi_step call (one graph)
    log_every: int = 50
    frame_shift_s: float = 0.01     # 10ms frames: audio-seconds metric
    out_dir: Optional[str] = None   # per-epoch weight files + metrics.jsonl
    profile_dir: Optional[str] = None   # torch.profiler trace of fit()
    check_sync_every: int = 0       # assert_replicated every N steps
    prefetch: int = 2               # background batch-assembly depth


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8       # optax.adam's defaults
ADAGRAD_INIT, ADAGRAD_EPS = 0.1, 1e-7               # optax.adagrad's
LBFGS_MEMORY = 10                         # optax.scale_by_lbfgs's memory_size


class Optimizer:
    """One optimizer update over device tensors, the same for the eager
    step and its CUDA graph, so the two give the same bits.  The updates
    are optax's: ``sgd`` (``momentum``: ``optax.trace``), ``adam`` (b1 0.9,
    b2 0.999, eps 1e-8 outside the root; the step count a device tensor)
    and ``adagrad`` (``optax.scale_by_rss``: the accumulator starts at 0.1,
    eps 1e-7 inside the root), ``lbfgs`` (:meth:`_lbfgs`), ``l2`` added to
    the gradient first (``optax.add_decayed_weights``), then ``params -= lr
    * update``.

    ``torch.optim`` is not used: ``SGD`` with a tensor lr reads it back to
    the host, ``Adam`` captures only with ``capturable=True``, and an
    lr kept in ``param_groups`` is a Python float baked into a graph."""

    def __init__(self, kind: str, lr: float = 1.0, momentum: float = 0.0,
                 l2: float = 0.0):
        if kind not in ("sgd", "adam", "adagrad", "lbfgs"):
            raise ValueError(f"unknown optimizer {kind!r}")
        self.kind, self.lr, self.momentum, self.l2 = kind, lr, momentum, l2

    def init(self, params: dict) -> dict:
        """The optimizer's state for ``params``: a dict of tensors beside
        them (empty for plain SGD)."""
        zeros = lambda: {k: torch.zeros_like(p.detach())
                         for k, p in params.items()}
        if self.kind == "adam":
            dev = next(iter(params.values())).device
            return {"mu": zeros(), "nu": zeros(),
                    "count": torch.zeros((), device=dev)}
        if self.kind == "adagrad":
            return {"sum": {k: torch.full_like(p.detach(), ADAGRAD_INIT)
                            for k, p in params.items()}}
        if self.kind == "lbfgs":
            dev = next(iter(params.values())).device
            ring = lambda: {k: torch.zeros((LBFGS_MEMORY,) + p.shape,
                                           dtype=p.dtype, device=dev)
                            for k, p in params.items()}
            return {"count": torch.zeros((), dtype=torch.int64, device=dev),
                    "params": zeros(), "updates": zeros(), "dw": ring(),
                    "du": ring(),
                    "rho": torch.zeros((LBFGS_MEMORY,), device=dev)}
        return {"trace": zeros()} if self.momentum else {}

    @staticmethod
    def _vdot(a: dict, b: dict):
        """The inner product of two trees, over every tensor: each key's
        sum, added in sorted key order (optax's ``tree.vdot`` flattens a
        dict in that order)."""
        return sum((a[k] * b[k]).sum() for k in sorted(a))

    def _lbfgs(self, grads: dict, state: dict, params: dict) -> dict:
        """optax 0.2.6 ``scale_by_lbfgs(memory_size=10,
        scale_init_precond=True)`` (``optax/_src/transform.py``): the
        memory of the last 10 differences of the parameters (``dw``) and of
        the updates (``du``), their weights ``rho = 1 / <du, dw>`` and the
        two-loop recursion over them.  The inner products run over the
        whole tree, as optax flattens it.  The ring index and the step
        count are device tensors and nothing branches on a value, so the
        step captures as one CUDA graph.  Returns the preconditioned
        updates; ``params`` are those before this step."""
        m = LBFGS_MEMORY
        count = state["count"]
        idx, prev = count % m, ((count - 1) % m).reshape(1)
        started = count > 0
        # 1. the memory, from the fresh parameters and updates (zero at the
        #    first step, where the differences are not defined)
        dw = {k: torch.where(started, params[k] - state["params"][k], 0.0)
              for k in params}
        du = {k: torch.where(started, grads[k] - state["updates"][k], 0.0)
              for k in params}
        vdot = self._vdot(du, dw)
        weight = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
        weight = torch.where(started, weight, 0.0)
        for k in params:
            state["dw"][k].index_copy_(0, prev, dw[k][None])
            state["du"][k].index_copy_(0, prev, du[k][None])
        state["rho"].index_copy_(0, prev, weight.reshape(1))
        # 2. the initial inverse Hessian: <du, dw> / <du, du>, and at the
        #    first step the capped reciprocal of the update's norm
        den = self._vdot(du, du)
        scale = torch.where(den > 0.0, vdot / den, 1.0)
        norm = torch.sqrt(self._vdot(grads, grads))
        scale = torch.where(started, scale, torch.clamp(1.0 / norm, max=1.0))
        # 3. the two-loop recursion, newest pair first, then oldest first
        rho, S, Y = state["rho"], state["dw"], state["du"]
        order = [((idx + j) % m).reshape(1) for j in range(m)]
        at = lambda ring, i: {k: ring[k].index_select(0, i)[0] for k in ring}
        v, alphas = dict(grads), {}
        for j in reversed(range(m)):
            i = order[j]
            s_i, y_i = at(S, i), at(Y, i)
            alphas[j] = rho.index_select(0, i)[0] * self._vdot(s_i, v)
            v = {k: v[k] + (-alphas[j]) * y_i[k] for k in v}
        v = {k: scale * x for k, x in v.items()}
        for j in range(m):
            i = order[j]
            s_i, y_i = at(S, i), at(Y, i)
            beta = rho.index_select(0, i)[0] * self._vdot(y_i, v)
            v = {k: v[k] + (alphas[j] - beta) * s_i[k] for k in v}
        for k in params:
            state["params"][k].copy_(params[k])
            state["updates"][k].copy_(grads[k])
        count.add_(1)
        return v

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict,
               lr=None) -> None:
        """Apply one update to ``params`` and ``state`` in place; ``lr``: a
        number or a 0-d tensor on the params' device (default: the
        optimizer's own)."""
        lr = self.lr if lr is None else lr
        if self.kind == "adam":
            state["count"].add_(1.0)
            bc1 = 1.0 - ADAM_B1 ** state["count"]
            bc2 = 1.0 - ADAM_B2 ** state["count"]
        if self.l2:
            grads = {k: grads[k] + self.l2 * p for k, p in params.items()}
        if self.kind == "lbfgs":
            grads = self._lbfgs(grads, state, params)
        for k, p in params.items():
            g = grads[k]
            if self.kind == "adam":
                mu, nu = state["mu"][k], state["nu"][k]
                mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                u = (mu / bc1) / ((nu / bc2).sqrt() + ADAM_EPS)
            elif self.kind == "adagrad":
                acc = state["sum"][k]
                acc.addcmul_(g, g)
                u = torch.where(acc > 0, torch.rsqrt(acc + ADAGRAD_EPS),
                                0.0) * g
            elif self.kind == "sgd" and self.momentum:
                u = state["trace"][k].mul_(self.momentum).add_(g)
            else:
                u = g
            p.sub_(u * lr)


def make_optimizer(tc: TrainConfig, epoch: int = 0) -> Optimizer:
    """The optimizer of ``tc`` at the schedule value of ``epoch``, as the
    JAX ``make_optimizer`` builds it (``l2`` included; ``lbfgs`` is
    ``optax.chain(optax.scale_by_lbfgs(), optax.scale(-lr))`` there, with no
    line search)."""
    return Optimizer(tc.optimizer, tc.lr * (tc.lr_decay ** epoch),
                     tc.momentum, tc.l2)


# batch dict keys moved to the device for the steps
BATCH_KEYS = mesh_mod.BATCH_KEYS


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


def _epoch_len(loader) -> int:
    """The number of batches ``loader.epoch_batches()`` yields (an
    :class:`asr_craft_tpu_torch.data.UtteranceLoader`), from its bucket
    sizes alone: no batch is assembled."""
    bs = loader.cfg.batch_size
    sizes = {}
    for i in range(len(loader)):
        b = loader._bucket_of(loader._num_frames(i))
        sizes[b] = sizes.get(b, 0) + 1
    if loader.cfg.drop_remainder:
        return sum(n // bs for n in sizes.values())
    return sum(-(-n // bs) for n in sizes.values())


def _even_epoch(batches, n: int):
    """``batches``, then empty batches (the last one's shapes, every length
    0) up to ``n`` in all, the longest shard's count, so that every rank
    runs as many steps and so issues as many collectives."""
    last, seen = None, 0
    for last in batches:
        seen += 1
        yield last
    if n > seen and last is None:
        raise ValueError("this rank holds no utterance of the epoch: fewer "
                         "utterances than ranks")
    for _ in range(n - seen):
        yield {k: (np.zeros_like(v) if k == "lengths" else
                   np.full_like(v, -1) if k == "uids" else v)
               for k, v in last.items()}


def _batch_sparse(batch):
    """(indices, values) from a sparse batch, else None (dense)."""
    if "sparse_idx" in batch:
        return (batch["sparse_idx"], batch["sparse_val"])
    return None


def crf_loss_fn(cfg: CrfConfig, label_kind: str = "phone") -> Callable:
    """``loss_fn(params, batch) -> (loss, aux)``: :func:`crf_loss` of a
    loader batch, the criterion :func:`make_train_step` takes by
    default."""
    def loss_fn(params, batch):
        return crf_mod.crf_loss(cfg, params, batch.get("feats"),
                                batch["labels"], batch["lengths"],
                                sparse=_batch_sparse(batch),
                                label_kind=label_kind)
    loss_fn.precision = cfg.precision       # a key of the step's graphs
    return loss_fn


def scrf_loss_fn(cfg: seg_mod.SegCrfConfig, dense: bool = False
                 ) -> Callable:
    """``loss_fn(params, batch) -> (loss, aux)`` of the segmental CRF
    (``models.segmental.scrf_loss_fused``, reached through the criterion
    of both families, ``models.crf.crf_loss``; ``dense``: the materialized
    oracle ``scrf_loss``, whose numerator reads lengths on the host and so
    runs only eagerly), with the frames the step's metrics count."""
    loss = seg_mod.scrf_loss if dense else crf_mod.crf_loss

    def loss_fn(params, batch):
        value, aux = loss(cfg, params, batch["feats"], batch["labels"],
                          batch["lengths"])
        return value, {"logZ": aux["logZ"], "nll": aux["nll"],
                       "frames": batch["lengths"].sum().clamp(min=1)}
    loss_fn.precision = cfg.precision
    return loss_fn


class _Model(NamedTuple):
    """What the trainer needs of a model family: its criterion, the body of
    its CV step, the writer of an epoch's weights ``save(out_dir, epoch,
    params)``, and whether its steps run only eagerly (their code reads the
    device from the host, which a CUDA graph cannot capture)."""
    loss_fn: Callable
    eval_body: Callable
    save: Callable
    eager: bool


def _model(cfg, label_kind: str = "phone") -> _Model:
    """The one place the trainer tells the models apart, by the config's
    type: a :class:`CrfConfig` (linear-chain, its flat weight files) or a
    :class:`asr_craft_tpu_torch.models.segmental.SegCrfConfig` (the
    segmental CRF, ``scrf_weights``-style ``.npz`` files; with
    ``num_states > 1`` its numerator reads lengths on the host, so its
    steps stay eager)."""
    if isinstance(cfg, seg_mod.SegCrfConfig):
        return _Model(scrf_loss_fn(cfg), _scrf_eval_body(cfg), _save_npz,
                      cfg.num_states > 1)
    return _Model(crf_loss_fn(cfg, label_kind),
                  _crf_eval_body(cfg, label_kind),
                  functools.partial(_save_raw, cfg.fmap), False)


def _save_raw(fmap, out_dir: str, epoch: int, params: dict) -> None:
    """The reference-style flat weight file ``weights.i<epoch>.dat``."""
    weights_mod.save_raw(os.path.join(out_dir, f"weights.i{epoch}.dat"),
                         fmap, params)


def _save_npz(out_dir: str, epoch: int, params: dict) -> None:
    """``weights.i<epoch>.npz``, one named array a parameter, as the
    segmental recipe writes ``scrf_weights.npz``
    (:func:`asr_craft_tpu_torch.models.weights.load_npz` reads it)."""
    weights_mod.save_npz(os.path.join(out_dir, f"weights.i{epoch}.npz"),
                         params)


def _global_norm(grads: dict):
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()]))


class TrainStep:
    """The compiled step of :func:`make_train_step`, with the JAX
    ``_StepFns``' names.  Each function updates the tensors it is given in
    place and returns them, and each is a :class:`graphs.Graphed` on the
    card: one CUDA graph a batch shape, replayed; the eager code on the CPU
    and inside :func:`graphs.disabled`.

    - ``step(params, opt_state, avg_params, batch, lr) -> (params,
      opt_state, avg_params, metrics)``: loss, gradient, update, average;
      metrics ``loss``, ``grad_norm``, ``mean_logZ``, ``frames``.
    - ``grad_step(params, grad_acc, batch) -> (grad_acc, metrics)``: adds
      one micro-batch's gradient into ``grad_acc`` (``accum_steps``).
    - ``apply_step(params, opt_state, avg_params, grad_acc, lr) -> (params,
      opt_state, avg_params)``: applies ``grad_acc`` and zeroes it in
      place, ready for the next accumulation.
    - ``multi_step(params, opt_state, avg_params, batches, lr)``: K steps on
      a list of K same-shape batches in one graph, the counterpart of
      ``lax.scan``; metrics with a leading (K,) axis.

    ``params`` are leaf tensors that require grad.  ``lr`` is a number,
    held on the device in a 0-d tensor that is refilled when it changes,
    so the graphs read the schedule's value without being captured
    again.

    ``mesh``: data parallelism over its ranks (the module's docstring);
    the loss's ``aux`` must then hold the per-utterance ``nll``.

    The loss function's ``precision`` (set by :func:`crf_loss_fn` and
    :func:`scrf_loss_fn`) is a key of every graph: a step whose
    ``loss_fn`` is replaced by one of another precision captures anew
    rather than replay the old products."""

    def __init__(self, loss_fn: Callable, opt: Optimizer, tc: TrainConfig,
                 mesh: Optional[mesh_mod.Mesh] = None):
        self.loss_fn, self.opt, self.tc, self.mesh = loss_fn, opt, tc, mesh
        pool = graphs.Pool()
        self._step = graphs.Graphed(self._step_impl, pool, "train step")
        self._grad = graphs.Graphed(self._grad_impl, pool, "grad_step")
        self._apply = graphs.Graphed(self._apply_impl, pool, "apply_step")
        self._multi = graphs.Graphed(self._multi_impl, pool, "multi_step")
        self._lr = {}                       # device -> (0-d tensor, value)

    def _bound(self, *tensors) -> tuple:
        """The graphs' bound tensors and, as a static leaf, the loss's
        precision."""
        return tensors + (getattr(self.loss_fn, "precision", None),)

    def _lr_tensor(self, lr: float, params: dict):
        dev = next(iter(params.values())).device
        t, value = self._lr.get(dev, (None, None))
        if t is None:
            t = torch.zeros((), device=dev)
        if value != lr:
            t.fill_(lr)
            self._lr[dev] = (t, lr)
        return t

    def _grads(self, params: dict, batch: dict):
        """``(loss, aux, grads)`` of the batch; under data parallelism of
        the global batch (``aux``'s ``frames`` and ``logZ_mean`` then
        global too)."""
        loss, aux = self.loss_fn(params, batch)
        if self.mesh is not None:
            return self._global_grads(params, batch, aux)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
        aux = dict(aux, logZ_mean=aux["logZ"].detach().mean())
        return loss.detach(), aux, dict(zip(params, grads))

    def _global_grads(self, params: dict, batch: dict, aux: dict):
        if "nll" not in aux:
            raise ValueError("data-parallel training needs the loss's "
                             "per-utterance nll in aux['nll']")
        lengths = batch["lengths"]
        # the global batch's frames and rows, before the backward: the
        # rank's share of the global mean is its NLL sum over them
        counts = torch.stack([lengths.sum(), torch.full_like(
            lengths.sum(), lengths.shape[0])])
        dist.all_reduce(counts)
        frames = counts[0].clamp(min=1)
        nll = aux["nll"].sum()
        grads = torch.autograd.grad(nll / frames, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
        # each gradient reduced where autograd left it, in its own layout: a
        # view into one flat buffer would sit at another alignment, and
        # CUDA's reductions (the gradient norm) vectorize by alignment, so
        # they would not give one process's bits; a strided gradient (the
        # fdt weights') is reduced as a contiguous copy and written back
        for g in grads:
            if g.is_contiguous():
                dist.all_reduce(g)
            else:
                c = g.contiguous()
                dist.all_reduce(c)
                g.copy_(c)
        sums = torch.stack([nll.detach(), aux["logZ"].detach().sum()])
        dist.all_reduce(sums)
        aux = dict(aux, frames=frames, logZ_mean=sums[1] / counts[1])
        return sums[0] / frames, aux, dict(zip(params, grads))

    def _average(self, avg_params: dict, params: dict) -> None:
        if self.tc.weight_avg:
            d = self.tc.avg_decay
            for k, p in params.items():
                avg_params[k].mul_(d).add_(p, alpha=1 - d)

    def _step_impl(self, bound, batch):
        params, opt_state, avg_params, lr, _ = bound
        loss, aux, grads = self._grads(params, batch)
        with torch.no_grad():
            grad_norm = _global_norm(grads)
            self.opt.update(grads, opt_state, params, lr)
            self._average(avg_params, params)
        return {"loss": loss, "grad_norm": grad_norm,
                "mean_logZ": aux["logZ_mean"], "frames": aux["frames"]}

    def _grad_impl(self, bound, batch):
        params, grad_acc, _ = bound
        loss, aux, grads = self._grads(params, batch)
        with torch.no_grad():
            for k, g in grads.items():
                grad_acc[k].add_(g)
        return {"loss": loss, "frames": aux["frames"],
                "mean_logZ": aux["logZ_mean"]}

    @torch.no_grad()
    def _apply_impl(self, bound, _):
        params, opt_state, avg_params, grad_acc, lr, _ = bound
        self.opt.update(grad_acc, opt_state, params, lr)
        self._average(avg_params, params)
        for g in grad_acc.values():
            g.zero_()
        return {}

    def _multi_impl(self, bound, batches):
        ms = [self._step_impl(bound, b) for b in batches]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    def __call__(self, params, opt_state, avg_params, batch, lr):
        m = self._step(self._bound(params, opt_state, avg_params,
                                   self._lr_tensor(lr, params)), batch)
        return params, opt_state, avg_params, m

    def grad_step(self, params, grad_acc, batch):
        return grad_acc, self._grad(self._bound(params, grad_acc), batch)

    def apply_step(self, params, opt_state, avg_params, grad_acc, lr):
        self._apply(self._bound(params, opt_state, avg_params, grad_acc,
                                self._lr_tensor(lr, params)), None)
        return params, opt_state, avg_params

    def multi_step(self, params, opt_state, avg_params, batches, lr):
        m = self._multi(self._bound(params, opt_state, avg_params,
                                    self._lr_tensor(lr, params)),
                        list(batches))
        return params, opt_state, avg_params, m


def make_train_step(cfg, tc: TrainConfig, label_kind: str = "phone",
                    loss_fn: Optional[Callable] = None,
                    mesh: Optional[mesh_mod.Mesh] = None):
    """``(step, opt)``: the compiled :class:`TrainStep` of ``tc`` and its
    optimizer built at lr 1 (``opt.init(params)`` makes the state), as the
    JAX ``make_train_step`` returns them.  The step's updates are scaled by
    the ``lr`` of each call (the epoch's schedule value).  ``cfg``: a
    :class:`CrfConfig` (criterion :func:`crf_loss_fn`) or a ``SegCrfConfig``
    (:func:`scrf_loss_fn`).  ``loss_fn(params, batch) -> (loss, aux)`` with
    ``aux["logZ"]`` and ``aux["frames"]`` replaces ``cfg``'s criterion (the
    segmental recipe's ``--dense_loss`` passes its own).  ``mesh``: the
    step is data-parallel over its ranks."""
    opt = make_optimizer(dataclasses.replace(tc, lr=1.0))
    return TrainStep(loss_fn or _model(cfg, label_kind).loss_fn, opt, tc,
                     mesh), opt


def _frame_metrics(loss, phones, ref, lengths, frames) -> dict:
    """The CV step's metrics: the loss, the frames whose decoded phone is
    the reference's among the real ones (``correct``, ``valid``), the
    phones and the frame count."""
    T = ref.shape[-1]
    valid = (torch.arange(T, device=ref.device)[None, :]
             < lengths[:, None])
    return {"loss": loss, "correct": ((phones == ref) & valid).sum(),
            "valid": valid.sum(), "phones": phones, "frames": frames}


def _crf_eval_body(cfg: CrfConfig, label_kind: str):
    @torch.no_grad()
    def eval_step(params, batch):
        sparse = _batch_sparse(batch)
        loss, aux = crf_mod.crf_loss(cfg, params, batch.get("feats"),
                                     batch["labels"], batch["lengths"],
                                     sparse=sparse, label_kind=label_kind)
        phones, _, _ = crf_mod.decode(cfg, params, batch.get("feats"),
                                      batch["lengths"], sparse=sparse)
        labels = batch["labels"]
        ref = (cfg.topology.phone_of(labels) if label_kind == "state"
               else labels)
        return _frame_metrics(loss, phones, ref, batch["lengths"],
                              aux["frames"])
    return eval_step


def _scrf_eval_body(cfg: seg_mod.SegCrfConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        feats, lengths = batch["feats"], batch["lengths"]
        loss, _ = seg_mod.scrf_loss_fused(cfg, params, feats,
                                          batch["labels"], lengths)
        phones, _ = seg_mod.scrf_frame_labels(cfg, params, feats, lengths)
        return _frame_metrics(loss, phones, batch["labels"], lengths,
                              lengths.sum().clamp(min=1))
    return eval_step


def make_eval_step(cfg, label_kind: str = "phone"):
    """``eval_step(params, batch)``: loss, correct / valid frame counts and
    the decoded phones, all device tensors; one CUDA graph a batch shape on
    the card (:class:`graphs.Graphed`: the loss and the decode, K1 and K3
    at config 2, K4, K7 or K8 and the traceback at configs 1, 3, 5; K9,
    K12, K13 and the frames' labels (``scrf_frame_labels``) at config 4)."""
    return graphs.Graphed(_model(cfg, label_kind).eval_body,
                          name="eval step")


class Trainer:
    """Epoch-loop runner (the ``CRF_SGTrainer::train()`` analogue).

    ``params``: a dict of tensors (copied into leaves that require grad),
    or None for the reference's zero start on ``device``, the card unless
    asked for the CPU (it raises without one).  The steps run through
    :func:`make_train_step` and :func:`make_eval_step`: CUDA graphs on the
    card, eager under ``--debug_nans`` (its checks read the device) and
    ``check_sync_every``, and on the CPU.

    ``cfg``: a :class:`CrfConfig` or a segmental CRF's ``SegCrfConfig``
    (its criterion ``scrf_loss_fused``, its CV pass the segmental decode
    through ``scrf_frame_labels``, its weights written with
    ``weights.save_npz``; with ``num_states > 1`` every step eager, as its
    numerator reads lengths on the host).

    ``mesh``: data-parallel training over its ranks, each on its own
    loader shard and device (``mesh.device``).  Rank 0's parameters are
    broadcast at the start; every epoch runs as many steps on every rank
    (a rank whose shard ends first steps on an empty batch, which adds no
    frame and no gradient); the CV pass sums its counts over the ranks;
    only rank 0 writes weight files."""

    def __init__(self, cfg, tc: TrainConfig,
                 params: Optional[dict] = None, label_kind: str = "phone",
                 logger: Optional[MetricsLogger] = None, device=None,
                 mesh: Optional[mesh_mod.Mesh] = None):
        self.cfg, self.tc = cfg, tc
        self.label_kind = label_kind
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
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
        if mesh is not None:
            mesh_mod.replicate_tree(mesh, self.params)
        self.model = _model(cfg, label_kind)
        self.step_fn, self.opt = make_train_step(
            cfg, tc, label_kind, loss_fn=self.model.loss_fn, mesh=mesh)
        self.opt_state = self.opt.init(self.params)
        self.eval_fn = graphs.Graphed(self.model.eval_body, name="eval step")
        self.avg_params = {k: v.detach().clone()
                           for k, v in self.params.items()}
        self.grad_acc = None              # made at the first grad_step
        self.step = 0
        self.epoch = 0
        self.logger = logger or MetricsLogger(
            os.path.join(tc.out_dir, "metrics.jsonl") if tc.out_dir else None)

    @property
    def is_chief(self) -> bool:
        """Whether this process writes files: rank 0, or the only one."""
        return self.mesh is None or self.mesh.rank == 0

    def current_lr(self) -> float:
        return self.tc.lr * (self.tc.lr_decay ** self.epoch)

    def _eager(self):
        """Eager steps where the run reads the device between them:
        ``--debug_nans`` and ``check_sync_every``, or inside them (the
        model's ``eager``); else the graphs."""
        if (self.model.eager or diagnostics.debug_nans_enabled()
                or self.tc.check_sync_every):
            return graphs.disabled()
        return contextlib.nullcontext()

    def _checked(self, fn, *args):
        """``fn(*args)``; under ``--debug_nans`` autograd's anomaly error
        becomes a ``FloatingPointError`` naming the step."""
        with self._eager():
            if not diagnostics.debug_nans_enabled():
                return fn(*args)
            try:
                return fn(*args)
            except RuntimeError as e:      # autograd's anomaly detection
                if "nan" not in str(e).lower():
                    raise
                raise FloatingPointError(
                    f"train step: {e} at step {self.step} "
                    "(--debug_nans)") from e

    def _check_finite(self, m: dict) -> None:
        """Under ``--debug_nans``: raise naming the step unless the loss,
        the gradient norm (where ``m`` has one) and, after an update, the
        parameters are finite (a kernel's guards can swallow a NaN)."""
        if not diagnostics.debug_nans_enabled():
            return
        values = {k: m[k] for k in ("loss", "grad_norm") if k in m}
        if "grad_norm" in m:
            values["params"] = torch.stack([
                torch.linalg.vector_norm(p.detach())
                for p in self.params.values()])
        diagnostics.check_finite("train step", self.step, **values)

    def grad_step(self, batch: dict) -> dict:
        """Add one micro-batch's gradient into ``grad_acc``."""
        if self.grad_acc is None:
            self.grad_acc = {k: torch.zeros_like(p.detach())
                             for k, p in self.params.items()}
        _, m = self._checked(self.step_fn.grad_step, self.params,
                             self.grad_acc, batch)
        self._check_finite(m)
        return m

    def apply_step(self, lr: float) -> None:
        """Apply ``grad_acc`` scaled by ``lr`` (``l2`` added first), update
        the average, and zero ``grad_acc``."""
        self._checked(self.step_fn.apply_step, self.params, self.opt_state,
                      self.avg_params, self.grad_acc, lr)

    def train_step(self, batch: dict, lr: float) -> dict:
        """One optimizer step on one batch; metrics as device tensors."""
        *_, m = self._checked(self.step_fn, self.params, self.opt_state,
                              self.avg_params, batch, lr)
        self._check_finite(m)
        return m

    def multi_step(self, batches: list, lr: float) -> dict:
        """``len(batches)`` optimizer steps in one call (one graph on the
        card); metrics with a leading (K,) axis."""
        *_, m = self._checked(self.step_fn.multi_step, self.params,
                              self.opt_state, self.avg_params, batches, lr)
        self._check_finite(m)
        return m

    def train_epoch(self, loader, put: Optional[Callable] = None) -> Dict:
        """One epoch over ``loader.epoch_batches()``.  ``put``: optional
        batch placement (default: :func:`to_device` on the params'
        device).  With ``steps_per_call`` K > 1 (and no accumulation),
        same-shape batches go K at a time through :meth:`multi_step`; a
        shape change and the epoch's end flush a shorter group, as the JAX
        trainer does."""
        t_start = time.time()
        losses, frame_counts = [], []    # device tensors; fetched at the end
        lr = self.current_lr()
        accum = max(1, self.tc.accum_steps)
        spc = max(1, self.tc.steps_per_call)
        n_acc = 0
        pending = []                     # same-shape batches for one call

        def flush_pending():
            nonlocal pending
            if not pending:
                return
            if len(pending) == 1:
                m = self.train_step(pending[0], lr)
                ms = {k: v.reshape(1) for k, v in m.items()}
            else:
                ms = self.multi_step(pending, lr)
            k, pending = len(pending), []
            losses.append(ms["loss"])
            frame_counts.append(ms["frames"])
            for i in range(k):
                self.step += 1
                if self.step % self.tc.log_every == 0:
                    self.logger.log(
                        "train_step", step=self.step, epoch=self.epoch,
                        loss=float(ms["loss"][i]),
                        grad_norm=float(ms["grad_norm"][i]),
                        mean_logZ=float(ms["mean_logZ"][i]))

        convert = put or (lambda b: to_device(b, self.device))
        batches = loader.epoch_batches(self.epoch)
        if self.mesh is not None:
            # before the prefetch thread starts: collectives stay in order
            n = mesh_mod.reduce_host(self.mesh, [_epoch_len(loader)], "max")
            batches = _even_epoch(batches, int(n[0]))
        stream = _prefetch(batches, convert, self.tc.prefetch)
        while True:
            # a trip of the loop: the wait for a batch and what it runs
            # (a step, or a group's call once the group is whole); the
            # last trip meets the epoch's end and flushes the last group
            with diagnostics.span("train.step", step=self.step):
                with diagnostics.span("train.loader_wait"):
                    batch = next(stream, None)
                if batch is None:
                    flush_pending()       # the epoch's last, shorter group
                    break
                if spc > 1 and accum == 1:
                    if pending and pending[-1]["feats"].shape != \
                            batch["feats"].shape:
                        flush_pending()   # bucket boundary: a new shape
                    pending.append(batch)
                    if len(pending) == spc:
                        flush_pending()
                    continue
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
        if self.tc.out_dir and self.is_chief:
            os.makedirs(self.tc.out_dir, exist_ok=True)
            self.model.save(self.tc.out_dir, self.epoch, self.params)
        self.epoch += 1
        return out

    def evaluate(self, loader, ref_phone_seqs: Optional[dict] = None,
                 fold: Optional[np.ndarray] = None) -> Dict:
        """CV pass: mean loss, frame accuracy, and (if references given)
        PER.  ``ref_phone_seqs``: uid -> phone sequence."""
        losses, correct, valid = [], 0, 0
        scorer = ErrorRateScorer()
        for batch in loader.epoch_batches(0):
            with self._eager():
                m = self.eval_fn(self.params, to_device(batch, self.device))
            losses.append(float(m["loss"]))
            correct += int(m["correct"])
            valid += int(m["valid"])
            if ref_phone_seqs is not None:
                refs = [ref_phone_seqs.get(int(u)) for u in batch["uids"]]
                score_batch(scorer, refs, m["phones"].cpu().numpy(),
                            batch["lengths"], fold=fold)
        loss_sum, n = float(np.sum(losses)), len(losses)
        if self.mesh is not None:           # the global CV set's counts
            counts = mesh_mod.reduce_host(self.mesh, [
                loss_sum, n, correct, valid, scorer.errors, scorer.tokens,
                scorer.sub, scorer.ins, scorer.dele])
            loss_sum, n, correct, valid = counts[0], int(counts[1]), \
                int(counts[2]), int(counts[3])
            scorer.errors, scorer.tokens, scorer.sub, scorer.ins, \
                scorer.dele = (int(c) for c in counts[4:])
        out = {"cv_loss": loss_sum / n if n else float("nan"),
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
