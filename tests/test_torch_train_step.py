"""The port's ``make_train_step`` against the JAX package's, on the CPU, on
the same numpy-seeded parameters and batches: the step for each optimizer
with an lr change between epochs, ``multi_step`` (K steps in one call)
against K steps, the trainer's flush of a shorter group at a shape change,
and ``grad_step`` / ``apply_step`` under accumulation; for a
frame-dependent-transition model (config 2's kind, K1/K2 on the card) and a
shared-transition one (config 1's kind, K4/K5).  On the CPU the steps run
their eager code, the code the card's CUDA graphs capture
(``tests/test_torch_graphs_cuda.py`` holds the graphs to it there).  Also:
the masks the steps read are copied to the device once.

Tolerances are the trainer tests' (test_torch_trainer.py): parameters
rtol=1e-4, atol=1e-5 after the steps; losses rtol=1e-5; gradients (sums,
norms) rtol=1e-5, atol=1e-6, fp32 rounding in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu import data as jax_data
from asr_craft_tpu.models.crf import CrfConfig as JaxCrfConfig
from asr_craft_tpu.train import TrainConfig as JaxTrainConfig
from asr_craft_tpu.train import Trainer as JaxTrainer
from asr_craft_tpu.train import make_train_step as jax_make_train_step
from asr_craft_tpu.utils.logging import MetricsLogger
from asr_craft_tpu_torch import data
from asr_craft_tpu_torch.models import crf as crf_mod
from asr_craft_tpu_torch.models.crf import CrfConfig
from asr_craft_tpu_torch.train import (TrainConfig, Trainer, graphs,
                                       make_train_step)

L = 4
CONFIGS = {
    "fdt": dict(num_labels=L, feat_dim=L, num_states=2, trans_range=(0, L)),
    "shared": dict(num_labels=L, feat_dim=L),
}
OPTIMIZERS = {
    "sgd": dict(lr=0.3),
    "momentum": dict(lr=0.3, momentum=0.9),
    "adam": dict(lr=0.05, optimizer="adam"),
    "adagrad": dict(lr=0.2, optimizer="adagrad"),
}
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _params(cfg_kw, seed=0):
    """Numpy-seeded parameters (scale 0.2) for both packages."""
    shapes = {k: np.shape(v) for k, v in
              JaxCrfConfig(**cfg_kw).init_params().items()}
    rng = np.random.default_rng(seed)
    return {k: (0.2 * rng.normal(size=s)).astype(np.float32)
            for k, s in sorted(shapes.items())}


def _batch(seed, B=3, T=7, num_labels=L, feat_dim=L):
    r = np.random.default_rng(seed)
    return {"feats": r.normal(size=(B, T, feat_dim)).astype(np.float32),
            "labels": r.integers(0, num_labels, size=(B, T)).astype(np.int32),
            "lengths": np.asarray([T, T - 2, T - 3][:B], np.int32)}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree, grad=False):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(grad)
            for k, v in tree.items()}


def _close(got, want, what, **tol):
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), err_msg=f"{what} {k}",
                                   **tol)


def _both(name, opts):
    """The two packages' compiled steps and states from the same start."""
    cfg_kw = CONFIGS[name]
    p0 = _params(cfg_kw)
    jstep, jopt = jax_make_train_step(JaxCrfConfig(**cfg_kw),
                                      JaxTrainConfig(**opts))
    jp = _jax(p0)
    jstate = [jp, jopt.init(jp), jax.tree.map(jnp.copy, jp)]
    tstep, topt = make_train_step(CrfConfig(**cfg_kw), TrainConfig(**opts))
    tp = _torch(p0, grad=True)
    tstate = [tp, topt.init(tp), {k: v.detach().clone()
                                  for k, v in tp.items()}]
    return (jstep, jstate), (tstep, tstate)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_matches_jax(name, opt):
    """Four steps, the lr halved after two (an epoch's decay): the
    metrics of every step and the parameters after each."""
    opts = OPTIMIZERS[opt]
    (jstep, js), (tstep, ts) = _both(name, dict(opts, weight_avg=True,
                                                avg_decay=0.5))
    for i, lr in enumerate([opts["lr"]] * 2 + [opts["lr"] / 2] * 2):
        b = _batch(10 + i)
        *js, jm = jstep(*js, _jax(b), jnp.float32(lr))
        *ts, tm = tstep(*ts, _torch(b), lr)
        for k in ("loss", "mean_logZ"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), **GRAD_TOL)
        assert int(tm["frames"]) == int(jm["frames"])
        _close(ts[0], js[0], f"params after step {i}", **PARAM_TOL)
        _close(ts[2], js[2], f"average after step {i}", **PARAM_TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_multi_step_is_three_steps(name):
    """``multi_step`` on three batches gives the bits of three steps, and
    the JAX ``multi_step`` (``lax.scan``) within tolerance."""
    opts = dict(lr=0.05, optimizer="adam")
    (jstep, js), (tstep, ts) = _both(name, opts)
    _, (tstep2, ts2) = _both(name, opts)
    bs = [_batch(20 + i) for i in range(3)]
    *ts, tm = tstep.multi_step(*ts, [_torch(b) for b in bs], 0.05)
    seq = []
    for b in bs:
        *ts2, m = tstep2(*ts2, _torch(b), 0.05)
        seq.append(m)
    for k in tm:
        assert tm[k].shape == (3,)
        assert torch.equal(tm[k], torch.stack([m[k] for m in seq])), k
    for a, b in zip(graphs.leaves(ts), graphs.leaves(ts2)):
        assert torch.equal(a, b)
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *[_jax(b) for b in bs])
    *js, jm = jstep.multi_step(*js, stacked, jnp.float32(0.05))
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)
    _close(ts[0], js[0], "params", **PARAM_TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_accumulation_matches_jax(name):
    """Two ``grad_step``s sum the two batches' gradients (autograd's, and
    the JAX ``grad_step``'s); ``apply_step`` applies the sum as the JAX one
    does and zeroes the buffers in place."""
    opts = dict(lr=0.3, momentum=0.9, l2=0.01)
    (jstep, js), (tstep, ts) = _both(name, opts)
    cfg = CrfConfig(**CONFIGS[name])
    b1, b2 = _batch(1), _batch(2)
    jacc = jax.tree.map(jnp.zeros_like, js[0])
    tacc = {k: torch.zeros_like(v.detach()) for k, v in ts[0].items()}
    buffers = list(tacc.values())
    for b in (b1, b2):
        jacc, _ = jstep.grad_step(js[0], jacc, _jax(b))
        tacc, _ = tstep.grad_step(ts[0], tacc, _torch(b))
    want = {k: torch.zeros_like(v) for k, v in tacc.items()}
    for b in (b1, b2):
        tb = _torch(b)
        loss, _ = crf_mod.crf_loss(cfg, ts[0], tb["feats"], tb["labels"],
                                   tb["lengths"])
        for k, g in zip(ts[0], torch.autograd.grad(loss, list(
                ts[0].values()))):
            want[k] += g
    for k in tacc:
        np.testing.assert_allclose(tacc[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    _close(tacc, jacc, "grad sum", **GRAD_TOL)
    js = jstep.apply_step(*js, jacc, jnp.float32(0.3 / 2))
    ts = tstep.apply_step(*ts, tacc, 0.3 / 2)
    _close(ts[0], js[0], "params", **PARAM_TOL)
    assert all(a is b for a, b in zip(tacc.values(), buffers))
    assert all(not v.any() for v in tacc.values())


def _loaders():
    out = []
    for pkg in (jax_data, data):
        syn = pkg.SyntheticConfig(num_labels=L, feat_dim=L, noise=0.3,
                                  min_len=10, max_len=60, seed=1)
        feats, labels, _ = pkg.generate_corpus(syn, 20)
        out.append(pkg.UtteranceLoader(feats, labels, pkg.LoaderConfig(
            batch_size=4, buckets=(32, 64), shuffle=False)))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_groups_flush_at_a_shape_change(name):
    """``steps_per_call=4`` over two bucket shapes: the trainers flush a
    shorter group at the shape change and at the epoch's end, take a step
    a batch and land where the JAX trainer does (and where one step a call
    lands, bit for bit)."""
    jl, tl = _loaders()
    n_batches = sum(1 for _ in tl.epoch_batches(0))
    shapes = [b["feats"].shape for b in tl.epoch_batches(0)]
    assert len(set(shapes)) == 2 and n_batches % 4
    quiet = MetricsLogger(quiet=True)
    opts = dict(lr=0.3, momentum=0.9, log_every=1000)
    j = JaxTrainer(JaxCrfConfig(**CONFIGS[name]),
                   JaxTrainConfig(steps_per_call=4, **opts), logger=quiet)
    t = Trainer(CrfConfig(**CONFIGS[name]),
                TrainConfig(steps_per_call=4, prefetch=0, **opts),
                logger=quiet, device="cpu")
    t1 = Trainer(CrfConfig(**CONFIGS[name]), TrainConfig(prefetch=0, **opts),
                 logger=quiet, device="cpu")
    rj, rt, r1 = j.train_epoch(jl), t.train_epoch(tl), t1.train_epoch(tl)
    assert t.step == j.step == t1.step == n_batches
    assert rt["frames"] == rj["frames"]
    np.testing.assert_allclose(rt["mean_loss"], rj["mean_loss"], rtol=1e-5)
    assert rt["mean_loss"] == r1["mean_loss"]
    for k in t.params:
        assert torch.equal(t.params[k], t1.params[k]), k
    _close(t.params, j.params, "params", **PARAM_TOL)


def test_masks_are_copied_to_the_device_once(monkeypatch):
    """The masks of the fdt planes, the n-state segmental pooling and the
    topology penalties are cached per device: a second call returns the
    same tensor, and no call after the first copies from the host."""
    from asr_craft_tpu_torch.models import segmental as seg_mod
    from asr_craft_tpu_torch.ops import fdt, segmental_stream as ss
    cpu = torch.device("cpu")
    assert fdt.adv_mask(6, 3, cpu) is fdt.adv_mask(6, 3, cpu)
    assert ss.pool_matrices_on(5, 2, True, cpu) is \
        ss.pool_matrices_on(5, 2, True, cpu)
    assert ss.cuts_on(5, 2, cpu) is ss.cuts_on(5, 2, cpu)

    cfg = CrfConfig(**CONFIGS["fdt"])
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.1)
    shared = CrfConfig(num_labels=2, feat_dim=4, num_states=2)
    shared_params = shared.init_params(torch.Generator().manual_seed(0), 0.1)
    scfg = seg_mod.SegCrfConfig(num_labels=3, feat_dim=4, max_dur=5,
                                num_states=2)
    sparams = scfg.init_params(torch.Generator().manual_seed(0), 0.1)
    sparams = {k: v.requires_grad_(True) for k, v in sparams.items()}
    feats = torch.randn(2, 6, 4, generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([6, 4], dtype=torch.int32)

    def every_call():
        fdt.factored_planes(params, feats, 4, 2, (0, 4), (0, 4))
        state, _ = crf_mod.potentials(shared, shared_params, feats)
        crf_mod.apply_boundaries(shared, state, lengths)
        seg_mod.seg_potentials(scfg, sparams, feats)
        seg_mod.scrf_decode(scfg, sparams, feats, lengths)
        logZ = seg_mod.scrf_log_partition_fused(scfg, sparams, feats,
                                                lengths)
        logZ.sum().backward()

    every_call()

    def no_host_copy(*a, **k):
        raise AssertionError("a copy from the host inside a step")
    monkeypatch.setattr(torch, "from_numpy", no_host_copy)
    every_call()


def test_graphed_runs_eagerly_on_the_cpu_and_when_disabled():
    """A Graphed function runs its eager code on CPU tensors and inside
    ``graphs.disabled()`` (the contexts nest); it caches nothing there."""
    calls = []

    def fn(bound, inputs):
        calls.append(1)
        return {"y": bound["w"] * inputs["x"]}

    g = graphs.Graphed(fn, name="test")
    w, x = torch.tensor(2.0), torch.tensor([1.0, 3.0])
    assert torch.equal(g({"w": w}, {"x": x})["y"], torch.tensor([2.0, 6.0]))
    assert graphs.enabled()
    with graphs.disabled():
        with graphs.disabled():
            assert not graphs.enabled()
        assert not graphs.enabled()
        g({"w": w}, {"x": x})
    assert graphs.enabled() and len(calls) == 2 and len(g) == 0
    assert not graphs.on_cuda({"w": w}, [x, None, 3])
