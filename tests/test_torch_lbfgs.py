"""The port's ``lbfgs`` optimizer against optax, the JAX package's: the
``Optimizer`` update against ``optax.chain(optax.scale_by_lbfgs(),
optax.scale(-lr))`` (``l2``: ``optax.add_decayed_weights`` first, as
``asr_craft_tpu.train.trainer.make_optimizer`` chains it) on the same
seeded parameters and gradient sequence, 12 steps, so that the ring of 10
pairs wraps; the port's Trainer and train CLI at ``--optimizer lbfgs``
against the JAX ones; ``multi_step`` bit-equal to the same steps run one by
one.

Tolerances: the parameters after 12 steps within rtol 1e-4, atol 1e-5 of
optax's.  Each step's direction goes through 20 inner products over the
whole tree, summed in another order than XLA's, and its scale divides two
of them, so fp32 rounding grows from step to step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asr_craft_tpu_torch.train import TrainConfig
from asr_craft_tpu_torch.train.trainer import LBFGS_MEMORY, make_optimizer

SHAPES = {"w_state": (6, 4), "b_state": (4,), "w_trans": (3, 4, 4)}
STEPS = 12


def _sequence(seed, steps=STEPS):
    """Parameters and a gradient sequence: each gradient a fixed quadratic
    bowl's (so that <du, dw> > 0 and the memory is used) plus noise."""
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    curv = {k: rng.uniform(0.5, 2.0, size=s).astype(np.float32)
            for k, s in SHAPES.items()}
    noise = [{k: 0.01 * rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, curv, noise


@pytest.mark.parametrize("l2", [0.0, 0.01])
def test_optimizer_matches_optax(l2):
    lr = 0.7
    params, curv, noise = _sequence(int(l2 * 100))
    opt = optax.chain(optax.scale_by_lbfgs(), optax.scale(-1.0))
    if l2:
        opt = optax.chain(optax.add_decayed_weights(l2), opt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    update = jax.jit(opt.update)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    port = make_optimizer(TrainConfig(optimizer="lbfgs", lr=1.0, l2=l2))
    tstate = port.init(tp)
    for step in range(STEPS):
        jg = {k: curv[k] * jp[k] + noise[step][k] for k in jp}
        tg = {k: torch.from_numpy(curv[k]) * tp[k]
              + torch.from_numpy(noise[step][k]) for k in tp}
        up, state = update(jg, state, jp)
        jp = {k: jp[k] + up[k] * lr for k in jp}      # make_train_step's
        port.update(tg, tstate, tp, lr)
    assert int(tstate["count"]) == STEPS > LBFGS_MEMORY
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    # the memory itself: the same pairs in the same ring slots
    lb = state[1][0] if l2 else state[0]
    np.testing.assert_allclose(tstate["rho"].numpy(),
                               np.asarray(lb.weights_memory), rtol=1e-4)
    for k in params:
        for ours, theirs in (("dw", lb.diff_params_memory),
                             ("du", lb.diff_updates_memory)):
            np.testing.assert_allclose(tstate[ours][k].numpy(),
                                       np.asarray(theirs[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{ours} {k}")


def _step_setup(precision="highest"):
    from asr_craft_tpu_torch.flagship import tiny_batch
    from asr_craft_tpu_torch.models.crf import CrfConfig
    from asr_craft_tpu_torch.train import make_train_step
    cfg = CrfConfig(num_labels=4, feat_dim=6, num_states=3,
                    trans_range=(0, 6), precision=precision)
    step, opt = make_train_step(cfg, TrainConfig(optimizer="lbfgs",
                                                 l2=0.01))
    params = {k: v.requires_grad_(True) for k, v in cfg.init_params(
        torch.Generator().manual_seed(0), 0.1).items()}
    batches = [tiny_batch(cfg, 3, 12, seed) for seed in range(4)]
    return cfg, step, opt, params, batches


def test_multi_step_equals_single_steps():
    """Four lbfgs steps in one ``multi_step`` call give the bits of the
    same four steps run one by one: parameters, the whole optimizer state
    (memory, weights, count) and every metric."""
    _, step, opt, params, batches = _step_setup()
    runs = []
    for multi in (False, True):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        state, avg = opt.init(p), {k: v.detach().clone()
                                   for k, v in p.items()}
        if multi:
            m = step.multi_step(p, state, avg, batches, 0.05)[3]
        else:
            ms = [step(p, state, avg, b, 0.05)[3] for b in batches]
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
        runs.append((p, state, m))
    (p1, s1, m1), (p2, s2, m2) = runs
    assert int(s1["count"]) == 4
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    for name in ("dw", "du", "params", "updates"):
        for k in p1:
            assert torch.equal(s1[name][k], s2[name][k]), (name, k)
    assert torch.equal(s1["rho"], s2["rho"])
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k


def test_precision_is_a_key_of_the_step_graphs():
    """The loss's precision is part of every graph key of the compiled
    step: the same tensors and batch under a loss function of another
    precision make another key, so a bf16x3 step never replays a highest
    graph (the card test in test_torch_graphs_cuda.py captures both)."""
    from asr_craft_tpu_torch.train import graphs
    from asr_craft_tpu_torch.train.trainer import crf_loss_fn
    cfg, step, opt, params, batches = _step_setup()
    state = opt.init(params)
    lr = step._lr_tensor(0.05, params)
    keys = {}
    for precision in ("highest", "bf16x3", "default"):
        step.loss_fn = crf_loss_fn(cfg.__class__(**{
            **cfg.__dict__, "precision": precision}))
        bound = step._bound(params, state, params, lr)
        assert bound[-1] == precision
        keys[precision] = graphs._key(bound, batches[0])
    assert len(set(keys.values())) == 3
