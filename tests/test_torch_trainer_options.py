"""The port's Trainer against the JAX package's Trainer for each training
option (``l2`` with an lr decay, Polyak averaging, gradient accumulation,
``steps_per_call``), as test_torch_trainer.py does for the optimizers;
exact checkpoint resume; ``lbfgs`` and ``profile_dir``.
"""
import pytest
import torch

from asr_craft_tpu.utils.logging import MetricsLogger
from asr_craft_tpu_torch.models.crf import CrfConfig
from asr_craft_tpu_torch.train import (TrainConfig, Trainer, load_checkpoint,
                                       save_checkpoint)
from tests.test_torch_trainer import CFG, OPTIONS, _epoch_matches, _loaders


@pytest.mark.parametrize("name", list(OPTIONS))
def test_epoch_matches_jax_trainer(name):
    _epoch_matches(OPTIONS[name])


@pytest.mark.parametrize("opts", [dict(lr=0.3, momentum=0.9),
                                  dict(lr=0.05, optimizer="adam",
                                       weight_avg=True)],
                         ids=["momentum", "adam+avg"])
def test_checkpoint_resume_is_exact(tmp_path, opts):
    """Kill-and-resume continuity: a trainer restored from a checkpoint
    continues exactly like the one that wrote it."""
    loader, _, _ = _loaders(seed=4)
    quiet = MetricsLogger(quiet=True)
    cfg, tc = CrfConfig(**CFG), TrainConfig(log_every=1000, **opts)
    t1 = Trainer(cfg, tc, logger=quiet, device="cpu")
    t1.train_epoch(loader)
    save_checkpoint(str(tmp_path / "ckpt"), t1, loader.state())
    save_checkpoint(str(tmp_path / "ckpt"), t1, loader.state())  # replace
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt"]

    t2 = Trainer(cfg, tc, logger=quiet, device="cpu")
    lstate = load_checkpoint(str(tmp_path / "ckpt"), t2)
    assert (t2.step, t2.epoch) == (t1.step, t1.epoch)
    loader2, _, _ = _loaders(seed=4)
    loader2.restore(lstate)
    r1, r2 = t1.train_epoch(loader), t2.train_epoch(loader2)
    assert r1["mean_loss"] == r2["mean_loss"]
    for k in t1.params:
        assert torch.equal(t1.params[k], t2.params[k]), k
        assert torch.equal(t1.avg_params[k], t2.avg_params[k]), k


def test_unported_options_raise(tmp_path):
    """``lbfgs``, which raised until it was ported, gives the JAX Trainer's
    epochs (losses, parameters, CV PER), at an lr where its steps stay
    stable (at 0.3 the sixth step of both trainers jumps to a loss of ~13,
    where fp32 rounding no longer agrees); ``profile_dir``, which raised
    until the utilities were ported, makes ``fit`` write a trace."""
    _epoch_matches(dict(lr=0.05, optimizer="lbfgs"))
    t = Trainer(CrfConfig(**CFG),
                TrainConfig(profile_dir=str(tmp_path / "prof"), epochs=1),
                logger=MetricsLogger(quiet=True), device="cpu")
    t.fit(_loaders()[0])
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
