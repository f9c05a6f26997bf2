"""The port's Trainer against the JAX package's Trainer: two epochs on the
same loader batches from the same zero init, for each optimizer, compared
on the parameters, the epochs' mean losses and the CV metrics.  The
training options, exact checkpoint resume and the options still to port
are test_torch_trainer_options.py (same helpers; one file each keeps both
short, as every option compiles the JAX steps anew).

Tolerances: parameters rtol=1e-4, atol=1e-5 after two epochs of three steps
(gradients agree to fp32 rounding, ~1e-6 relative, and each optimizer
update is a smooth function of them); the mean loss rtol=1e-5.
"""
import numpy as np
import pytest

from asr_craft_tpu import data
from asr_craft_tpu.models.crf import CrfConfig as JaxCrfConfig
from asr_craft_tpu.train import TrainConfig as JaxTrainConfig
from asr_craft_tpu.train import Trainer as JaxTrainer
from asr_craft_tpu.utils.logging import MetricsLogger
from asr_craft_tpu_torch.models.crf import CrfConfig
from asr_craft_tpu_torch.train import TrainConfig, Trainer

L, NS = 4, 2
CFG = dict(num_labels=L, feat_dim=L, num_states=NS, trans_range=(0, L))
OPTIMIZERS = {
    "sgd": dict(lr=0.3),
    "momentum": dict(lr=0.3, momentum=0.9),
    "adam": dict(lr=0.05, optimizer="adam"),
    "adagrad": dict(lr=0.2, optimizer="adagrad"),
}
OPTIONS = {
    "l2": dict(lr=0.3, l2=0.01, lr_decay=0.5),
    "weight_avg": dict(lr=0.3, weight_avg=True, avg_decay=0.5),
    "accum_steps": dict(lr=0.3, accum_steps=2),
    "steps_per_call": dict(lr=0.3, steps_per_call=2),
}


def _loaders(seed=0, n=12):
    scfg = data.SyntheticConfig(num_labels=L, feat_dim=L, noise=0.3,
                                min_len=16, max_len=40, seed=seed, min_dur=2)
    feats, labels, phones = data.generate_corpus(scfg, n)
    lcfg = data.LoaderConfig(batch_size=4, buckets=(64,), seed=seed)
    return (data.UtteranceLoader(feats, labels, lcfg),
            data.UtteranceLoader(feats, labels, data.LoaderConfig(
                batch_size=4, buckets=(64,), shuffle=False)),
            {i: p for i, p in enumerate(phones)})


def _trainers(**opts):
    quiet = MetricsLogger(quiet=True)
    j = JaxTrainer(JaxCrfConfig(**CFG), JaxTrainConfig(log_every=1000,
                                                       **opts), logger=quiet)
    t = Trainer(CrfConfig(**CFG), TrainConfig(log_every=1000, prefetch=0,
                                              **opts), logger=quiet)
    return j, t


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_epoch_matches_jax_trainer(name):
    _epoch_matches(OPTIMIZERS[name])


def _epoch_matches(opts):
    (loader_j, cv, refs), (loader_t, _, _) = _loaders(), _loaders()
    j, t = _trainers(**opts)
    for _ in range(2):                   # the second epoch decays the lr
        rj = j.train_epoch(loader_j)
        rt = t.train_epoch(loader_t)
        np.testing.assert_allclose(rt["mean_loss"], rj["mean_loss"],
                                   rtol=1e-5)
        assert rt["frames"] == rj["frames"]
    for k, v in t.inference_params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(
            j.inference_params[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    ej, et = j.evaluate(cv, refs), t.evaluate(cv, refs)
    assert et["per"] == ej["per"]
    np.testing.assert_allclose(et["frame_accuracy"], ej["frame_accuracy"])
    np.testing.assert_allclose(et["cv_loss"], ej["cv_loss"], rtol=1e-5)
