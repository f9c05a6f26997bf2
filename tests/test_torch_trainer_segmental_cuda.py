"""The segmental CRF's ``Trainer`` on the card, at config 4's widths (48
phones, 144 dims, segments of 1 to 16 frames): ``multi_step`` replays one
CUDA graph a batch shape and never runs eagerly; it agrees with the
float64 reference (``crfbench/reference/scrf_train.py``); an epoch writes
its ``.npz`` weights and the CV pass runs through its graph; the kernels'
design counters.  And the linear-chain trainer's graphs keep the node
counts they had before the trainer learned the segmental model.

Marked ``cuda``; on a host with an NVIDIA GPU, from the repository root:

    python -m pytest --noconftest -m cuda \
        tests/test_torch_trainer_segmental_cuda.py -q

Tolerances against the float64 reference: the port's step is float32 (its
frame scores IEEE fp32 at ``highest``, its recursions fp32, K11's
contraction 3xTF32), over T=64 lattices of 16 durations: losses rtol 1e-5,
gradient norms and parameters rtol 1e-4 (the benchmark's own limits, set
at T=512 from the card's readings, are tighter on the loss).
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu_torch import flagship
from asr_craft_tpu_torch.models import weights as weights_mod
from asr_craft_tpu_torch.train import TrainConfig, Trainer
from asr_craft_tpu_torch.utils import diagnostics
from asr_craft_tpu_torch.utils.logging import MetricsLogger
from crfbench.modes import scrf_train

pytestmark = pytest.mark.cuda
QUIET = MetricsLogger(quiet=True)
LR = 0.05


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the segmental "
                    "kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batches(cfg, B, T, n, seed, dev):
    """``n`` batches of N(0, 1) frames, lengths from T / 4 to T (the last
    row empty) and labels in runs of 3-12 frames of distinct phones."""
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(T // 4, T + 1, size=B)
        lengths[-1] = 0
        feats = torch.randn(B, T, cfg.feat_dim, generator=g)
        feats *= torch.arange(T)[None, :, None] < torch.from_numpy(
            lengths)[:, None, None]
        labels = scrf_train.segment_labels(rng, lengths, T, (3, 12),
                                           cfg.num_labels, cfg.max_dur)
        out.append({"feats": feats.to(dev),
                    "labels": torch.from_numpy(labels).to(dev),
                    "lengths": torch.from_numpy(lengths.astype(np.int32))
                    .to(dev)})
    return out


def _trainer(cfg, dev, **tc):
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.05, dev)
    return Trainer(cfg, TrainConfig(lr=LR, prefetch=0, **tc), params=params,
                   logger=QUIET)


def test_multi_step_replays_one_graph_a_shape(dev):
    cfg = flagship.scrf()
    diagnostics.reset()
    tr = _trainer(cfg, dev, steps_per_call=4)
    for T in (64, 128):
        bs = _batches(cfg, 16, T, 4, T, dev)
        for _ in range(3):
            m = tr.multi_step(bs, LR)
    assert bool(torch.isfinite(m["loss"]).all())
    c = diagnostics.summary()["counters"]
    assert c["graph.captures[multi_step]"] == 2
    assert c["graph.replays[multi_step]"] == 4
    assert c.get("graph.eager_calls[multi_step]", 0) == 0
    # config 4 takes K9's and K10's own frame and the 16-duration xi pass
    assert c["kernels.segmental_forward[own]"] > 0
    assert c["kernels.segmental_backward[own]"] > 0
    assert c["kernels.segmental_grad[16]"] > 0
    assert not any(k.endswith(("[three_barrier]", "[deep]")) for k in c)
    diagnostics.reset()


def test_multi_step_agrees_with_the_reference(dev):
    cfg = flagship.scrf()
    tr = _trainer(cfg, dev, steps_per_call=2)
    p0 = {k: v.detach().clone() for k, v in tr.params.items()}
    bs = _batches(cfg, 4, 64, 2, 7, dev)
    m = tr.multi_step(bs, LR)
    want = scrf_train.reference_train(p0, bs, LR, cfg.max_dur, dev)
    np.testing.assert_allclose(m["loss"].cpu().double().numpy(),
                               want["losses"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].cpu().double().numpy(),
                               want["grad_norms"], rtol=1e-4)
    for k, p in tr.params.items():
        d_got = (p.detach().double() - p0[k].double()).norm()
        d_want = (want["params"][-1][k] - p0[k].double()).norm()
        assert float(abs(d_got - d_want)) <= 1e-4 * float(d_want), k


class _Loader:
    def __init__(self, batches):
        self.batches = [{k: v.cpu().numpy() for k, v in b.items()}
                        for b in batches]

    def epoch_batches(self, epoch):
        return iter(self.batches)


def test_an_epoch_and_its_cv_pass_run_through_the_graphs(dev, tmp_path):
    cfg = flagship.scrf()
    diagnostics.reset()
    tr = _trainer(cfg, dev, steps_per_call=2, out_dir=str(tmp_path))
    bs = _batches(cfg, 8, 64, 4, 3, dev)
    tr.train_epoch(_Loader(bs))
    tr.train_epoch(_Loader(bs))
    got = tr.evaluate(_Loader(bs[:2]))
    tr.evaluate(_Loader(bs[:2]))
    c = diagnostics.summary()["counters"]
    assert c["graph.replays[multi_step]"] == 3     # a capture, 3 replays
    assert c["graph.replays[eval step]"] == 3
    assert not [k for k in c if k.startswith("graph.eager_calls")]
    assert 0.0 <= got["frame_accuracy"] <= 1.0
    assert np.isfinite(got["cv_loss"])
    saved = weights_mod.load_npz(tmp_path / "weights.i1.npz", dev)
    for k, p in tr.params.items():
        assert torch.equal(saved[k], p.detach()), k
    diagnostics.reset()


# the node counts of the linear-chain trainer's graphs (B=16, T=128, four
# batches a multi_step), read on an H100 (torch 2.11.0+cu128) from the
# trainer before it took the segmental model, and the same after
LINEAR_NODES = {
    name: {f"graph.nodes[{g}#0]": n for g, n in zip(
        ("train step", "multi_step", "eval step"), counts)}
    for name, counts in (("config2", (150, 604, 87)),
                         ("config1", (56, 228, 30)),
                         ("config5", (76, 308, 48)))}


@pytest.mark.parametrize("name", sorted(LINEAR_NODES))
def test_the_linear_chain_graphs_keep_their_node_counts(dev, name):
    mk = {"config2": flagship.flagship, "config1": flagship.timit_mono,
          "config5": flagship.swbd}[name]
    cfg = mk()
    diagnostics.reset()
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.01, dev)
    tr = Trainer(cfg, TrainConfig(lr=0.3), params=params, logger=QUIET)
    bs = [flagship.tiny_batch(cfg, 16, 128, s, dev) for s in range(4)]
    tr.train_step(bs[0], 0.3)
    tr.multi_step(bs, 0.3)
    tr.eval_fn(tr.params, bs[0])
    c = diagnostics.summary()["counters"]
    got = {k: v for k, v in c.items() if k.startswith("graph.nodes[")}
    assert got == LINEAR_NODES[name]
    diagnostics.reset()
