"""The plain references of crfbench/reference/ against the port's plain CPU
path, at a small size: the CRF's loss and gradient (frame-dependent and
shared transitions), the best path's score and a path's score, and the
segmental CRF's best score and a segmentation's score.

    python -m pytest crfbench/tests -q
"""
import pytest
import torch

from crfbench import gen
from crfbench.reference import crf as ref_crf
from crfbench.reference import scrf as ref_scrf

SEED = 2**31 + 77


def _batch(D, P, B=3, T=20, lo=12, run=(3, 6)):
    traffic = {"batch": B, "utterances": B, "buckets": [T],
               "lengths": {"dist": "uniform", "lo": lo, "hi": T}}
    plan = gen.plan_batches(traffic, SEED)
    return gen.make_batches(plan, D, P, run, SEED, "cpu")[0]


CONFIGS = {
    "fdt_ns3": dict(num_labels=3, feat_dim=8, num_states=3,
                    trans_range=(0, 8)),
    "fdt_ns1": dict(num_labels=4, feat_dim=6, num_states=1,
                    trans_range=(2, 6)),
    "shared_ns3": dict(num_labels=3, feat_dim=7, num_states=3),
    "shared_ns1": dict(num_labels=5, feat_dim=6),
}


def _model(name):
    from asr_craft_tpu_torch.models.crf import CrfConfig
    cfg = CrfConfig(**CONFIGS[name])
    params = gen.init_params(cfg.fmap.param_shapes(), 0.4, SEED, "cpu")
    return cfg, params


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_gradient_match_the_port(name):
    from asr_craft_tpu_torch.models.crf import crf_loss
    cfg, params = _model(name)
    b = _batch(cfg.feat_dim, cfg.num_labels)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, _ = crf_loss(cfg, leaves, b["feats"], b["labels"], b["lengths"])
    g_port = torch.autograd.grad(loss, list(leaves.values()))
    ref_leaves = {k: v.double().requires_grad_(True)
                  for k, v in params.items()}
    nll, _, frames = ref_crf.loss(ref_leaves, b["feats"], b["labels"],
                                  b["lengths"], cfg.num_states, None,
                                  cfg.trans_range)
    g_ref = torch.autograd.grad(nll / frames, list(ref_leaves.values()))
    assert float(loss.detach()) == pytest.approx(float(nll.detach() / frames),
                                                rel=1e-5)
    for k, a, r in zip(leaves, g_port, g_ref):
        assert torch.allclose(a.double(), r, rtol=1e-4, atol=1e-6), k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_path_scores_match_the_port_decode(name):
    from asr_craft_tpu_torch.models.crf import decode
    cfg, params = _model(name)
    b = _batch(cfg.feat_dim, cfg.num_labels)
    _, paths, scores = decode(cfg, params, b["feats"], b["lengths"])
    args = (cfg.num_states, None, cfg.trans_range)
    best = ref_crf.best_scores(params, b["feats"], b["lengths"], *args)
    mine = ref_crf.path_scores(params, b["feats"], paths, b["lengths"],
                               *args)
    assert torch.allclose(best, scores.double(), rtol=1e-5)
    assert torch.allclose(mine, best, rtol=1e-5)


def test_an_illegal_path_scores_the_semiring_zero():
    cfg, params = _model("fdt_ns3")
    b = _batch(cfg.feat_dim, cfg.num_labels)
    paths = torch.zeros((3, 20), dtype=torch.int32)
    paths[:, 1:] = 1                         # advance, then never leave
    mine = ref_crf.path_scores(params, b["feats"], paths, b["lengths"],
                               cfg.num_states, None, cfg.trans_range)
    assert (mine < -1e29).all()


def _seg_model():
    from asr_craft_tpu_torch.models.segmental import SegCrfConfig
    cfg = SegCrfConfig(num_labels=4, feat_dim=6, max_dur=5)
    params = gen.init_params(cfg.param_shapes(), 0.4, SEED, "cpu")
    return cfg, params


def test_segmental_scores_match_the_port_decode():
    from asr_craft_tpu_torch.models.segmental import scrf_decode
    cfg, params = _seg_model()
    b = _batch(cfg.feat_dim, cfg.num_labels, B=4, T=24, lo=10)
    starts, labels, n, scores = scrf_decode(cfg, params, b["feats"],
                                            b["lengths"])
    best = ref_scrf.best_scores(params, b["feats"], b["lengths"],
                                cfg.max_dur)
    mine = ref_scrf.segmentation_scores(params, b["feats"], starts, labels,
                                        n, b["lengths"], cfg.max_dur)
    assert torch.allclose(best, scores.double(), rtol=1e-5)
    assert torch.allclose(mine, best, rtol=1e-5)


def test_a_segmentation_that_does_not_tile_scores_the_semiring_zero():
    from asr_craft_tpu_torch.models.segmental import scrf_decode
    cfg, params = _seg_model()
    b = _batch(cfg.feat_dim, cfg.num_labels, B=4, T=24, lo=10)
    starts, labels, n, _ = scrf_decode(cfg, params, b["feats"],
                                       b["lengths"])
    one = ref_scrf.segmentation_scores(params, b["feats"], starts, labels,
                                       torch.ones_like(n), b["lengths"],
                                       cfg.max_dur)      # longer than Dmax
    late = starts.clone()
    late[:, 0] = 1
    moved = ref_scrf.segmentation_scores(params, b["feats"], late, labels,
                                         n, b["lengths"], cfg.max_dur)
    assert (moved < -1e29).all()
    assert (one < -1e29).all()
