"""The port's factored Viterbi (asr_craft_tpu_torch.ops.fdt and the plain
version of the K3 kernel) against the JAX package's XLA decode, on
identical numpy-seeded inputs (the Pallas-kernel comparisons are in
test_torch_fdt_viterbi_pallas.py, which shares this file's helpers).

Paths must be equal.  Scores are allclose at rtol=1e-5, atol=1e-4: the
planes are fp32 matmuls whose sums run in another order in PyTorch than in
XLA (and through the packed Wall in the kernel's plain version), so scores
differ in the last bits while the decisions do not at these sizes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.kernels.fdt_pallas import build_wall as jax_build_wall
from asr_craft_tpu.kernels.fdt_pallas import fdt_viterbi_pallas
from asr_craft_tpu.models.feature_map import FeatureMapConfig as JaxFmap
from asr_craft_tpu.ops import fdt as jfdt
from asr_craft_tpu_torch.kernels.fdt_viterbi import (build_wall,
                                                     fdt_viterbi_wall_torch,
                                                     wall_planes)
from asr_craft_tpu_torch.models.feature_map import FeatureMapConfig
from asr_craft_tpu_torch.ops import fdt
from asr_craft_tpu_torch.ops.semiring import NEG_INF

TOL = dict(rtol=1e-5, atol=1e-4)
MODES = {"exact": (None, None), "threshold": (2.0, None),
         "topk": (None, 4), "threshold+topk": (1.0, 3)}


def _problem(seed, P, ns, B=3, T=17, D=12, scale=0.3, integer=False):
    """numpy params / feats / ragged lengths (one row of length 0)."""
    rng = np.random.default_rng(seed)
    kw = dict(feat_dim=D, num_expanded=P * ns, state_range=(0, D - 2),
              trans_range=(2, D))
    jcfg, tcfg = JaxFmap(**kw), FeatureMapConfig(**kw)
    params = {k: rng.normal(size=s, scale=scale).astype(np.float32)
              for k, s in jcfg.param_shapes().items()}
    feats = rng.normal(size=(B, T, D)).astype(np.float32)
    if integer:   # exact fp32 arithmetic: ties everywhere, in any order
        params = {k: np.round(v / scale) for k, v in params.items()}
        feats = np.round(feats)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = T, 0
    return jcfg, tcfg, params, feats, lengths


def _torch(params, feats, lengths):
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            torch.from_numpy(feats), torch.from_numpy(lengths))


def _jax_xla(jcfg, params, feats, lengths, ns, thr, bw):
    planes = jfdt.factored_planes(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(feats),
        jcfg.num_expanded, ns, jcfg.state_range, jcfg.trans_range)
    paths, scores = jfdt.fdt_viterbi(*planes, jnp.asarray(lengths), ns, True,
                                     beam_width=bw, beam_threshold=thr)
    return np.asarray(paths), np.asarray(scores)


def _jax_pallas(jcfg, params, feats, lengths, ns, thr, bw):
    Wall, u0, u1, dims = jax_build_wall(
        {k: jnp.asarray(v) for k, v in params.items()}, jcfg, ns)
    paths, scores = fdt_viterbi_pallas(
        Wall, jnp.asarray(feats), jnp.asarray(lengths), u0=u0, u1=u1, ns=ns,
        P=dims["P"], P8=dims["P8"], boundaries=True, beam_threshold=thr,
        beam_width=bw, interpret=True)
    return np.asarray(paths), np.asarray(scores)


def _port_ops(tcfg, params, feats, lengths, ns, thr, bw):
    tp, tf, tl = _torch(params, feats, lengths)
    planes = fdt.factored_planes(tp, tf, tcfg.num_expanded, ns,
                                 tcfg.state_range, tcfg.trans_range)
    paths, scores = fdt.fdt_viterbi(*planes, tl, ns, True, bw, thr)
    return paths.numpy(), scores.numpy()


def _port_wall(tcfg, params, feats, lengths, ns, thr, bw):
    tp, tf, tl = _torch(params, feats, lengths)
    Wall, u0, u1, dims = build_wall(tp, tcfg, ns)
    paths, scores = fdt_viterbi_wall_torch(
        Wall, tf, tl, u0=u0, u1=u1, ns=ns, P=dims["P"], boundaries=True,
        beam_threshold=thr, beam_width=bw)
    return paths.numpy(), scores.numpy()


def _assert_same(got, ref, msg):
    np.testing.assert_array_equal(got[0], ref[0], err_msg=msg)
    np.testing.assert_allclose(got[1], ref[1], err_msg=msg, **TOL)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("P,ns", [(5, 1), (5, 3), (8, 1), (8, 3)])
def test_ops_fdt_viterbi_matches_jax_xla(P, ns, mode):
    thr, bw = MODES[mode]
    jcfg, tcfg, params, feats, lengths = _problem(P * 10 + ns, P, ns)
    _assert_same(_port_ops(tcfg, params, feats, lengths, ns, thr, bw),
                 _jax_xla(jcfg, params, feats, lengths, ns, thr, bw), mode)


@pytest.mark.parametrize("ns", [1, 3])
def test_factored_and_wall_planes_match_jax(ns):
    P = 6
    jcfg, tcfg, params, feats, lengths = _problem(3, P, ns)
    ref = jfdt.factored_planes(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(feats),
        jcfg.num_expanded, ns, jcfg.state_range, jcfg.trans_range)
    tp, tf, _ = _torch(params, feats, lengths)
    got = fdt.factored_planes(tp, tf, tcfg.num_expanded, ns,
                              tcfg.state_range, tcfg.trans_range)
    Wall, u0, u1, dims = build_wall(tp, tcfg, ns)
    assert tuple(Wall.shape) == (3 * P * ns + P * P, u1 - u0 + 1)
    via_wall = wall_planes(Wall, tf, u0, u1, ns, P)
    for name, r, g, w in zip(("state", "self", "adv", "cross"), ref, got,
                             via_wall):
        if r is None:
            assert g is None and w is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)
        if name == "adv":
            # the Wall keeps illegal advance slots at 0 (never read); the
            # factored planes mark them NEG_INF
            legal = np.asarray(r) > NEG_INF / 2
            np.testing.assert_allclose(w.numpy()[legal], np.asarray(r)[legal],
                                       err_msg=name, **TOL)
        else:
            np.testing.assert_allclose(w.numpy(), np.asarray(r),
                                       err_msg=name, **TOL)


def _kth_columns(rng, rows=64):
    """The adversarial columns of tests/kernels/test_fdt_pallas.py::
    test_kth_col_value_exact_adversarial, as (columns, rows)."""
    base = rng.normal(size=(rows,)).astype(np.float32)
    tied = base.copy()
    tied[1] = np.nextafter(tied[0], np.float32(np.inf))
    tied[2] = tied[0]
    spread = base.copy()
    spread[10:30] = -2.0e5
    spread[30:40] = NEG_INF
    return np.stack([base, tied, spread, np.full(rows, 3.25, np.float32),
                     np.linspace(-1e6, 1e6, rows, dtype=np.float32)])


@pytest.mark.parametrize("K", [1, 2, 5, 32, 63])
def test_topk_prune_exact_adversarial(K):
    """prune keeps exactly {delta >= K-th largest} as lax.top_k defines it,
    and so does the CUDA kernel's rule "fewer than K values are strictly
    greater" (written out here in torch) — bit for bit."""
    cols = _kth_columns(np.random.default_rng(0))
    kth = np.asarray(jax.lax.top_k(jnp.asarray(cols), K)[0])[:, -1:]
    want = np.where(cols >= kth, cols, np.float32(NEG_INF))
    delta = torch.from_numpy(cols)
    got = fdt.prune(delta, None, K).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    greater = (delta[:, None, :] > delta[:, :, None]).sum(-1)
    rule = torch.where(greater < K, delta, NEG_INF).numpy()
    np.testing.assert_array_equal(rule.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("ns", [1, 3])
def test_path_score_of_decoded_path_is_its_score(ns):
    """path_score (the near-tie rule's rescoring) gives back the decode's
    own score for its own path, rows of length 0 aside (their score is the
    initial frame's max, their path empty)."""
    _, tcfg, params, feats, lengths = _problem(11, 5, ns)
    tp, tf, tl = _torch(params, feats, lengths)
    planes = fdt.factored_planes(tp, tf, tcfg.num_expanded, ns,
                                 tcfg.state_range, tcfg.trans_range)
    paths, scores = fdt.fdt_viterbi(*planes, tl, ns)
    rescored = fdt.path_score(*planes, paths, tl, ns)
    live = tl > 0
    np.testing.assert_allclose(rescored[live].numpy(), scores[live].numpy(),
                               **TOL)
    assert float(rescored[~live].abs().max()) == 0.0
