"""The port's time-sharded decode (``parallel.timeshard``, layout (i): N
chunks on one device) against the JAX functions on the 8-device CPU mesh
that tests/conftest.py forces, at the cases of tests/dist/test_timeshard.py,
and ``sharded_decode`` against the port's unsharded ``decode()``.

Bars: the JAX tests' own, logZ and scores rtol 1e-5 / atol 1e-6, paths equal
within each row's length; survivor masks equal.  Layout (ii), a process
group of ranks, is in tests/test_torch_dist.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.parallel import timeshard as J
from asr_craft_tpu_torch import ops as tops
from asr_craft_tpu_torch.models.crf import CrfConfig, decode
from asr_craft_tpu_torch.ops.semiring import NEG_INF
from asr_craft_tpu_torch.parallel import timeshard as P

TOL = dict(rtol=1e-5, atol=1e-6)


def _problem(seed, B, T, L, lengths=None, scale=1.0, trans_scale=1.0):
    rng = np.random.default_rng(seed)
    state = (rng.normal(size=(B, T, L)) * scale).astype(np.float32)
    trans = (rng.normal(size=(L, L)) * trans_scale).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
        lengths[0] = T
    return state, trans, np.asarray(lengths, np.int32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _same_paths(got, want, lengths):
    for b, n in enumerate(lengths):
        np.testing.assert_array_equal(np.asarray(got)[b, :n],
                                      np.asarray(want)[b, :n])


@pytest.mark.parametrize("T", [16, 40])
def test_sharded_logZ_matches_jax(T):
    state, trans, lengths = _problem(0, 3, T, 5)
    got = P.sharded_log_partition(*_t(state, trans, lengths),
                                  P.time_mesh(8, "cpu"))
    want = J.sharded_log_partition(*_j(state, trans, lengths), J.time_mesh(8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), tops.log_partition_batch(*_t(state, trans, lengths)),
        **TOL)


def test_sharded_tropical_score_matches_jax():
    state, trans, lengths = _problem(1, 2, 24, 4)
    got = P.sharded_log_partition(*_t(state, trans, lengths),
                                  P.time_mesh(8, "cpu"), semiring="tropical")
    want = J.sharded_log_partition(*_j(state, trans, lengths), J.time_mesh(8),
                                   semiring="tropical")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _, score = tops.viterbi_batch(*_t(state, trans, lengths))
    np.testing.assert_allclose(got.numpy(), score.numpy(), **TOL)


@pytest.mark.parametrize("T,n", [(16, 8), (24, 4), (12, 2)])
def test_sharded_viterbi_matches_jax(T, n):
    state, trans, lengths = _problem(2, 3, T, 5)
    path, score = P.sharded_viterbi(*_t(state, trans, lengths),
                                    P.time_mesh(n, "cpu"))
    jpath, jscore = J.sharded_viterbi(*_j(state, trans, lengths),
                                      J.time_mesh(n))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), **TOL)
    _same_paths(path, jpath, lengths)
    # the contract of ops.viterbi: frames past a length repeat its label
    ref, ref_score = tops.viterbi_batch(*_t(state, trans, lengths))
    assert path.dtype == torch.int32 and torch.equal(path, ref)
    np.testing.assert_allclose(score.numpy(), ref_score.numpy(), **TOL)


def test_sharded_viterbi_short_lengths():
    """Rows that end inside the first chunk."""
    state, trans, lengths = _problem(3, 2, 16, 4, lengths=[1, 2])
    path, score = P.sharded_viterbi(*_t(state, trans, lengths),
                                    P.time_mesh(8, "cpu"))
    jpath, jscore = J.sharded_viterbi(*_j(state, trans, lengths),
                                      J.time_mesh(8))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=1e-5)
    _same_paths(path, jpath, lengths)


@pytest.mark.parametrize("ties", [False, True])
def test_pruned_matches_jax_and_masked_unsharded(ties):
    """``beam_labels`` K: the survivor sets equal the JAX ones, ties at the
    K-th peak included (``ties``: integer-valued state, where ``torch.topk``
    could take any of the tied labels and a stable sort takes the lowest,
    as ``lax.top_k`` does); the pruned decode equals the JAX one and the
    unsharded decode on the survivor-masked lattice; K = L is exact."""
    B, T, L, K, N = 3, 64, 12, 5, 8
    state, trans, lengths = _problem(4, B, T, L, [T, T - 9, 2 * T // N + 3],
                                     scale=2.0, trans_scale=0.4)
    if ties:
        state = np.round(state).astype(np.float32)
    mask = P.survivor_mask(*_t(state, lengths), N, K)
    jmask = J.survivor_mask(*_j(state, lengths), N, K)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    mesh = P.time_mesh(N, "cpu")
    path, score = P.sharded_viterbi(*_t(state, trans, lengths), mesh,
                                    beam_labels=K)
    jpath, jscore = J.sharded_viterbi(*_j(state, trans, lengths),
                                      J.time_mesh(N), beam_labels=K)
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=1e-5,
                               atol=1e-5)
    _same_paths(path, jpath, lengths)
    masked = torch.where(mask, torch.from_numpy(state), NEG_INF)
    ref, ref_score = tops.viterbi_batch(masked, *_t(trans, lengths))
    np.testing.assert_allclose(score.numpy(), ref_score.numpy(), rtol=1e-5,
                               atol=1e-5)
    _same_paths(path, ref, lengths)
    full, full_score = P.sharded_viterbi(*_t(state, trans, lengths), mesh,
                                         beam_labels=L)
    exact, exact_score = P.sharded_viterbi(*_t(state, trans, lengths), mesh)
    assert torch.equal(full, exact) and torch.equal(full_score, exact_score)


@pytest.mark.parametrize("semiring", ["log", "tropical"])
def test_blocked_chunk_product_equals_one_block(monkeypatch, semiring):
    """The chunk product contracted in blocks of k (an intermediate budget
    of 2 KiB: blocks of one or two labels) against one block."""
    from asr_craft_tpu_torch.ops.semiring import get_semiring
    state, trans, lengths = _problem(5, 3, 12, 6)
    st, tr, ln = _t(state, trans, lengths)
    mesh = P.time_mesh(4, "cpu")
    state_c, offsets = P._chunks(st, mesh)
    sr = get_semiring(semiring)
    whole = P._local_chunk_product(state_c, tr, ln.long(), offsets, sr)
    monkeypatch.setattr(P, "_BLOCK_BYTES", 2048)
    blocked = P._local_chunk_product(state_c, tr, ln.long(), offsets, sr)
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)
    if semiring == "tropical":
        assert torch.equal(blocked, whole)


def _shared_model(P_, ns, seed=0):
    cfg = CrfConfig(num_labels=P_, feat_dim=7, num_states=ns)
    params = cfg.init_params(torch.Generator().manual_seed(seed), 0.5)
    return cfg, params


@pytest.mark.parametrize("ns", [1, 3])
def test_sharded_decode_matches_unsharded_decode(ns):
    """At a tiny shared-transition config, T = 21 padded to 24 over 8
    chunks: the phones, paths and scores of ``decode()``; with
    ``beam_labels`` those of ``decode()`` on the survivor-masked
    potentials, by way of ``sharded_viterbi``."""
    cfg, params = _shared_model(4, ns)
    rng = np.random.default_rng(6)
    feats = torch.from_numpy(rng.normal(size=(3, 21, 7)).astype(np.float32))
    lengths = torch.tensor([21, 13, 2], dtype=torch.int32)
    phones, path, score = P.sharded_decode(cfg, params, feats, lengths, 8,
                                           device="cpu")
    rph, rpath, rscore = decode(cfg, params, feats, lengths)
    np.testing.assert_allclose(score.numpy(), rscore.numpy(), rtol=1e-5,
                               atol=1e-5)
    _same_paths(path, rpath, lengths.tolist())
    assert path.shape == rpath.shape and phones.shape == rph.shape
    _same_paths(phones, rph, lengths.tolist())
    _, _, pscore = P.sharded_decode(cfg, params, feats, lengths, 8,
                                    beam_labels=2, device="cpu")
    assert (pscore <= score + 1e-4).all()


def test_sharded_decode_refuses_fdt_and_raises_without_card():
    cfg = CrfConfig(num_labels=3, feat_dim=6, trans_range=(0, 6))
    params = cfg.init_params()
    feats, lengths = torch.zeros(1, 8, 6), torch.tensor([8])
    with pytest.raises(ValueError, match="frame-independent"):
        P.sharded_decode(cfg, params, feats, lengths, 2, device="cpu")
    if not torch.cuda.is_available():
        scfg, sparams = _shared_model(3, 1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.sharded_decode(scfg, sparams, torch.zeros(1, 8, 7), lengths, 2)
    with pytest.raises(ValueError, match="number of chunks"):
        P.time_mesh(None, "cpu")
    with pytest.raises(RuntimeError, match="not initialised"):
        P.time_mesh(2, distributed=True)
    with pytest.raises(ValueError, match="divide"):
        P.sharded_log_partition(torch.zeros(1, 9, 3), torch.zeros(3, 3),
                                torch.tensor([9]), P.time_mesh(2, "cpu"))


def test_sharded_decode_densifies_a_sparse_map():
    cfg = CrfConfig(num_labels=3, feat_dim=7, featuremap="sparse")
    params = cfg.init_params(torch.Generator().manual_seed(1), 0.5)
    rng = np.random.default_rng(7)
    idx = torch.from_numpy(rng.integers(0, 7, size=(2, 16, 3)).astype(
        np.int32))
    val = torch.from_numpy(rng.normal(size=(2, 16, 3)).astype(np.float32))
    lengths = torch.tensor([16, 9], dtype=torch.int32)
    _, path, score = P.sharded_decode(cfg, params, None, lengths, 4,
                                      sparse=(idx, val), device="cpu")
    _, rpath, rscore = decode(cfg, params, None, lengths, sparse=(idx, val))
    np.testing.assert_allclose(score.numpy(), rscore.numpy(), rtol=1e-5,
                               atol=1e-5)
    _same_paths(path, rpath, lengths.tolist())
