"""The port's shared-transition Viterbi (asr_craft_tpu_torch.ops.viterbi,
the plain version of the K7/K8 kernels) against the JAX package's XLA path
(asr_craft_tpu.ops.viterbi.viterbi_batch) and its K7 kernel
(viterbi_pallas, run in interpret mode as the JAX package's own tests run
it on the CPU), on identical numpy-seeded inputs; plus the kernel module's
CPU surface (factored weights, dispatch, refusals).  K8 against its TPU
kernel: test_torch_viterbi_nstate.py.

Paths must be EQUAL, on continuous, all-zero and integer potentials alike:
the port takes the XLA path's tie order (first argmax in expanded-label
order).  Scores too: both sides do the same fp32 adds and maxes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.kernels.viterbi_pallas import (_factored_weights,
                                                  viterbi_pallas)
from asr_craft_tpu.models.topology import Topology as JaxTopology
from asr_craft_tpu.ops.viterbi import viterbi_batch
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import viterbi as KV
from asr_craft_tpu_torch.ops import viterbi as V
from asr_craft_tpu_torch.ops.semiring import NEG_INF
from asr_craft_tpu_torch.utils import diagnostics

MODES = {"exact": (None, None), "threshold": (2.0, None),
         "topk": (None, 4), "threshold+topk": (1.0, 3)}


def problem(seed, P, ns, B=5, T=13, kind="normal"):
    """state (B, T, L'), trans (L', L'), lengths (row 0 full, a row of
    length 0, a row of length 2); n-state problems carry the topology
    penalty in trans and the start/end masks in state, as
    ``models.crf.decode`` hands them over.  ``kind``: "normal" (N(0, 1)),
    "zero" (everything ties) or "integer" ({0, 1}: ties everywhere, in
    any summation order)."""
    rng = np.random.default_rng(seed)
    L = P * ns
    state = rng.normal(size=(B, T, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    if kind == "zero":
        state, trans = np.zeros_like(state), np.zeros_like(trans)
    elif kind == "integer":
        state = rng.integers(0, 2, size=state.shape).astype(np.float32)
        trans = rng.integers(0, 2, size=trans.shape).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0], lengths[1], lengths[-1] = T, 2, 0
    if ns > 1:
        topo = JaxTopology(P, ns)
        trans = trans + topo.transition_penalty()
        state[:, 0] += topo.start_penalty()
        for b in range(B):
            if lengths[b] > 0:
                state[b, lengths[b] - 1] += topo.end_penalty()
    return state, trans, lengths


def port(state, trans, lengths, thr, bw):
    paths, scores = V.viterbi_batch(torch.from_numpy(state),
                              torch.from_numpy(trans),
                              torch.from_numpy(lengths), bw, thr)
    return paths.numpy(), scores.numpy()


def jax_xla(state, trans, lengths, thr, bw):
    paths, scores = viterbi_batch(jnp.asarray(state), jnp.asarray(trans),
                                  jnp.asarray(lengths), beam_width=bw,
                                  beam_threshold=thr)
    return np.asarray(paths), np.asarray(scores)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["normal", "zero", "integer"])
@pytest.mark.parametrize("P,ns", [(6, 1), (4, 3)])
def test_matches_xla_exactly(P, ns, kind, mode):
    thr, bw = MODES[mode]
    state, trans, lengths = problem(P + ns, P, ns, kind=kind)
    tp, ts = port(state, trans, lengths, thr, bw)
    jp, js = jax_xla(state, trans, lengths, thr, bw)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("mode", ["exact", "threshold", "topk"])
@pytest.mark.parametrize("kind", ["normal", "integer"])
def test_matches_k7_interpret_exactly(kind, mode):
    """The K7 TPU kernel breaks ties like the XLA path: equal paths, also
    on tied inputs (rows of length 0 included)."""
    thr, bw = MODES[mode]
    state, trans, lengths = problem(11, 7, 1, B=4, T=9, kind=kind)
    tp, ts = port(state, trans, lengths, thr, bw)
    kp, ks = viterbi_pallas(jnp.moveaxis(jnp.asarray(state), 1, 0),
                            jnp.asarray(trans), jnp.asarray(lengths),
                            beam_threshold=thr, beam_width=bw,
                            interpret=True)
    np.testing.assert_array_equal(tp, np.asarray(kp))
    np.testing.assert_allclose(ts, np.asarray(ks), rtol=1e-6, atol=0)


def test_k7_interpret_n_state_above_128_phones():
    """JAX routes n-state models with P > 128 to K7 (models/crf.py
    :238-245): the port's plain version agrees there too (L' = 390)."""
    state, trans, lengths = problem(3, 130, 3, B=2, T=6)
    tp, ts = port(state, trans, lengths, None, None)
    kp, ks = viterbi_pallas(jnp.moveaxis(jnp.asarray(state), 1, 0),
                            jnp.asarray(trans), jnp.asarray(lengths),
                            interpret=True)
    np.testing.assert_array_equal(tp, np.asarray(kp))
    np.testing.assert_allclose(ts, np.asarray(ks), rtol=1e-6, atol=0)


@pytest.mark.parametrize("P,ns", [(6, 1), (4, 3)])
def test_forward_layout_and_path_score(P, ns):
    """bp is identity at frame 0 and past each length; path_score rescores
    each decoded path of a live row to its decode score (a row of length
    0 scores its frame-0 max but sums no frame)."""
    state, trans, lengths = problem(5, P, ns)
    st, tr, ln = (torch.from_numpy(x) for x in (state, trans, lengths))
    bp, last, scores = V.viterbi_forward(st, tr, ln)
    lab = torch.arange(P * ns, dtype=torch.int32)
    assert bp.dtype == last.dtype == torch.int32
    for b, n in enumerate(lengths):
        for t in [0] + list(range(max(int(n), 1), state.shape[1])):
            assert torch.equal(bp[b, t], lab), (b, t)
    paths, want = V.viterbi_batch(st, tr, ln)
    assert torch.equal(paths[:, -1], last)
    live = (want > NEG_INF / 2) & (ln > 0)
    assert int(live.sum()) >= 3
    torch.testing.assert_close(V.path_score(st, tr, paths, ln)[live],
                               want[live], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("P,ns", [(5, 2), (4, 3), (3, 4)])
def test_factored_weights_match_jax(P, ns):
    """The kernel wrapper's weights are JAX's _factored_weights,
    state-major instead of plane-major and without lane padding."""
    _, trans, _ = problem(P, P, ns)
    ws, wa, wc = KV.factored_weights(torch.from_numpy(trans), P, ns)
    pp = 8
    jws, jwa, jwc = (np.asarray(x) for x in
                     _factored_weights(jnp.asarray(trans), P, ns, pp))
    plane = lambda w: w.reshape(ns, pp)[:, :P].T.reshape(-1)   # -> q*ns+s
    np.testing.assert_array_equal(ws.numpy(), plane(jws))
    np.testing.assert_array_equal(wa.numpy(), plane(jwa))
    np.testing.assert_array_equal(wc.numpy(), jwc[:P, :P])


def test_dispatch_takes_plain_only_for_cpu_tensors():
    state, trans, lengths = problem(2, 4, 3)
    st, tr, ln = (torch.from_numpy(x) for x in (state, trans, lengths))
    want = V.viterbi_batch(st, tr, ln, 3, 2.0)
    before = diagnostics.launches()
    for got in (KV.viterbi_shared(st, tr, ln, 1, 2.0, 3),
                KV.viterbi_shared(st, tr, ln, 3, 2.0, 3)):
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    kernels.set_backend("cuda")
    try:
        with pytest.raises(ValueError, match="CUDA tensor"):
            KV.viterbi_shared(st, tr, ln)
        with pytest.raises(ValueError, match="CUDA tensor"):
            KV.viterbi_shared(st, tr, ln, 3)
    finally:
        kernels.set_backend("auto")
    for fn in (lambda: KV.viterbi_dense_fwd(st, tr, ln),
               lambda: KV.viterbi_nstate_fwd(st, tr, ln, 3),
               lambda: KV.viterbi_traceback(torch.zeros((5, 13, 12),
                                                        dtype=torch.int32),
                                            ln, ln)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn()
    assert diagnostics.launches() == before
