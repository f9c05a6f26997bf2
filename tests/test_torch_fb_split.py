"""K5 as two kernels: the plain versions of its recursion
(``kernels.fwdbwd.backward_dual_grad_rows_plain``: g_state and the rows U,
V of the transition gradient) and of its contraction
(``backward_dual_contract_plain``: UV = sum U^T V), against the JAX
package's ``backward_dual_grad_pallas`` in interpret mode, against the
in-recursion sum they replace, and the host-side planning of the kernels
(the factor's layout by width, the contraction's tile and split of the
rows).

Tolerance: the JAX package's fp32 bar, rtol=5e-4, atol=5e-5 (as
``tests/test_torch_dual.py``): both sides do the same rescaled-exp
arithmetic and differ in the order of the sums.  The contraction of the rows
against the in-recursion sum: the same products summed in another order,
rtol 1e-5 of the largest entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.kernels.dual_pallas import (backward_dual_grad_pallas,
                                               forward_dual_pallas)
from asr_craft_tpu_torch.kernels import fwdbwd as K
from tests.test_torch_dual import SHAPES, TOL, _jax_args, _problem, _tm, \
    _torch


def _weights(B, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.5, B).astype(np.float32),
            -rng.uniform(0.5, 1.5, B).astype(np.float32))


def _rows(name, seed):
    """The problem's inputs to K5 (the plain K4's alphas) and its rows."""
    state, trans, labels, lengths, cns = _problem(name, seed)
    wf, wc = _weights(len(lengths))
    args = _torch(state, trans, labels, lengths)
    af, ac, zf, zc = K.forward_dual_plain(*args, cns)
    grad_in = (af, ac, zf, zc, *_torch(wf, wc))
    return args, grad_in, cns, K.backward_dual_grad_rows_plain(
        *args, *grad_in, cns)


@pytest.mark.parametrize("name", list(SHAPES))
def test_composition_matches_pallas_interpret(name):
    """The recursion's plain version, then the contraction's, against the
    JAX K5 (interpret mode) fed the JAX K4's alphas."""
    state, trans, labels, lengths, cns = _problem(name, 2)
    wf, wc = _weights(len(lengths))
    jargs = _jax_args(state, trans, labels, lengths)
    jaf, jac, jzf, jzc = forward_dual_pallas(*jargs, num_states=cns,
                                             interpret=True)
    jg, jUV = backward_dual_grad_pallas(
        *jargs, jaf, jac, jzf, jzc, jnp.asarray(wf), jnp.asarray(wc),
        num_states=cns, interpret=True)
    g, U, V = K.backward_dual_grad_rows_plain(
        *_torch(state, trans, labels, lengths),
        *_torch(_tm(jaf), _tm(jac), jzf, jzc, wf, wc), cns)
    UV = K.backward_dual_contract_plain(U, V)
    B, T, L = state.shape
    assert U.shape == V.shape == (B, T, 2, L)
    np.testing.assert_allclose(g.numpy(), _tm(jg), **TOL)
    jUV = np.asarray(jUV)
    np.testing.assert_allclose(UV.numpy(), jUV, rtol=5e-4,
                               atol=5e-5 * max(1.0, np.abs(jUV).max()))


def _in_recursion_sum(args, grad_in, cns):
    """UV as a fused recursion sums it: U_t = exp(alpha_t - mU) * exp(mU +
    m - z) * w, with mU alpha_t's row maximum (the reference's form), and
    UV += U_t^T V_t frame by frame, inside the beta recursion."""
    state, trans, labels, lengths = args
    af, ac, zf, zc, wf, wc = grad_in
    B, T, L = state.shape
    tmax_r, Pt = K.backward_factors(trans)
    alphas = torch.stack([af, ac], dim=2)
    z, w = torch.stack([zf, zc], 1)[..., None], torch.stack([wf, wc], 1)[
        ..., None]
    beta = torch.zeros((B, 2, L))
    UV = torch.zeros((L, L))
    for t in range(T - 2, -1, -1):
        x = beta + K._rows(state, labels, t + 1, cns)
        m = K.row_max(x)
        V = torch.exp(x - m)
        valid = (t + 1 < lengths)[:, None, None]
        mU = K.row_max(alphas[:, t])
        scale = torch.where(valid, torch.exp(mU + m - z) * w, 0.0)
        U = torch.exp(alphas[:, t] - mU) * scale
        UV += torch.einsum("bnp,bnl->pl", U, V)
        beta = torch.where(valid, m + tmax_r + K.safe_log(V @ Pt), 0.0)
    return UV


@pytest.mark.parametrize("name", list(SHAPES))
def test_contraction_of_the_rows_equals_the_in_recursion_sum(name):
    args, grad_in, cns, (g, U, V) = _rows(name, 5)
    want = _in_recursion_sum(args, grad_in, cns)
    got = K.backward_dual_contract_plain(U, V)
    scale = float(want.abs().max())      # 0 for one frame: no successor
    assert scale > 0 or args[0].shape[1] == 1
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5 * scale)
    # and the whole function is that composition
    g2, UV2 = K.backward_dual_grad_plain(*args, *grad_in, cns)
    assert torch.equal(g2, g) and torch.equal(UV2, got)


@pytest.mark.parametrize("name", list(SHAPES))
def test_rows_are_zero_without_a_successor(name):
    """U and V hold 0 at every frame t with t + 1 >= length (the empty
    row's frames included), and the state gradient past the length."""
    args, _, _, (g, U, V) = _rows(name, 6)
    lengths = args[3]
    for b, n in enumerate(lengths.tolist()):
        assert not U[b, max(n - 1, 0):].any()
        assert not V[b, max(n - 1, 0):].any()
        assert not g[b, n:].any()
    assert float(V.max()) <= 1.0 and float(V.min()) >= 0.0


@pytest.mark.parametrize("name", ["phone_ns3", "state_ns3", "mono"])
def test_dead_clamped_lattice_rows_contract_to_exactly_zero(name):
    """A row labelled with a phone no state admits, weighted on its clamped
    lattice alone: its U rows are exactly zero (alpha at or below NEG_INF
    while m and z are clamped there), so are g_state and the contraction,
    with nothing NaN."""
    state, trans, labels, lengths, cns = _problem(name, 4)
    labels[1] = 10_000
    lengths[1] = state.shape[1] - 1
    args = _torch(state, trans, labels, lengths)
    af, ac, zf, zc = K.forward_dual_plain(*args, cns)
    assert float(zc[1]) < -1e29
    wc = torch.zeros(len(lengths))
    wc[1] = 1.0
    g, U, V = K.backward_dual_grad_rows_plain(
        *args, af, ac, zf, zc, torch.zeros_like(wc), wc, cns)
    UV = K.backward_dual_contract_plain(U, V)
    for x in (g, U, V, UV):
        assert torch.isfinite(x).all()
    assert not U.any() and not g.any() and not UV.any()


@pytest.mark.parametrize("name", list(SHAPES))
def test_rows_equal_the_reference_two_factor_form(name):
    """U_t = exp(alpha_t + m - z) w is the reference's exp(alpha_t - mU)
    exp(mU + m - z) w in one exponent: the two agree to rounding wherever
    the reference's factors are finite."""
    args, grad_in, cns, (_, U, V) = _rows(name, 7)
    state, trans, labels, lengths = args
    af, ac, zf, zc, wf, wc = grad_in
    B, T, L = state.shape
    alphas = torch.stack([af, ac], dim=2)
    z, w = torch.stack([zf, zc], 1)[..., None], torch.stack([wf, wc], 1)[
        ..., None]
    # m of frame t from V: exp(x - m) = V, and x's maximum gives V = 1; so
    # recompute m from the plain recursion's x
    tmax_r, Pt = K.backward_factors(trans)
    beta = torch.zeros((B, 2, L))
    for t in range(T - 2, -1, -1):
        x = beta + K._rows(state, labels, t + 1, cns)
        m = K.row_max(x)
        valid = (t + 1 < lengths)[:, None, None]
        mU = K.row_max(alphas[:, t])
        ref = torch.where(valid, torch.exp(alphas[:, t] - mU)
                          * (torch.exp(mU + m - z) * w), 0.0)
        torch.testing.assert_close(U[:, t], ref, rtol=1e-5, atol=1e-30)
        beta = torch.where(valid, m + tmax_r + K.safe_log(
            torch.exp(x - m) @ Pt), 0.0)


@pytest.mark.parametrize("L,layout", [
    (1, (3, 2, False)), (42, (3, 2, False)), (48, (3, 2, False)),
    (49, (5, 2, False)), (80, (5, 2, False)), (81, (9, 2, False)),
    (138, (9, 2, False)), (144, (9, 2, False)), (145, (15, 4, True)),
    (232, (15, 4, True)), (233, None), (0, None)])
def test_factor_layout_by_width(L, layout):
    """Registers while a lane's quarters of its destinations' rows fit (L <=
    144), shared memory beyond, nothing past L = 232; the quarters cover the
    predecessors and QV is odd (a quarter-warp's 16-byte loads on distinct
    banks)."""
    assert K.factor_layout(L) == layout
    if layout is not None:
        qv, D, shared = layout
        assert 16 * qv >= L and qv % 2 == 1 and D in (1, 2, 4)


@pytest.mark.parametrize("L,tile", [(1, 48), (42, 48), (48, 48), (49, 96),
                                    (96, 96), (138, 144), (144, 144),
                                    (232, 144), (390, 144)])
def test_contraction_tile_by_width(L, tile):
    assert K.contract_tile(L) == tile


def test_contraction_splits_the_rows():
    """About ``blocks`` blocks over the output's tiles, chunks of at least
    CONTRACT_MIN_ROWS rows, one chunk for a small K."""
    K_rows = 2 * 128 * 512
    assert K.contract_splits(K_rows, 138, blocks=132) == 132
    assert K.contract_splits(K_rows, 48, blocks=264) == 264
    assert K.contract_splits(K_rows, 232, blocks=132) == 33   # 4 tiles
    assert K.contract_splits(500, 48, blocks=264) == 1
    assert K.contract_splits(0, 48, blocks=264) == 1
    assert K.contract_splits(10 * K.CONTRACT_MIN_ROWS, 48, blocks=264) == 10


@pytest.mark.parametrize("L,ld", [(1, 4), (42, 44), (48, 48), (138, 140),
                                  (232, 232)])
def test_row_width_keeps_rows_16_byte_aligned(L, ld):
    assert K.row_width(L) == ld and ld % 4 == 0 and ld >= L
