"""K2's recursion split by roles, on the CPU: the wrapper's ring rule
(``kernels.fdt_train.backward_stages``), what it hands the library and
counts, and the split itself modelled in plain PyTorch.

The kernel (``csrc/fdt_train.cu`` ``fdt_train_bwd_kernel``) runs beta on
chain warps and the xi and gamma statistics on other warps, a ring of
plane rows behind: the chain writes, for frame n, xs_n = beta_n + state2_n,
the cross max m_n (per source phone and lattice) and beta_n-1 into frame
n's slot; the statistics form the xi into frame n and gamma_n-1 from that
slot, alpha_n-1 and plane n alone, then release the slot.  The model runs
the same protocol with a ring of k slots (the chain may not write a slot
the statistics have not released), so the statistics run k frames behind
the chain; it is held to the plain ``fdt_dplane_wall_torch``: the state,
self and advance rows bit for bit (the chain's beta is the plain beta),
the cross rows within fp32 rounding (e_h g_h, the kernel's split of each
exponential, where the plain version takes one), and every k gives the
same bits.  The library in the wrapper's tests is a stand-in with the C
layout's shared memory.
"""
import contextlib
from collections import deque

import numpy as np
import pytest
import torch

from asr_craft_tpu_torch.kernels import fdt_train as K
from asr_craft_tpu_torch.kernels.wall import SMEM_LIMIT, build_wall
from asr_craft_tpu_torch.models.crf import CrfConfig
from asr_craft_tpu_torch.ops import fdt
from asr_craft_tpu_torch.ops.semiring import NEG_INF
from asr_craft_tpu_torch.utils import diagnostics


def _problem(P, ns, clamp_ns, lengths, T=9, D=8, seed=0):
    """A random model (scale 0.3), N(0, 1) frames, phone runs of ns+1
    frames (at clamp_ns = 1 the state walk of each run), the given lengths,
    and K1's plain outputs; lattice weights of both signs."""
    cfg = CrfConfig(num_labels=P, feat_dim=D, num_states=ns,
                    state_range=(0, D - 2), trans_range=(2, D))
    rng = np.random.default_rng(seed)
    params = {k: torch.from_numpy(rng.normal(size=s, scale=0.3)
                                  .astype(np.float32))
              for k, s in cfg.fmap.param_shapes().items()}
    B = len(lengths)
    feats = torch.from_numpy(rng.normal(size=(B, T, D)).astype(np.float32))
    run = ns + 1
    labels = np.repeat(rng.integers(0, P, size=(B, T // run + 1)), run,
                       axis=1)[:, :T]
    if clamp_ns == 1:
        steps = np.asarray([0] + list(range(ns)))
        labels = labels * ns + np.tile(steps, T // run + 1)[None, :T]
    Wall, u0, u1, _ = build_wall(params, cfg.fmap, ns)
    kw = dict(u0=u0, u1=u1, ns=ns, P=P, clamp_ns=clamp_ns, boundaries=True)
    labels = torch.from_numpy(labels.astype(np.int32))
    lengths = torch.tensor(lengths, dtype=torch.int32)
    alphas, zf, zc = K.fdt_forward_wall_torch(Wall, feats, labels, lengths,
                                              **kw)
    wf = torch.linspace(0.5, 1.5, B)
    wc = -torch.linspace(1.0, 2.0, B)
    return (Wall, feats, labels, lengths, alphas, zf, zc, wf, wc), kw


def split_dplane(Wall, feats, labels, lengths, alphas, zf, zc, wf, wc, *,
                 u0, u1, ns, P, clamp_ns, boundaries, ring):
    """dplane (B, T, R) by the split, the statistics ``ring`` frames behind
    the chain (see the module's docstring)."""
    B, T, _ = feats.shape
    Lp, R = ns * P, Wall.shape[0]
    planes = K.fdt_planes_torch(Wall, feats, u0=u0, u1=u1)
    state = fdt._boundary_state(planes[..., :Lp], lengths, ns, boundaries)
    cross = planes[..., 3 * Lp:].reshape(B, T, P, P)
    st = torch.arange(Lp) % ns
    z = torch.stack([zf, zc], dim=1)[..., None]
    w = torch.stack([wf, wc], dim=1)[..., None]
    live = z > NEG_INF * 0.5

    def gate(s, ok):
        extra = (1,) * (s.dim() - 3)
        zz, ww = z.reshape(B, 2, 1, *extra), w.reshape(B, 2, 1, *extra)
        keep = (live & ok[:, None, None]).reshape(B, 2, 1, *extra)
        return torch.where(keep, torch.exp(torch.clamp(s - zz, max=40.0))
                           * ww, 0.0)

    dplane = torch.zeros((B, T, R))
    slots = [None] * ring

    def statistics(n, k):
        """The xi into frame n and gamma_n-1 from slot k, alpha_n-1 and
        plane n (n = T: gamma_T-1 alone, beta_T-1 = 0)."""
        t = n - 1
        a = alphas[:, t]
        if n == T:
            beta = torch.zeros((B, 2, Lp))
        else:
            xs, m, beta = slots[k]
            valid = lengths > n
            c = cross[:, n, None]
            g = gate(a[..., ns - 1::ns] + m, valid)               # (B, 2, P)
            e = torch.exp(xs[..., 0::ns][..., None, :] + c - m[..., None])
            dplane[:, n, 3 * Lp:] = (e * g[..., None]).sum(1).reshape(
                B, P * P)
            if ns > 1:
                f = planes[:, n, None, Lp:2 * Lp]
                adv = planes[:, n, None, 2 * Lp:3 * Lp]
                dplane[:, n, Lp:2 * Lp] = gate(a + f + xs, valid).sum(1)
                dplane[:, n, 2 * Lp:3 * Lp] = torch.where(
                    st < ns - 1, gate(a + adv + torch.roll(xs, -1, dims=-1),
                                      valid), 0.0).sum(1)
        dplane[:, t, :Lp] = gate(a + beta, lengths > t).sum(1)

    statistics(T, None)
    pending = deque()
    for j, n in enumerate(range(T - 1, 0, -1)):
        k = j % ring
        if j >= ring:                       # the statistics release slot k
            statistics(*pending.popleft())
        beta_n = slots[(j - 1) % ring][2] if j else torch.zeros((B, 2, Lp))
        xs = beta_n + K._state2(state, labels, n, clamp_ns)
        y = xs[..., 0::ns][..., None, :] + cross[:, n, None]
        m = torch.clamp(y.amax(dim=-1), min=NEG_INF)
        crossb = m + torch.log(torch.clamp(
            torch.exp(y - m[..., None]).sum(dim=-1), min=1e-35))
        if ns == 1:
            nb = crossb
        else:
            f = planes[:, n, None, Lp:2 * Lp]
            adv = planes[:, n, None, 2 * Lp:3 * Lp]
            adv_c = torch.where(st < ns - 1,
                                torch.roll(xs, -1, dims=-1) + adv, NEG_INF)
            cross_c = torch.where(st == ns - 1,
                                  torch.repeat_interleave(crossb, ns, -1),
                                  NEG_INF)
            nb = torch.logaddexp(xs + f, torch.logaddexp(adv_c, cross_c))
        slots[k] = (xs, m, torch.where((lengths > n)[:, None, None], nb,
                                       0.0))
        pending.append((n, k))
    while pending:
        statistics(*pending.popleft())
    return dplane


CASES = [(5, 3, 3), (5, 3, 1), (4, 1, 1), (6, 2, 2)]
LENGTHS = [[9, 2, 0, 5, 1, 7], [9, 9, 9], [1, 1], [0, 0]]


@pytest.mark.parametrize("lengths", LENGTHS,
                         ids=["ragged", "full", "one", "empty"])
@pytest.mark.parametrize("P,ns,clamp_ns", CASES)
def test_split_matches_plain_at_every_ring_depth(P, ns, clamp_ns, lengths):
    args, kw = _problem(P, ns, clamp_ns, lengths, seed=P * 10 + ns)
    plain = K.fdt_dplane_wall_torch(*args, **kw)
    Lp = ns * P
    outs = [split_dplane(*args, **kw, ring=k) for k in (1, 2, 4)]
    for out in outs:
        assert torch.equal(out[..., :3 * Lp], plain[..., :3 * Lp])
        torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-6)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def _slot_floats(ns, P):
    """csrc/fdt_train.cu bwd_slot_floats: plane row, xs, m, beta, alpha,
    label."""
    up4 = lambda n: (n + 3) // 4 * 4
    Lp = ns * P
    return up4(up4(3 * Lp + P * P) + 6 * Lp + 2 * P + 1)


class _Library:
    """A stand-in for the kernels' library: K2's shared memory as the C
    layout sizes it (a ring of slots, two buffers of gates, 3 mbarriers a
    slot), or a fixed size, and each fdt_train_bwd call's arguments."""

    def __init__(self, fixed=None):
        self.calls, self.fixed = [], fixed

    def fdt_train_bwd_smem_bytes(self, ns, P, stages):
        if self.fixed is not None:
            return self.fixed
        off = (stages * _slot_floats(ns, P) + 4 * P + 1) & ~1
        return 4 * (off + 6 * stages)

    def fdt_train_bwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("ns,P,stages", [
    (3, 48, K.BWD_RING),          # the flagship: 14.8 KB a slot
    (1, 5, K.BWD_RING), (3, 96, 4), (1, 128, 3),
    (3, 128, 2),                  # 80 KB a slot: the shallowest ring
    (10, 128, 2), (11, 128, 0)])  # two slots no longer fit
def test_backward_stages_rule(ns, P, stages):
    """As deep as BWD_RING or the shared memory allows, at least two rows;
    0 (the wrapper refuses) where two do not fit."""
    lib = _Library()
    got = K.backward_stages(lib, ns, P)
    assert got == stages
    if got:
        assert lib.fdt_train_bwd_smem_bytes(ns, P, got) <= SMEM_LIMIT
    if 0 < got < K.BWD_RING:
        assert lib.fdt_train_bwd_smem_bytes(ns, P, got + 1) > SMEM_LIMIT


def _stand_ins(monkeypatch, lib):
    def check_tensor(name, t, dtype, ndim, device):
        assert t.dtype == dtype and t.dim() == ndim and t.is_contiguous()

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(K, "_library", lambda: lib)
    monkeypatch.setattr(K._build, "check_tensor", check_tensor)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())


@pytest.mark.parametrize("P,ns", [(48, 3), (128, 3), (5, 1)])
def test_dplane_wrapper_passes_and_counts_the_ring(monkeypatch, P, ns):
    """Each launch hands the library the ring's depth and counts one launch
    in ``kernels.fdt_train_bwd[ring<depth>]``."""
    lib = _Library()
    _stand_ins(monkeypatch, lib)
    (Wall, feats, labels, lengths, alphas, zf, zc, wf, wc), kw = _problem(
        P, ns, ns, [4, 3], T=4)
    R4 = (Wall.shape[0] + 3) // 4 * 4
    planes = torch.zeros((2, 4, R4))
    stages = K.backward_stages(lib, ns, P)
    with diagnostics.held_launches() as ran:
        K.fdt_dplane_cuda(Wall, feats, labels, lengths, alphas, zf, zc, wf,
                          wc, **kw, planes=planes)
    (args,) = lib.calls
    assert args[9:16] == (2, 4, ns, P, ns, 1, stages)
    assert ran == {f"kernels.fdt_train_bwd[ring{stages}]": 1}


def test_dplane_wrapper_refuses_what_two_rows_do_not_fit(monkeypatch):
    lib = _Library(fixed=SMEM_LIMIT + 1)
    _stand_ins(monkeypatch, lib)
    args, kw = _problem(5, 3, 3, [4, 3], T=4)
    with diagnostics.held_launches() as ran:
        with pytest.raises(ValueError, match="shared memory"):
            K.fdt_dplane_cuda(*args, **kw, planes=torch.zeros((2, 4, 72)))
    assert lib.calls == [] and ran == {}
