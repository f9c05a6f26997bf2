"""The port's roofline model (``asr_craft_tpu_torch.utils.roofline``).

Its arithmetic is the JAX module's: the same ``Phase`` list and a
``ChipSpec`` built from the same numbers give EQUAL ``sol_s`` values and
``summarize`` records in both packages, every key.  Its counts are the
port's own: they scale with the batch and the length as
``tests/unit/test_roofline.py`` asks of the JAX ones, carry none of the
TPU's padding, and give the bounds of PERF.md's kernel table (to the digits
printed there).
"""
import inspect
import math
import re

import pytest

from asr_craft_tpu.utils import roofline as jrl
from asr_craft_tpu_torch.utils import roofline as rl

NUMBERS = dict(name="a card", hbm_gbps=1234.5, fp32_tflops=21.0,
               bf16_tflops=300.0)
PHASES = [("prep", 3.0e7, 0.0, 0.0), ("forward", 2.5e7, 6.0e8, 7.1e8),
          ("grad", 6.6e7, 1.2e9, 1.06e9), ("products", 1.0e6, 9.0e10, 0.0),
          ("tiny", 12.0, 5.0, 3.0)]


def _both(mod_phases=PHASES):
    return ([jrl.Phase(*p) for p in mod_phases], jrl.ChipSpec(**NUMBERS),
            [rl.Phase(*p) for p in mod_phases], rl.ChipSpec(**NUMBERS))


@pytest.mark.parametrize("kw", [{}, {"bw_gbps": 900.0}, {"vpu_geps": 1700.0},
                                {"bw_gbps": 77.0, "vpu_geps": 3.5},
                                {"mode": "fp32"}, {"fp32": True}],
                         ids=str)
def test_sol_s_equals_the_jax_module(kw):
    jp, jspec, tp, tspec = _both()
    for a, b in zip(jp, tp):
        assert a.sol_s(jspec, **kw) == b.sol_s(tspec, **kw)


@pytest.mark.parametrize("kw", [
    {}, {"measured_bw_gbps": 1000.0}, {"vpu_geps": 1705.7},
    {"measured_bw_gbps": 1100.0, "vpu_geps": 2500.0, "mode": "fp32"}],
    ids=str)
def test_summarize_equals_the_jax_module(kw):
    jp, jspec, tp, tspec = _both()
    want = jrl.summarize(jp, 4.7e-3, spec=jspec, **kw)
    got = rl.summarize(tp, 4.7e-3, spec=tspec, **kw)
    assert got == want and list(got) == list(want)
    assert list(got["phases"]) == [p[0] for p in PHASES]


def test_other_precisions_raise():
    """The port's precisions set the products' rate: 'bf16x3' a third of
    the bf16 rate, 'default' the TF32 rate, 'fp32' (highest) a third of
    the TF32 rate; the rest of the work stays at the fp32 rate.  'bf16',
    one bf16 pass (the TPU's default lowering), which no precision of the
    port runs, still raises."""
    spec = rl.H100
    mm = rl.Phase("mm", bytes=1.0, flops=0.0, mma_flops=1e12)
    rates = {"fp32": 495.0 / 3, "highest": 495.0 / 3, "bf16x3": 989.0 / 3,
             "default": 495.0}
    for mode, tflops in rates.items():
        assert mm.sol_s(spec, mode=mode) == pytest.approx(1.0 / tflops)
        assert rl.bound(mm, spec, mode)[0] == pytest.approx(1e3 / tflops)
    fp = rl.Phase("fp", bytes=1.0, flops=67e12)
    assert fp.sol_s(spec, mode="bf16x3") == fp.sol_s(spec) == 1.0
    plane = rl.kernel_phase("fdt_train_plane", B=128, T=512, L=144, D=144,
                            ns=3)
    assert rl.bound(plane)[1] == "operations"
    assert rl.bound(plane, mode="bf16x3")[1] == "bytes"
    assert rl.bound(plane, mode="default")[1] == "bytes"
    floors = [rl.fdt_tile_floor(128, 512, 144, 144, 3, mode=m)["fma_ms"]
              for m in ("fp32", "bf16x3", "default")]
    assert floors[0] > floors[1] > floors[2]
    phase = rl.Phase("x", 1.0, 1.0)
    with pytest.raises(NotImplementedError, match="bf16"):
        phase.sol_s(mode="bf16")
    with pytest.raises(NotImplementedError, match="precision"):
        rl.summarize([phase], 1.0, mode="bf16")
    with pytest.raises(NotImplementedError, match="bf16"):
        phase.sol_s(fp32=False)
    assert rl.H100.hbm_gbps == 3350.0 and rl.H100.fp32_tflops == 67.0
    assert rl.H100.tf32_tflops == 495.0
    assert not hasattr(rl, "V5E") and not hasattr(rl, "measure_vpu_geps")


PHASE_NAMES = {
    "train_step_phases": ["featuremap", "dual_forward", "dual_backward_grad",
                          "featuremap_bwd", "optimizer"],
    "fdt_train_phases": ["fdt_prep", "fdt_forward", "fdt_backward_grad",
                         "optimizer"],
    "fdt_decode_phases": ["fdt_prep", "fdt_viterbi_forward",
                          "fdt_traceback"],
    "scrf_train_phases": ["scrf_prep", "scrf_forward", "scrf_backward",
                          "scrf_grad", "scrf_numerator", "scrf_grad_finish"],
    "scrf_decode_phases": ["scrf_prep", "scrf_viterbi_forward",
                           "scrf_traceback"],
    "decode_phases": ["featuremap", "viterbi_forward", "viterbi_traceback"],
}
ARGS = {"train_step_phases": (64, 512, 144, 144),
        "fdt_train_phases": (64, 512, 144, 144, 3),
        "fdt_decode_phases": (64, 512, 144, 144, 3),
        "scrf_train_phases": (64, 512, 48, 144, 16),
        "scrf_decode_phases": (64, 512, 48, 144, 16),
        "decode_phases": (64, 512, 144, 144)}


@pytest.mark.parametrize("fn", list(PHASE_NAMES))
def test_phase_names_are_the_jax_modules_and_counts_positive(fn):
    ours = getattr(rl, fn)(*ARGS[fn])
    theirs = getattr(jrl, fn)(*ARGS[fn])
    assert [p.name for p in ours] == [p.name for p in theirs] == \
        PHASE_NAMES[fn]
    for p in ours:
        assert p.bytes > 0 and p.flops >= 0 and p.vpu_elems >= 0
        assert p.sol_s() > 0


@pytest.mark.parametrize("fn", list(PHASE_NAMES))
def test_counts_scale_with_batch_and_length(fn):
    """No padding: the kernels' traffic and work double with B and with T;
    only the parameter-sized terms (the packed parameters, the transition
    matrix) do not grow, so the totals grow by 1.8-2x."""
    B, T, *rest = ARGS[fn]

    def totals(B, T):
        ph = getattr(rl, fn)(B, T, *rest)
        return (sum(p.bytes for p in ph), sum(p.flops for p in ph),
                sum(p.vpu_elems for p in ph))

    base = totals(B, T)
    for grown in (totals(2 * B, T), totals(B, 2 * T)):
        for lo, hi in zip(base, grown):
            if lo:
                assert 1.8 <= hi / lo <= 2.0 + 1e-9, (lo, hi)
    # B=64 costs half of B=128: no lane padding (the JAX counts are equal)
    v = lambda B: sum(p.vpu_elems for p in rl.scrf_train_phases(
        B, 512, 48, 144, 16) if p.name in ("scrf_forward", "scrf_backward",
                                           "scrf_grad"))
    assert math.isclose(v(128) / v(64), 2.0, rel_tol=1e-9)


def test_no_tile_padding():
    """L = 144 is counted as 144, not as 256 lanes."""
    ph = {p.name: p for p in rl.train_step_phases(64, 512, 144, 144)}
    tbl = 512 * 64 * 144 * 4
    assert 3 * tbl < ph["dual_forward"].bytes < 3.1 * tbl
    assert ph["dual_forward"].flops == 64 * 512 * 4.0 * 144 * 144


# PERF.md's kernel table: (kernel, shape, bound ms as printed, what binds)
FDT = dict(L=144, D=144, ns=3)
SEG = dict(B=128, T=512, L=48, Dmax=16)
TABLE = [
    ("fdt_train_fwd", dict(B=128, T=512, **FDT), "0.23671", "bytes"),
    ("fdt_train_plane", dict(B=128, T=512, **FDT), "0.31297", "operations"),
    ("fdt_train_bwd", dict(B=128, T=512, **FDT), "0.45081", "bytes"),
    ("fdt_train_contract", dict(B=128, T=512, **FDT), "0.31297",
     "operations"),
    ("fdt_viterbi_plane", dict(B=64, T=512, **FDT), "0.15649", "operations"),
    ("fdt_viterbi_fwd", dict(B=64, T=512, **FDT), "0.11268", "bytes"),
    ("fdt_viterbi_traceback", dict(B=64, T=512), "0.00008", "bytes"),
    ("forward_dual", dict(B=128, T=512, L=138), "0.07451", "operations"),
    ("forward_dual", dict(B=128, T=512, L=48), "0.0113", "bytes"),
    ("backward_dual_grad", dict(B=128, T=512, L=138), "0.08649", "bytes"),
    ("backward_dual_grad", dict(B=128, T=512, L=48), "0.0301", "bytes"),
    ("backward_dual_contract", dict(B=128, T=512, L=138), "0.04313",
     "bytes"),
    ("backward_dual_contract", dict(B=128, T=512, L=48), "0.0150", "bytes"),
    ("forward", dict(B=128, T=512, L=138), "0.03726", "operations"),
    ("forward", dict(B=128, T=512, L=48), "0.0075", "bytes"),
    ("backward", dict(B=128, T=512, L=138), "0.03726", "operations"),
    ("backward_dual", dict(B=128, T=512, L=138), "0.07451", "operations"),
    ("viterbi_dense_fwd", dict(B=64, T=512, L=48), "0.00376", "bytes"),
    ("viterbi_nstate_fwd", dict(B=64, T=512, L=138, ns=3), "0.01082",
     "bytes"),
    ("viterbi_traceback", dict(B=64, T=512), "0.00008", "bytes"),
    ("segmental_forward", SEG, "0.00901", "operations"),
    ("segmental_backward", SEG, "0.00901", "operations"),
    ("segmental_grad_message", SEG, "0.01886", "bytes"),
    ("segmental_grad", SEG, "0.02262", "bytes"),
    ("segmental_grad_contract", SEG, "0.00750", "bytes"),
    ("segmental_viterbi", SEG, "0.01127", "bytes"),
    ("segmental_viterbi_traceback", dict(B=128, T=512, L=48,
                                         segments=31020), "0.00197",
     "bytes"),
]


@pytest.mark.parametrize("name,shape,printed,by", TABLE,
                         ids=[f"{t[0]}-L{t[1].get('L', '')}" for t in TABLE])
def test_kernel_bounds_are_perf_mds(name, shape, printed, by):
    ms, bound_by = rl.bound(rl.kernel_phase(name, **shape))
    digits = len(printed.split(".")[1])
    assert f"{ms:.{digits}f}" == printed and bound_by == by


def test_every_kernel_has_a_count_and_steps_reuse_it():
    """One definition: the step models take their kernels' phases from
    ``kernel_phase``, the counts ``chip_smoke.py`` prints as bounds.  Its
    names are the wrappers' launch counters, ``kernels.<name>[...]``, as
    the wrappers' sources spell them."""
    from asr_craft_tpu_torch.kernels import (fdt_train, fdt_viterbi, fwdbwd,
                                             segmental, viterbi)
    names = set()
    for mod in (fdt_train, fdt_viterbi, fwdbwd, segmental, viterbi):
        names |= set(re.findall(r'"kernels\.(\w+)', inspect.getsource(mod)))
    assert names == set(rl.KERNELS)
    ph = {p.name: p for p in rl.scrf_train_phases(128, 512, 48, 144, 16)}
    k9 = rl.kernel_phase("segmental_forward", **SEG)
    assert (ph["scrf_forward"].bytes, ph["scrf_forward"].flops,
            ph["scrf_forward"].vpu_elems) == (k9.bytes, k9.flops,
                                              k9.vpu_elems)
    # the planes once a step, in the forward; K1's and K2's recursions
    # form none; the decode's forward is its planes and K3's recursion
    ph = {p.name: p for p in rl.fdt_train_phases(128, 512, 144, 144, 3)}
    k = {n: rl.kernel_phase(n, B=128, T=512, **FDT)
         for n in ("fdt_train_plane", "fdt_train_fwd", "fdt_train_bwd",
                   "fdt_train_contract")}
    assert k["fdt_train_fwd"].mma_flops == k["fdt_train_bwd"].mma_flops == 0
    for step, names in (("fdt_forward", ("fdt_train_plane", "fdt_train_fwd")),
                        ("fdt_backward_grad", ("fdt_train_bwd",
                                               "fdt_train_contract"))):
        for field in ("bytes", "flops", "vpu_elems", "mma_flops"):
            assert getattr(ph[step], field) == \
                sum(getattr(k[n], field) for n in names)
    assert ph["fdt_forward"].mma_flops == ph["fdt_backward_grad"].mma_flops \
        == k["fdt_train_plane"].mma_flops
    dec = {p.name: p for p in rl.fdt_decode_phases(64, 512, 144, 144, 3)}
    kd = [rl.kernel_phase(n, B=64, T=512, **FDT)
          for n in ("fdt_viterbi_plane", "fdt_viterbi_fwd")]
    assert dec["fdt_viterbi_forward"].bytes == sum(x.bytes for x in kd)
    assert dec["fdt_viterbi_forward"].mma_flops == kd[0].mma_flops
    # ragged batches and K13's walk count what the data needs
    full = rl.kernel_phase("segmental_forward", **SEG)
    half = rl.kernel_phase("segmental_forward", **SEG, frames=128 * 256)
    assert half.flops == full.flops / 2 and half.bytes == full.bytes
    few = rl.kernel_phase("segmental_viterbi_traceback", B=128, T=512, L=48,
                          segments=1000)
    assert few.flops == 1000 * 2.0 * 48


def test_tile_floors():
    """scrf_tile_floor: positive per-kernel floors, train = fwd + bwd +
    grad, decode = vit + tb; the recursions' floors inversely proportional
    to the measured rate, K9's window pass the heaviest; K11 walks no chain,
    so its floor is its parts' bound, which the rate does not move.
    fdt_tile_floor keeps vpu_ms and floor_ms; fma_ms stands where
    mxu_passes stood."""
    tile = rl.scrf_tile_floor(128, 512, 48, 16, vpu_geps=1500.0)
    k = tile["kernels_ms"]
    assert set(k) == {"fwd", "bwd", "grad", "vit", "tb"}
    assert all(v > 0 for v in k.values())
    assert math.isclose(tile["train_floor_ms"],
                        k["fwd"] + k["bwd"] + k["grad"], abs_tol=2e-3)
    assert math.isclose(tile["decode_floor_ms"], k["vit"] + k["tb"],
                        abs_tol=2e-3)
    assert k["fwd"] >= k["bwd"] > k["vit"] > k["grad"]
    parts = sum(rl.bound(rl.kernel_phase(n, **SEG))[0]
                for n in rl.SCRF_GRAD_PARTS)
    assert math.isclose(k["grad"], parts, abs_tol=1e-3)
    slow = rl.scrf_tile_floor(128, 512, 48, 16, vpu_geps=750.0)
    sk = slow["kernels_ms"]
    for name in ("fwd", "bwd", "vit"):
        assert math.isclose(sk[name], 2 * k[name], rel_tol=1e-2)
    assert sk["grad"] == k["grad"]
    assert tile["vpu_geps_used"] == 1500.0
    jax_keys = set(jrl.scrf_tile_floor(128, 512, 48, 16, vpu_geps=1500.0))
    assert set(tile) == jax_keys
    floor = rl.fdt_tile_floor(128, 512, 144, 144, 3, vpu_geps=1500.0)
    assert set(floor) == {"fma_ms", "vpu_ms", "floor_ms"}
    assert math.isclose(floor["floor_ms"], floor["fma_ms"] + floor["vpu_ms"],
                        abs_tol=2e-3)
    # the products of the step's planes (formed once) and of the contraction
    # (depth Du = 144) at the 3xTF32 rate; the multiply-adds of the two
    # recursions and the two bias adds (the contraction's column sum) at the
    # fp32 rate
    R, Du, dp = 3 * 144 + 48 * 48, 144, 2 * (2 * 144 + 48 * 48)
    mma = 128 * 512 * 2 * 2.0 * R * Du
    flops = 128 * 512 * (8 * dp + 2 * R)
    assert math.isclose(floor["fma_ms"],
                        (mma / 165e12 + flops / 67e12) * 1e3, abs_tol=1e-3)


def test_calibrate_phase_counts_the_chain():
    phase, (ms, by) = rl.calibrate_phase(16, 48, 128, 16, 32, 256)
    elems = 16 * 48 * 128
    assert phase.vpu_elems == 8192 * 16 * elems == 12884901888
    assert by == "operations" and phase.bytes == 4 * (48 * 128 + elems)
    fma, exps = 8192 * 14 * elems, 8192 * 2 * elems
    want = ((2 * fma + exps) / 67e12 + exps / (132 * 16 * 1.98e9)) * 1e3
    assert math.isclose(ms, want, rel_tol=1e-12)
    half, _ = rl.calibrate_phase(8, 48, 128, 16, 32, 256)
    assert half.vpu_elems == phase.vpu_elems / 2


def test_measure_stream_bw_on_the_cpu_is_clamped_to_the_spec():
    slow = rl.ChipSpec("slow", 1e-3, 1.0, 1.0)
    assert rl.measure_stream_bw(n_mb=1, iters=2, spec=slow,
                                device="cpu") == 1e-3
    assert rl.measure_stream_bw(n_mb=1, iters=2, device="cpu") > 0


def test_products_are_held_to_the_3xtf32_rate():
    """A phase's ``mma_flops`` (products the tensor cores run at fp32
    accuracy by 3xTF32) are held to a third of the TF32 rate, its other
    FLOPs to the fp32 rate, its bytes to the memory rate; the bound is the
    largest, and a phase without products keeps the JAX arithmetic."""
    ph = rl.Phase("p", bytes=3.35e9, flops=6.7e10, mma_flops=3.3e11)
    assert math.isclose(ph.sol_s(), 2e-3, rel_tol=1e-12)
    ms, by = rl.bound(ph)
    assert math.isclose(ms, 2.0, rel_tol=1e-12) and by == "operations"
    ms, by = rl.bound(rl.Phase("p", 3.35e10, 6.7e10, 0.0, 3.3e11))
    assert math.isclose(ms, 10.0, rel_tol=1e-12) and by == "bytes"
    # a spec without tensor cores runs the products at its fp32 rate
    slow = rl.ChipSpec("slow", 1.0, 1.0, 1.0)
    assert rl.Phase("p", 0.0, 0.0, 0.0, 2e12).sol_s(slow) == 2.0
    # the plane kernel (under both its keys) and K2's contraction: a product
    # of depth Du = 144 and an add a row for the bias column (the
    # contraction's column sum)
    for name in ("fdt_train_plane", "fdt_viterbi_plane",
                 "fdt_train_contract"):
        k = rl.kernel_phase(name, B=128, T=512, **FDT)
        assert k.flops == 128 * 512 * 2736.0
        assert k.mma_flops == 128 * 512 * 2.0 * 2736 * 144


def test_k5_is_a_recursion_and_a_tensor_core_contraction():
    """K5's recursion writes g_state and the rows U, V of both lattices and
    does the two lattices' (L) x (L, L) products a frame, no outer product;
    its contraction reads the rows of the frames with a successor and holds
    their product to the 3xTF32 rate; the shared train step's
    ``dual_backward_grad`` is the two together."""
    B, T, L = 128, 512, 138
    rec = rl.kernel_phase("backward_dual_grad", B=B, T=T, L=L)
    con = rl.kernel_phase("backward_dual_contract", B=B, T=T, L=L)
    assert rec.flops == B * T * 2 * 2.0 * L * L and rec.mma_flops == 0
    rows = 2 * B * (T - 1)
    assert con.mma_flops == rows * 2.0 * L * L and con.flops == 0
    assert con.bytes == 4 * (2 * rows * L + L * L)
    assert rec.bytes == 4 * (8 * B * T * L + B * T + L * L + L + 2 * B)
    ph = {p.name: p for p in rl.train_step_phases(B, T, L, 3 * L)}
    for field in ("bytes", "flops", "vpu_elems", "mma_flops"):
        assert getattr(ph["dual_backward_grad"], field) == \
            getattr(rec, field) + getattr(con, field)
    ms, by = rl.bound(con)
    assert by == "bytes" and ms > con.mma_flops / 165e12 * 1e3
    # a ragged batch counts the frames that exist, each row's last one
    # without a successor
    few = rl.kernel_phase("backward_dual_contract", B=B, T=T, L=L,
                          frames=B * 100)
    assert few.mma_flops == 2 * B * 99 * 2.0 * L * L


@pytest.mark.parametrize("name,per_label", [
    ("forward", 18.0), ("backward", 18.0), ("forward_dual", 39.0),
    ("backward_dual", 39.0), ("backward_dual_grad", 56.0)])
def test_fb_element_operations_are_the_recount(name, per_label):
    """The recursions' element operations a frame: the recounted inventory a
    label beside one element operation a multiply-add of the products (one
    a lattice)."""
    B, T, L = 4, 16, 48
    products = 1 if name in ("forward", "backward") else 2
    ph = rl.kernel_phase(name, B=B, T=T, L=L)
    assert ph.vpu_elems == B * T * (per_label * L + products * L * L)


def test_k11_is_three_frame_parallel_parts():
    """K11's message pass, xi pass and contraction each have a count; the
    contraction's product is held to the 3xTF32 rate over the rows with a
    successor frame; the step's ``scrf_grad`` is the three together."""
    msg, xi, con = (rl.kernel_phase(n, **SEG) for n in rl.SCRF_GRAD_PARTS)
    B, T, L, Dmax = 128, 512, 48, 16
    assert con.mma_flops == B * (T - 1) * 2.0 * L * L and con.flops == 0
    assert con.bytes == 4 * (2 * B * (T - 1) * L + L * L)
    assert msg.flops == B * T * (2.0 * L * L + 8 * L) and msg.mma_flops == 0
    assert msg.bytes == 4 * (B * T * (4 * L + 48 + 1) + L * L + L + B)
    assert xi.flops == B * T * 14.0 * Dmax * L and xi.mma_flops == 0
    assert xi.vpu_elems == B * T * 14.0 * Dmax * L
    ph = {p.name: p for p in rl.scrf_train_phases(B, T, L, 144, Dmax)}
    for field in ("bytes", "flops", "vpu_elems", "mma_flops"):
        assert getattr(ph["scrf_grad"], field) == sum(
            getattr(p, field) for p in (msg, xi, con))
    # L not a multiple of 4: E and F move rows of L4 floats
    odd = rl.kernel_phase("segmental_grad", B=2, T=8, L=5, Dmax=3)
    assert odd.bytes == 4 * (2 * 8 * (5 * 5 + 8 + 1) + 2 * 3 * 5 + 3 + 6)
    half = rl.kernel_phase("segmental_grad_contract", **SEG,
                           frames=B * 256)
    assert half.mma_flops == B * 255 * 2.0 * L * L


@pytest.mark.parametrize("name,per_term,per_label,products", [
    ("fwd", 7.0, 22.0, 3), ("bwd", 7.0, 22.0, 3), ("grad", 14.0, 0.0, 0),
    ("vit", 7.0, 19.0, 2)])
def test_scrf_passes_are_the_recount(name, per_term, per_label, products):
    """The segmental inventories a frame: K9 and K10 (its mirror) walk
    their window once and exponentiate the row in every group of one
    destination; K12 takes its lane's first argmax in one pass and a
    max-plus product; K11's xi pass has no row work."""
    assert rl._SCRF_PASSES[name] == (per_term, per_label, products)
    key = {"fwd": "segmental_forward", "bwd": "segmental_backward",
           "vit": "segmental_viterbi", "grad": "segmental_grad"}[name]
    ph = rl.kernel_phase(key, B=2, T=8, L=6, Dmax=3)
    assert ph.vpu_elems == 16 * (per_term * 3 * 6 + per_label * 6
                                 + products * 36)


def test_viterbi_counts_the_rescans_and_the_beam_selection():
    """K8's dead destinations each take a dense column of L' adds and
    compares; a beam width adds its cut's radix select a frame (32 rounds
    over the row), to K7 and K8 alike; neither moves the exact bounds."""
    shape = dict(B=64, T=512, L=138, ns=3)
    frames = 64 * 512
    base = rl.kernel_phase("viterbi_nstate_fwd", **shape)
    res = rl.kernel_phase("viterbi_nstate_fwd", rescans=2944, **shape)
    assert res.flops - base.flops == 2944 * 2.0 * 138
    assert res.bytes == base.bytes
    sel = rl.kernel_phase("viterbi_nstate_fwd", beam_width=16, **shape)
    assert sel.flops - base.flops == frames * 32 * 2.0 * 138
    dense = rl.kernel_phase("viterbi_dense_fwd", B=64, T=512, L=48)
    dsel = rl.kernel_phase("viterbi_dense_fwd", B=64, T=512, L=48,
                           beam_width=16)
    assert dsel.flops - dense.flops == frames * 32 * 2.0 * 48
    # a beam as wide as the row selects nothing
    assert rl.kernel_phase("viterbi_dense_fwd", B=64, T=512, L=48,
                           beam_width=48).flops == dense.flops
    assert rl.bound(res) == rl.bound(base)
    assert rl.bound(base)[1] == "bytes"
