"""The per-layer metrics' arithmetic on a synthetic trace: the idle share
from the union of device intervals, the roofline shares from known counts,
the grouping of kernel names, and the breakdown.

    python -m pytest crfbench/tests -q
"""
import json
from pathlib import Path

import pytest

from crfbench import harness, roofline

ROOT = Path(__file__).resolve().parent.parent.parent


def _cell(name):
    return harness.load_cell(name, 1, 10.0, True, root=ROOT)


def _ctx(cell, device, span, calls, host=()):
    return {"cell": cell, "trace": {"device": device, "host": list(host),
                                    "span_s": span, "calls": calls}}


PLANE = ("void (anonymous namespace)::fdt_train_plane_kernel<1>"
         "(float const*, float*, int)")


def test_kernel_names_lose_void_namespaces_templates_and_arguments():
    assert harness.base_name(PLANE) == "fdt_train_plane_kernel"
    assert harness.base_name("void fdtk::sum_partials_kernel(float*)") == \
        "sum_partials_kernel"
    assert harness.base_name("ncclDevKernel_AllReduce_Sum_f32_RING_LL("
                             "ncclDevComm*)") == \
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL"
    assert harness.short_name(PLANE) == "fdt_train_plane_kernel<1>"


def test_idle_is_one_minus_the_union_over_the_span():
    read = harness.metric_reader("idle_pct.train")
    # overlapping intervals count once: busy [0, 3] and [5, 6] of 10
    dev = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0)]
    v = read(_ctx(_cell("triphone-train"), dev, 10.0, [{"steps": []}]))
    assert v == pytest.approx(60.0)
    assert harness.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4.0
    assert harness.idle_gaps([(0, 2), (1, 3), (5, 6)], 10.0) == \
        [(3, 5), (6, 10.0)]


def test_a_reader_with_nothing_to_read_returns_none():
    cell = _cell("triphone-train")
    for name in ("idle_pct.train", "mfu_pct.train", "sol_pct.fdt_train",
                 "glue_pct.train"):
        assert harness.metric_reader(name)(_ctx(cell, [], 1.0, [])) is None


def test_sol_and_mfu_from_known_counts():
    cell = _cell("triphone-train")
    B, T, f = 128, 512, 50_000
    shape = dict(B=B, T=T, L=144, D=144, ns=3, frames=f)
    least = sum(roofline.kernel_phase(k, **shape).sol_seconds("bf16x3")
                for k in ("fdt_train_plane", "fdt_train_fwd",
                          "fdt_train_bwd", "fdt_train_contract"))
    # the group took 4 x its least time, split over its five kernels
    names = ["fdt_train_plane_kernel<1>", "fdt_train_fwd_kernel",
             "fdt_train_bwd_kernel", "fdt_train_contract_kernel<1>",
             "fdt_train_sum_kernel"]
    each = 4 * least / 5
    dev = [(f"void {n}(float*)", i * each, (i + 1) * each)
           for i, n in enumerate(names)]
    dev.append(("void at::native::vectorized_elementwise_kernel<4>(int)",
                5 * each, 5 * each + least))
    calls = [{"steps": [(T, f)]}]
    ctx = _ctx(cell, dev, 10 * least, calls)
    assert harness.metric_reader("sol_pct.fdt_train")(ctx) == \
        pytest.approx(25.0)
    ops = sum(p.op_seconds("bf16x3")
              for p in roofline.fdt_train_phases(B, T, 144, 144, 3, f))
    assert harness.metric_reader("mfu_pct.train")(ctx) == \
        pytest.approx(100 * ops / (10 * least))
    # glue: the elementwise kernel, one of five least times of busy
    assert harness.metric_reader("glue_pct.train")(ctx) == \
        pytest.approx(100 * least / (5 * least))


def test_the_products_run_at_the_precisions_rate():
    p = roofline.Phase("x", 0.0, 0.0, 989e12 / 3)
    assert p.op_seconds("bf16x3") == pytest.approx(1.0)
    assert p.op_seconds("highest") == pytest.approx(989 / 495)
    assert p.op_seconds("default") == pytest.approx(989 / 3 / 495)


def test_segmental_traceback_bytes_follow_the_segments():
    few = roofline.kernel_phase("segmental_viterbi_traceback", B=2, T=8,
                                L=4, segments=3)
    many = roofline.kernel_phase("segmental_viterbi_traceback", B=2, T=8,
                                 L=4, segments=9)
    assert many.bytes - few.bytes == 6 * 4 * (1 + 4)


def test_the_breakdown_names_device_ops_and_what_the_host_did():
    trace = {"device": [(PLANE, 0.0, 2.0), (PLANE, 4.0, 5.0)],
             "host": [("cudaGraphLaunch", 1.5, 3.5),
                      ("aten::copy_", 2.5, 3.2)],
             "span_s": 6.0, "calls": []}
    b = harness.breakdown(trace)
    assert b["device_ops"] == [["fdt_train_plane_kernel<1>", 3.0]]
    # gap [2, 4]: its middle 3.0 lies in the copy (the innermost range);
    # gap [5, 6]: no host range
    assert b["idle_gaps"] == [["aten::copy_", 2.0], ["python", 1.0]]


def test_every_per_layer_metric_has_its_reader():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_the_ports_kernels_are_read_from_its_sources(tmp_path):
    from crfbench import readers
    names = readers.port_kernels()
    assert {"fdt_train_plane_kernel", "fdt_vit_tb_kernel", "seg_xi_kernel",
            "fb_contract_kernel", "sum_partials_kernel",
            "vit_dense_wide_kernel"} <= names
    assert len(names) >= 24
    (tmp_path / "a.cu").write_text(
        "template <int N>\n__global__ void __launch_bounds__(f(N), G<1, 2>::X)"
        "\nnew_kernel(const float* x) {}\n"
        "static __global__ void plain_kernel(int n) {}\n"
        "__device__ void not_a_kernel(int n) {}\n")
    assert readers.port_kernels(tmp_path) == {"new_kernel", "plain_kernel"}
