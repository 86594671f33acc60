"""Each per-layer reader on a small synthetic profiler trace whose answer
is worked out by hand."""

import pytest

from gsbench import counts, harness
from gsbench.trace import STRETCH, Event, Stretch, family, kernel_of

K1 = ("void gst::sm90::(anonymous namespace)::conv3x3_sm90_kernel<16, 2, "
      "32, 1>(gst::sm90::(anonymous namespace)::Args)")
K2 = ("void gst::sm90::(anonymous namespace)::conv3x3_sm90_kernel<16, 2, "
      "32, 2>(gst::sm90::(anonymous namespace)::Args)")
K3 = ("void gst::sm90::(anonymous namespace)::conv3x3_sm90_kernel<32, 1, "
      "16, 3>(gst::sm90::(anonymous namespace)::Args)")
FINISH = "void gst::tc::conv3x3_tc_finish_kernel<false>(gst::tc::Args, int, int)"
GLUE = ("void at::native::vectorized_elementwise_kernel<4, "
        "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >")
LIB = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
WGRAD = "void wgrad_alg0_engine_NHWC<float, 128, 5, 5, 3, 3, 3, false, 512>"
COPY = "Memcpy DtoH (Device -> Pinned)"


def dev(name, a, b):
    return Event(name, True, float(a), float(b))


def host(name, a, b):
    return Event(name, False, float(a), float(b))


def trace(body):
    """A 1000 µs stretch of 2 units: ``body`` (K1 or K3) with a split-K
    finish, glue, a library conv, two kernel-2 bodies, a copy overlapped by
    glue on another stream, an idle gap while the host launches a graph,
    an op that starts before the stretch and one that ends after it."""
    return [
        host(STRETCH, 0, 1000), host("cudaGraphLaunch", 490, 620),
        host("aten::empty", 170, 230),
        dev("gsbench.epoch", 0, 1000),          # an annotation range
        dev(GLUE, -50, 20),                     # starts before the stretch
        dev(body, 10, 110), dev(FINISH, 110, 130), dev(GLUE, 130, 180),
        dev(LIB, 200, 300), dev(K2, 300, 400), dev(COPY, 400, 450),
        dev(GLUE, 420, 500), dev(K2, 600, 700), dev(GLUE, 700, 1100)]


def record(cell, body, spans=None):
    r = harness.Record(harness.load_cell(cell), spans=spans or {},
                       counters={"samples_per_unit": 8 if "gen" in cell
                                 else 1})
    r.stretch = Stretch(trace(body), units=2)
    return r


def read(metric, rec):
    return harness.load_metric(metric).read(rec)


def test_names_map_to_kernels_and_families():
    assert kernel_of(K1) == "k1" and kernel_of(K2) == "k2"
    assert kernel_of(K3) == "k3" and kernel_of(GLUE) is None
    assert [family(n) for n in (K1, FINISH, GLUE, LIB, WGRAD, COPY)] == \
        ["kernel", "kernel", "glue", "library", "library", "copy"]


def test_busy_union_and_gaps():
    st = record("ffhq1024-gen-b8", K1).stretch
    # busy [0,180] [200,500] [600,1000] of the 1000 µs: overlaps once
    assert st.busy_seconds() == pytest.approx(880e-6)
    assert st.idle_gaps() == [(180.0, 200.0), (500.0, 600.0)]
    assert st.top_gaps() == [["cudaGraphLaunch", pytest.approx(100e-6)],
                             ["aten::empty", pytest.approx(20e-6)]]
    assert st.seconds == pytest.approx(1e-3)


def test_gen_readers():
    rec = record("ffhq1024-gen-b8", K1, spans={"enqueue": [1e-3, 3e-3]})
    gen = rec.cell.config
    assert read("enqueue_ms.gen", rec) == pytest.approx(2.0)
    # kernels that start inside: K1, finish, 3 glue, lib, 2 K2 (not the copy)
    assert read("launches_per_batch.gen", rec) == pytest.approx(8 / 2)
    assert read("glue_ms_per_batch.gen", rec) == \
        pytest.approx((50 + 80 + 400) / 1e3 / 2)
    assert read("device_idle.gen", rec) == pytest.approx(12.0)
    b1 = counts.kernel1_bound_ms(gen["gan"], 8, "bf16")
    assert read("k1_roofline.gen", rec) == \
        pytest.approx(100 * b1 * 1 / 9 / 0.120)
    b2 = counts.kernel2_bound_ms(gen["decoder"], 4, 8, "bf16")
    assert read("k2_roofline.gen", rec) == \
        pytest.approx(100 * b2 * 2 / 26 / 0.200)
    flop = counts.generate_flop_per_sample(gen)
    assert read("mfu.gen", rec) == \
        pytest.approx(100 * flop * 8 * 2 / 1e-3 / 989e12)


def test_fit_readers():
    rec = record("ffhq1024-fit-b1", K3)
    fit = rec.cell.config
    assert read("glue_ms_per_step.fit", rec) == \
        pytest.approx((50 + 80 + 400) / 1e3 / 2)
    assert read("device_idle.fit", rec) == pytest.approx(12.0)
    b3 = counts.kernel3_bound_ms(fit["decoder"], 4, 1)
    assert read("k3_roofline.fit", rec) == \
        pytest.approx(100 * b3 * 1 / 38 / 0.120)
    flop = counts.train_flop_per_sample(fit)
    assert read("mfu.fit", rec) == \
        pytest.approx(100 * flop * 2 / 1e-3 / (495e12 / 3))


@pytest.mark.parametrize("metric", [
    "enqueue_ms.gen", "launches_per_batch.gen", "glue_ms_per_batch.gen",
    "k1_roofline.gen", "k2_roofline.gen", "device_idle.gen", "mfu.gen"])
def test_nothing_to_read(metric):
    """No stretch, or one without a device operation (a CPU run): no
    number, never a 0 share."""
    rec = harness.Record(harness.load_cell("ffhq1024-gen-b8"),
                         counters={"samples_per_unit": 8})
    assert read(metric, rec) is None
    rec.stretch = Stretch([host(STRETCH, 0, 10)], units=1)
    assert read(metric, rec) is None


def test_absent_kernel_reads_nothing():
    rec = record("ffhq1024-gen-b8", K3)   # no kernel-1 launch in it
    assert read("k1_roofline.gen", rec) is None


def test_taps_kernel_goes_to_the_body_after_it():
    events = [host(STRETCH, 0, 100),
              dev("void gst::tf32_taps_kernel(float const*, float*, int, "
                  "int)", 0, 10),
              dev(K1.replace(", 1>", ", 9>"), 10, 50), dev(GLUE, 50, 60)]
    st = Stretch(events, units=1)
    assert [e.start for e in st.kernel_ops("k1")] == [10.0, 0.0]
