"""The reduction of a device trace to busy time, groups and idle gaps, on
intervals worked out by hand."""

import pytest

from benchmark import devtrace


def test_summary_by_hand():
    # window 0..100 us (spans in ns); kernels: 10-30 and 20-40 overlap
    # (busy 30), 60-70 (busy 10), 95-120 clipped to 95-100 (busy 5)
    kernels = [("elementwise_kernel", 10.0, 30.0),
               ("sm90_xmma_gemm", 20.0, 40.0),
               ("mca_partial", 60.0, 70.0),
               ("reduce_kernel", 95.0, 120.0),
               ("before", -50.0, -10.0)]
    main, feeder = 1, 2
    spans = [("window", main, 0, 100_000),
             ("dispatch", main, 0, 45_000),
             ("fetch", main, 45_000, 90_000),
             ("feed", feeder, 0, 100_000)]
    s = devtrace.summary(kernels, spans)
    assert s["busy_s"] == pytest.approx(45e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["by_group"]["elementwise"] == pytest.approx(20e-6)
    assert s["by_group"]["matmuls (cuBLAS)"] == pytest.approx(20e-6)
    assert s["by_group"]["masked_attention kernel"] == pytest.approx(10e-6)
    assert s["by_group"]["reductions"] == pytest.approx(5e-6)
    # gaps: 0-10 (dispatch), 40-60 (mid 50: fetch), 70-95 (mid 82.5:
    # fetch)
    gaps = [(n, round(t * 1e6, 6)) for n, t in s["gaps"]]
    assert gaps == [("dispatch", 10.0), ("fetch", 20.0), ("fetch", 25.0)]
    b = devtrace.breakdown(s)
    assert b["idle_gaps"][0] == ["fetch", pytest.approx(25e-6)]
    assert b["device_ops"][0][0] in ("elementwise", "matmuls (cuBLAS)")
    assert devtrace.kernel_seconds(s, ("mca_",)) == pytest.approx(10e-6)


def test_no_window_refused():
    with pytest.raises(ValueError):
        devtrace.summary([("k", 0.0, 1.0)], [("dispatch", 1, 0, 10)])
