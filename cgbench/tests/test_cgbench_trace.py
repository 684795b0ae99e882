"""Reading a trace: busy time is the union of device operations, and an
idle gap is charged to the innermost host operation open when it began,
else to the innermost harness span."""
from cgbench.harness import trace


def test_merge_is_a_union():
    assert trace._merge([(5, 7), (0, 2), (1, 3), (6, 9)]) == [[0, 3], [5, 9]]


def test_gap_charged_to_innermost_open_host_op():
    host = [(0, 100, "cgbench.window"), (50, 60, "cgbench.slot"),
            (70, 71, "aten::y")]
    host += [(1 + 0.1 * i, 1.05 + 0.1 * i, "aten::x") for i in range(300)]
    host.sort()
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2].startswith("cgbench.")]
    assert trace._open_at(host, starts, spans, 70.5) == "aten::y"
    assert trace._open_at(host, starts, spans, 55) == "cgbench.slot"
    assert trace._open_at(host, starts, spans, 1.02) == "aten::x"
    assert trace._open_at(host, starts, spans, 40) == "cgbench.window"
    assert trace._open_at(host, starts, spans, 200) == "(no host op)"


def test_kernel_time_matches_by_pattern():
    t = trace.Trace(window_s=1.0, busy_s=0.5, kernels={
        "void porc_assign_kernel<true>(int)": (3, 0.3),
        "void porc_multisource_cluster_kernel<true, true, true>(A)": (2, 0.1),
        "void porc_multisource_cluster_kernel<false, true, true>(A)": (4, 0.2)})
    assert trace.Trace.kernel_time(t, r"porc_multisource_cluster_kernel<true") \
        == (2, 0.1)
    assert trace.Trace.kernel_time(t, r"porc_assign_kernel") == (3, 0.3)
    assert trace.Trace.kernel_time(t, r"nothing") == (0, 0)
