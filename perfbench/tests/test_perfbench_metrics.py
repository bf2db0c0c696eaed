"""Each per-layer metric's reader on a small recorded trace."""
import pytest

from perfbench import core
from perfbench.run import read_metric

# two 100 ms units; kernels in microseconds: an attention forward of 30 ms,
# a dq and a dk/dv of 10 ms each, a CE forward of 5 ms, a GEMM of 20 ms
# overlapping nothing, an NCCL all-reduce of 8 ms of which 3 ms overlap the GEMM
KERNELS = [("void flash64_fwd_kernel<64, false>(x)", 0, 30_000),
           ("void flash64_dq_kernel<64>(x)", 30_000, 40_000),
           ("void flash64_dkv_kernel<64, true, false, false>(x)", 40_000, 50_000),
           ("void flash_ce_fwd_kernel<768>(x)", 50_000, 55_000),
           ("sm90_xmma_gemm_bf16", 60_000, 80_000),
           ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 77_000, 85_000)]
HOST = [("perfbench:decode", 50_000, 200_000), ("cudaMemcpyAsync", 56_000, 59_000)]
TRACE = core.Trace(KERNELS, HOST, wall_s=0.2)


def layer(**kw):
    base = {"trace": TRACE, "traced_units": 2, "untraced_unit_s": 0.1, "traced_steps": 2,
            "work": {"attn_fwd_bound_s": 0.015, "attn_bwd_bound_s": 0.005,
                     "ce_fwd_bound_s": 0.004},
            "batches": [{"tokenize_s": 0.1, "generate_s": 0.5, "decode_s": 0.3},
                        {"tokenize_s": 0.3, "generate_s": 0.7, "decode_s": 0.5}],
            "intervals": [0.3, 0.5], "step_s": [0.25, 0.35], "chips": 4,
            "untraced_s": 2.0, "untraced_flops": 989e12 * 0.5,
            "peak_flops": 989e12}
    base.update(kw)
    return base


@pytest.mark.parametrize("name,value", [
    ("tokenize_ms.serve", 200.0), ("generate_ms.serve", 600.0), ("decode_ms.serve", 400.0),
    ("mfu.serve", 25.0), ("mfu.train", 6.25),
    ("data_wait_ms.train", 100.0), ("step_fn_ms.train", 300.0),
    # busy: 0-55 ms and 60-85 ms = 80 ms over 2 units of 100 ms
    ("idle_share.serve", 60.0), ("idle_share.train", 60.0),
    ("attn_fwd_roofline.serve", 50.0),           # 15 ms over 30 ms
    ("attn_roofline.train", 40.0),               # 20 ms over 50 ms
    ("ce_fwd_roofline.train", 80.0),             # 4 ms over 5 ms
    ("comm_exposed_ms.train", 2.5),              # 5 ms exposed over 2 steps
])
def test_reader_on_a_recorded_trace(name, value):
    assert read_metric(name, layer()) == pytest.approx(value)


@pytest.mark.parametrize("name", ["attn_fwd_roofline.serve", "attn_roofline.train",
                                  "ce_fwd_roofline.train", "comm_exposed_ms.train",
                                  "idle_share.serve", "idle_share.train"])
def test_reader_with_nothing_to_read_returns_nothing(name):
    empty = core.Trace([("sm90_xmma_gemm_bf16", 0, 10)], [], wall_s=0.1)
    got = read_metric(name, layer(trace=None))
    assert got is None
    if "roofline" in name or "comm" in name:
        assert read_metric(name, layer(trace=empty)) is None


def test_trace_breakdown_names_gaps_by_the_host_span():
    gaps = TRACE.idle_gaps()
    assert gaps == [["perfbench:decode / cudaMemcpyAsync", pytest.approx(0.005)]]
    ops = TRACE.device_ops()
    assert ops[0][0] == "void flash64_fwd_kernel<64, false>(x)" and ops[0][1] == 0.03
    assert TRACE.busy_us() == 80_000


def test_window_closes_after_the_first_unit_past_its_length(monkeypatch):
    clock = iter([0.0, 0.4, 0.9, 1.3, 1.4])
    monkeypatch.setattr(core.time, "perf_counter", lambda: next(clock))
    w = core.Window(1.0)
    w.open()
    assert [w.mark(), w.mark(), w.mark()] == [False, False, True]
    assert w.length == 1.3 and w.intervals == pytest.approx([0.4, 0.5, 0.4])
    assert core.percentile([1.0, 2.0, 3.0, 4.0], 90) == pytest.approx(3.7)
