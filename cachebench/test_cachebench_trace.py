"""The trace reduction and the readers over a synthetic slice: busy time
is the union of the device's operations, idle gaps are named by the host
stage they began in, and a reader with nothing to read returns None."""
import dataclasses

import pytest

from cachebench import counts, devtrace, harness, metrics
from cachebench.metrics import (decode_attn_roofline, embed_ms,
                                flash_attn_roofline, idle_share, step_mfu)

MODEL = {"n_layers": 2, "d_model": 16, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 8, "d_ff": 24, "vocab": 40}
DEPLOY = {"max_prompt_len": 4, "max_new_tokens": 3}


def _slice():
    sl = devtrace.Slice(t0=10.0, t1=11.0)
    sl.ops = [("flash_attention_bf16_kernel", 10.1, 10.2),
              ("decode_tc_kernel", 10.15, 10.3),      # overlaps the first
              ("decode_merge_kernel", 10.5, 10.6),
              ("nvjet_gemm", 10.8, 10.9)]
    return sl


def _served(t0, t1, misses):
    return harness.Served([None] * 4, [], t0, t1, None, [None] * misses,
                          {"embed": 0.05, "backend_call": 0.3})


def _view(sl, batches):
    cell = harness.Cell("c", {}, {"model": MODEL, "deploy": DEPLOY}, {}, [])
    return harness.TraceView(cell, batches, [], sl, batches)


def test_busy_is_the_union():
    sl = _slice()
    assert sl.busy_s() == pytest.approx(0.2 + 0.1 + 0.1)
    assert sl.time_of(lambda n: "decode_" in n) == pytest.approx(0.25)
    assert sl.top_ops(2)[0][0] == "decode_tc_kernel"


def test_idle_gaps_named_by_host_stage():
    sl = _slice()
    host = [("embed", 10.0, 10.05), ("backend_call", 10.05, 10.7)]
    gaps = dict((round(s, 6), n) for n, s in sl.idle_gaps(host))
    assert gaps[0.2] == "backend_call"            # 10.3 -> 10.5
    assert gaps[0.1] in ("embed", "between_batches")
    assert max(gaps) == pytest.approx(0.2)


def test_readers():
    sl = _slice()
    b = [_served(10.0, 10.95, 3)]
    v = _view(sl, b)
    assert idle_share.read(v) == pytest.approx(60.0)
    pre, dec = counts.attention_bounds(MODEL, 3, 4, 3)
    assert flash_attn_roofline.read(v) == pytest.approx(100 * pre / 0.1)
    assert decode_attn_roofline.read(v) == pytest.approx(100 * dec / 0.25)
    want = counts.generate_flops(MODEL, 3, 4, 3) / (
        0.95 * counts.PEAK_BF16_FLOPS) * 100
    assert step_mfu.read(v) == pytest.approx(want)
    assert embed_ms.read(v) == pytest.approx(50.0)


def test_nothing_to_read_is_none():
    v = _view(None, [])
    for mod in (idle_share, flash_attn_roofline, decode_attn_roofline,
                step_mfu, embed_ms):
        assert mod.read(v) is None
    empty = dataclasses.replace(_view(devtrace.Slice(t0=0.0, t1=1.0),
                                      [_served(0.0, 0.5, 0)]))
    assert flash_attn_roofline.read(empty) is None
    assert idle_share.read(empty) is None


def test_a_tail_read_per_layer_is_the_windows_own():
    """``resp_p50_ms.qps`` and ``resp_p95_ms.qps`` give the window's tails
    as ``harness.end_to_end`` took them, and nothing where there are none."""
    v = _view(None, [])
    for q in ("50", "95"):
        reader = metrics.load(f"resp_p{q}_ms.qps")
        assert reader.read(v) is None
        v.end_to_end = {"resp_p50_ms": 812.5, "resp_p95_ms": 1402.25}
        assert reader.read(v) == v.end_to_end[f"resp_p{q}_ms"]
        v.end_to_end = {}


def test_a_split_reader_reads_as_its_original():
    sl = _slice()
    v = _view(sl, [_served(10.0, 10.95, 3)])
    for m in (idle_share, flash_attn_roofline, decode_attn_roofline,
              step_mfu, embed_ms):
        name = m.__name__.rsplit(".", 1)[1]
        assert metrics.load(f"{name}.qps").read(v) == m.read(v)
