"""The yardstick's arithmetic against hand-worked values at the cells'
shapes: rates, times per step and tails over all requests; the roofline
and whole-step work counts."""

import json

import pytest

from perfbench import costs, manifest as mf, tally

YI = json.loads((mf.BENCH_DIR / "configs/yi-6b.json").read_text())["model"]
MAMBA = json.loads(
    (mf.BENCH_DIR / "configs/mamba2-370m.json").read_text())["model"]


def test_percentile_is_nearest_rank_over_all_values():
    values = list(range(1, 201))            # 200 requests
    assert tally.percentile(values, 95) == 190
    assert tally.percentile([5.0], 95) == 5.0
    # 35 batches of 4 requests: the tail is a batch's, counted 4 times
    batches = [float(i) for i in range(35)]
    per_request = [b for b in batches for _ in range(4)]
    assert tally.percentile(per_request, 95) == 33.0
    with pytest.raises(ValueError):
        tally.percentile([], 95)


def test_rates_and_steps_take_all_work_over_all_time():
    assert tally.rate(32 * 128 * 3, 12.0) == 1024.0
    assert tally.per_step(3.2 * 3, 128 * 3) == pytest.approx(0.025)


def test_metric_readers_on_a_record():
    rec = {"batches": [{"ttft_s": 0.5, "decode_s": 1.6, "prefill_s": 0.4,
                        "batch_s": 2.0}] * 3 + [
                       {"ttft_s": 0.7, "decode_s": 1.6, "prefill_s": 0.6,
                        "batch_s": 2.2}],
           "window_s": 8.2, "setup_s": 9.0}
    ctx = {"traffic": {"batch": 4, "gen": 16, "prompt": 4096,
                       "layer_budget": None}, "head": {"m": 2},
           "model": YI}
    read = lambda n: mf.reader(n)(rec, ctx)
    assert read("ttft_ms_p95") == pytest.approx(700.0)
    assert read("tpot_ms") == pytest.approx(100.0)
    assert read("output_tokens_per_s") == pytest.approx(4 * 16 * 4 / 8.2)
    assert read("prefill_ms.long") == pytest.approx(450.0)
    assert read("setup_s") == 9.0
    assert read("decode_device_ms") is None     # nothing traced


def test_parameter_counts_of_the_configurations():
    # yi-6b: 32 layers of 173.0 M weights, embedding and head 262.1 M each
    assert costs.layer_weights(YI) == 173_015_040
    assert costs.num_params(YI) == 6_061_035_520
    # mamba2-370m: 48 layers, tied 51.5 M embedding
    assert costs.layer_weights(MAMBA) == 1024 * (2 * 2048 + 256 + 32) \
        + 2048 * 1024
    assert 365e6 < costs.num_params(MAMBA) < 375e6


def test_flash_work_at_the_long_prompt_shape():
    B, S, H, kv, dh = 4, 4096, 32, 4, 128
    pairs = S * (S + 1) // 2
    assert costs.flash_flops(B, S, S, H, dh, True, None) == \
        4.0 * dh * pairs * B * H
    ms, by = costs.flash_bound(B, S, S, H, kv, dh, True, None, 2,
                               costs.PEAK_BF16_FLOPS)
    assert by == "operations"
    assert ms == pytest.approx(4.0 * dh * pairs * B * H / 989e12 * 1e3)


def test_ssd_work_at_the_first_res_shape():
    B, nc, l, H, P, N = 64, 4, 256, 32, 64, 128
    pairs = l * (l + 1) // 2
    want = 2.0 * pairs * N * B * nc + (2.0 * pairs * P + 4.0 * l * N * P) \
        * B * H * nc
    assert costs.ssd_flops(B, nc, l, H, P, N) == want
    ms, _ = costs.ssd_bound(B, nc, l, H, P, N, costs.PEAK_BF16_FLOPS)
    assert ms > 0


def test_yi_chat_decode_step_is_bound_by_bytes():
    # batch 32 at context 1088: 11.07 GB of bf16 weights, 0.52 GB of head
    # planes at full resolution, 2.28 GB of K and V
    w = costs.decode_step_work(YI, 32, 1088, 2)
    weights = 2.0 * 32 * (173_015_040 + 2 * 4096)
    kv = 2.0 * 2 * 32 * 32 * 1088 * 4 * 128
    assert w["bytes"] == pytest.approx(weights + 2 * 4096 * 64000 + kv
                                       + 2 * 32 * 4096 + 4 * 32 * 64000)
    assert costs.bound_s(w) == pytest.approx(w["bytes"] / 3.35e12)
    assert 4.0e-3 < costs.bound_s(w) < 4.3e-3
    # the first resolution reads one plane of two
    w1 = costs.decode_step_work(YI, 32, 1088, 1)
    assert w["bytes"] - w1["bytes"] == 4096 * 64000


def test_yi_prefill_counts_the_head_at_the_last_position_only():
    w = costs.prefill_work(YI, 4, 4096)
    body = 2.0 * 4 * 4096 * 32 * 173_015_040
    attn = 32 * costs.flash_flops(4, 4096, 4096, 32, 128, True, None)
    assert w["flops"] == pytest.approx(body + attn + 2.0 * 4 * 4096 * 64000)
    assert costs.bound_s(w) == pytest.approx(w["flops"] / 989e12)


def test_mamba_train_step_work():
    w = costs.train_step_work(MAMBA, 4, 2048)
    fwd = 2.0 * 4 * 2048 * (48 * costs.layer_weights(MAMBA) + 1024 * 50288)
    assert w["flops"] > 3 * fwd
    assert w["bytes"] == 24.0 * costs.num_params(MAMBA) + 8.0 * 4 * 2048
    assert costs.bound_s(w) == pytest.approx(w["flops"] / 989e12)


def test_trace_summary_attributes_device_time_by_launch():
    from perfbench import devtrace

    def x(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        x("user_annotation", devtrace.WINDOW, 0, 1000),
        x("user_annotation", "bench.prefill", 10, 400),
        x("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
        x("cuda_runtime", "cudaLaunchKernel", 30, 5, corr=2),
        x("user_annotation", "bench.decode", 500, 400),
        x("cuda_runtime", "cudaGraphLaunch", 510, 5, corr=3),
        x("kernel", "gemm", 100, 200, tid=7, corr=1),
        x("kernel", "attn", 300, 50, tid=7, corr=2),
        x("kernel", "replay_a", 600, 100, tid=7, corr=3),
        x("kernel", "replay_b", 700, 100, tid=7, corr=3),
        x("cpu_op", "aten::index", 360, 140),
    ]
    s = devtrace.summarize(events)
    pre, = s["ranges"]["prefill"]
    dec, = s["ranges"]["decode"]
    assert pre["device_s"] == pytest.approx(250e-6)
    assert pre["busy_s"] == pytest.approx(250e-6)
    assert dec["device_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(450e-6)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["device_ops"][0] == ["gemm", pytest.approx(200e-6)]
    # gaps 350..600, 800..1000, 0..100, longest first, each named by the
    # innermost host event over its middle
    assert s["idle_gaps"] == [["aten::index", pytest.approx(250e-6)],
                              ["bench.decode", pytest.approx(200e-6)],
                              ["bench.prefill", pytest.approx(100e-6)]]
