"""Each metric reader on a small recorded run: a window, spans and a
profiled stretch written by hand, with the values worked out here."""

import json
import os
import types

import pytest

from portbench.lib import bench, roofline
from portbench.lib.profile import Stretch, _idle_gaps, breakdown


def fake_run(**kw):
    run = types.SimpleNamespace(
        setup_s=12.5, spans={}, stretch=None, quiet_window=None,
        flops={"train_episode": 2e12, "serve_episode": 1e12,
               "fwconv_train_episode": 8e11, "fwconv_serve_episode": 2e11},
        window={"seconds": 10.0, "steps": 5, "episodes": 80, "latencies": []})
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def reader(name):
    return bench.load_module(os.path.join(bench.ROOT, "portbench/metrics", name + ".py"),
                             "m_" + name.replace(".", "_"))


def stretch():
    st = Stretch(wall_s=2.0, busy_s=0.5, kernels=400, episodes=4, conv_s=0.1, conv_kernels=30)
    st.by_name = {"void ipt::fwd_wgmma_kernel<64>(Args)": [2, 0.004],
                  "so_wgmma_kernel<64, true>": [1, 0.01],
                  "ampere_bf16_s16816gemm": [397, 0.486]}
    st.launches = [("flash_fwd", 4, 2060, 2060, 8, 64, 2, 0.1),
                   ("flash_fwd", 20, 361, 361, 8, 32, 2, 0.1),
                   ("flash_so", 4, 2060, 2060, 8, 64, 2, 0.1)]
    return st


def test_end_to_end_readers():
    run = fake_run()
    assert reader("setup_s").read(run) == 12.5
    assert reader("train_eps").read(run) == 8.0
    assert reader("served_eps").read(run) is None  # no latencies: not a served window
    lat = [0.1 * (i + 1) for i in range(100)]
    run = fake_run(window={"seconds": 20.0, "episodes": 100, "latencies": lat})
    assert reader("served_eps").read(run) == 5.0


def test_span_readers():
    run = fake_run(spans={"apply_grads": [0.02] * 5, "loader_wait": [0.001] * 5,
                          "hungarian": [0.003] * 40, "next_action": [0.05, 0.07],
                          "adapt": [0.2, 0.4]})
    assert reader("optimizer_ms.train").read(run) == pytest.approx(20.0)
    assert reader("loader_wait_ms.train").read(run) == pytest.approx(1.0)
    assert reader("hungarian_ms.train").read(run) == pytest.approx(24.0)  # 8 calls a step
    assert reader("next_action_ms.serve").read(run) == pytest.approx(60.0)
    assert reader("adapt_ms.serve").read(run) == pytest.approx(300.0)
    assert reader("adapt_ms.serve").read(fake_run()) is None  # never entered: absent


def test_trace_readers():
    run = fake_run(stretch=stretch())
    assert reader("idle_share.train").read(run) == pytest.approx(75.0)
    assert reader("launches_per_episode.serve").read(run) == pytest.approx(100.0)
    # 2e11 FLOPs x 4 episodes over 0.1 s of conv kernels
    assert reader("fwconv_roofline.serve").read(run) == pytest.approx(
        100 * 8e11 / 0.1 / roofline.PEAK_FLOPS)
    # 80 episodes x 2e12 FLOPs in 10 s
    assert reader("mfu.train").read(run) is None  # no half window with the spans off
    run.quiet_window = {"seconds": 10.0, "steps": 5, "episodes": 80}
    assert reader("mfu.train").read(run) == pytest.approx(100 * 1.6e13 / roofline.PEAK_FLOPS)
    bound = sum(roofline.bounds(*l[1:])[l[0]] for l in run.stretch.launches)
    assert reader("attn_roofline.train").read(run) == pytest.approx(100 * bound / 0.014)
    # a launch the device trace does not show: the attribution fails, absent
    run.stretch.launches.append(("flash_bwd", 4, 2060, 2060, 8, 64, 2, 0.1))
    assert reader("attn_roofline.serve").read(run) is None
    # nothing profiled: absent, never 0
    empty = fake_run(stretch=Stretch())
    for name in ("idle_share.serve", "launches_per_episode.train", "fwconv_roofline.serve",
                 "attn_roofline.train"):
        assert reader(name).read(empty) is None
    assert reader("fwconv_roofline.serve").read(
        fake_run(stretch=stretch(), flops={"fwconv_serve_episode": 0.0})) is None


def test_bounds_and_kernel_names():
    # FusionGPT forward, one microbatch of 4: 2 products of 2*B*H*T*S*D FLOPs
    b = roofline.bounds(4, 2060, 2060, 8, 64, 2, 0.0)["flash_fwd"]
    assert b == pytest.approx(2 * 2 * 4 * 8 * 2060 * 2060 * 64 / roofline.PEAK_FLOPS)
    assert roofline.kernel_of("void ipt::dkv_wgmma_kernel<64>(CUtensorMap)") == "flash_dkv"
    assert roofline.kernel_of("so_row_wgmma_kernel<32, false>") == "flash_so_row"
    assert roofline.kernel_of("void at::native::vectorized_elementwise_kernel<4>") is None
    assert roofline.kernel_of("layer_norm_fwd_kernel") is None


def test_idle_gaps_and_breakdown():
    ev = lambda s, e, name="": types.SimpleNamespace(
        time_range=types.SimpleNamespace(start=s, end=e), name=name)
    kernels = [ev(0, 10), ev(30, 40), ev(41, 50), ev(150, 160)]
    host = [ev(0, 200, "train_step"), ev(45, 140, "aten::to"), ev(12, 25, "scipy")]
    gaps = _idle_gaps(kernels, host)
    assert gaps == [["aten::to", 100e-6], ["train_step", 20e-6], ["train_step", 1e-6]]
    out = breakdown(stretch())
    assert out["device_ops"][0] == ["ampere_bf16_s16816gemm", 0.486]
    assert len(out["device_ops"]) <= 10 and json.dumps(out)
