"""The pieces the Deformable DETR cell adds: its configuration file (the
shipped YAML, nothing reduced, the FLOP counts recount), its traffic (the
lockstep traffic's parameters, its own driver), the two readers of the
deformable attention kernels on planted records with the values worked out
here, and a tiny cell through the real driver on the CPU, whose plain
reference (grid_sample) agrees with the port's plain versions."""

import json
import os
import types

import pytest
import yaml

from portbench.lib import bench, deformable, msda, roofline
from portbench.lib.profile import Stretch
from portbench.tests.tiny_cell import TINY, TRAFFIC

CELL = "interactron_deformable.serve.lockstep10"
ROOT = bench.ROOT


def _json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def spec():
    return _json("BENCHMARK.json")


def test_config_is_the_shipped_yaml_and_its_flops_recount():
    cfg = _json("portbench/configs/interactron_deformable.json")
    with open(os.path.join(ROOT, cfg["yaml"])) as f:
        assert cfg["config"] == yaml.safe_load(f)
    m = cfg["config"]["MODEL"]
    assert cfg["reduced"] == [] and len(cfg["assumed"]) == 4
    assert (m["BACKBONE"], m["NUM_QUERIES"], m["NUM_FEATURE_LEVELS"], m["DETR_FF_DIM"],
            m["BLOCK_SIZE"]) == ("resnet50_deformable", 300, 4, 1024, 5 * 361 + 5 * 300 + 5)
    assert deformable.count(cfg["config"]) == cfg["flops"]


def test_traffic_is_the_lockstep_traffic_with_its_own_driver():
    w = next(w for w in spec()["workloads"] if w["name"] == CELL)
    mine = _json("portbench/traffic", w["traffic"] + ".json")
    theirs = _json("portbench/traffic/serve.lockstep10.json")
    assert mine.pop("driver") == "serve_deformable" and theirs.pop("driver") == "serve"
    assert mine == theirs


# one chunk's deformable launches at a lockstep chunk's shapes: 12 forward
# launches of a detector pass (6 encoder at Lq = S = 1930, 6 decoder at Lq =
# 300) for each of next_action's 4 calls, adapt's pass and its backward,
# and predict's detect
LEVELS = 4 * 4  # levels x points
ENC_F = ("msda_fwd", 50, 1930, 1930, 8, 32, 4, 4, 2)
DEC_F = ("msda_fwd", 50, 300, 1930, 8, 32, 4, 4, 2)
CHUNK = ([ENC_F] * 6 + [DEC_F] * 6) * 6 + [(k.replace("fwd", "bwd"), *r) for k, *r in
                                          [ENC_F] * 6 + [DEC_F] * 6]


def planted(launches, episodes, kernels, busy_s):
    st = Stretch(wall_s=1.0, busy_s=busy_s, kernels=sum(c for c, _ in kernels.values()),
                 by_name=kernels, episodes=10)
    rec = {"spans": [types.SimpleNamespace(name="serve.predict", parent=None,
                                           attrs={"episodes": episodes})],
           "counters": {}, "launches": [], "msda": launches}
    return types.SimpleNamespace(program_record=rec, stretch=st)


def test_bounds_at_the_encoder_shape():
    """The encoder's forward at a chunk's shape is bound by its bytes: the
    bf16 maps read once (50 x 1930 x 256 x 2), the fp32 locations and
    weights (12 bytes a sample), the bf16 output; its FLOPs (9 a sample's
    channel) at the fp32 rate take less."""
    samples = 50 * 1930 * 8 * LEVELS
    nbytes = 50 * 1930 * 256 * 2 * 2 + samples * 12
    assert msda.compulsory_bytes(*ENC_F) == nbytes
    assert msda.flops(*ENC_F[:-1]) == samples * 32 * 9
    assert msda.bound_s(*ENC_F) == pytest.approx(nbytes / roofline.PEAK_BYTES)
    bwd = ("msda_bwd", *ENC_F[1:])
    assert msda.compulsory_bytes(*bwd) == 50 * 1930 * 256 * 2 * 3 + samples * 24
    # a decoder's 300 queries can reach every row of the 1930-token maps
    assert msda.compulsory_bytes(*DEC_F) == 50 * 1930 * 256 * 2 + 50 * 300 * 8 * LEVELS * 12 \
        + 50 * 300 * 256 * 2


def test_readers_on_a_planted_record():
    """A window of 2 chunks (20 episodes) recorded, a stretch of one chunk
    whose 72 + 12 kernels took 20 ms of 80 ms busy: the roofline share is
    one chunk's least time over 20 ms, the busy share 25%."""
    kernels = {"void (anonymous namespace)::msda_fwd_kernel<__nv_bfloat16>(...)": [72, 0.012],
               "void (anonymous namespace)::msda_bwd_kernel<__nv_bfloat16>(...)": [12, 0.008],
               "flash_fwd_wgmma_kernel": [50, 0.02], "ampere_bf16_gemm": [300, 0.04]}
    run = planted(CHUNK * 2, 20, kernels, 0.08)
    assert len(CHUNK) == 84
    want = 100.0 * sum(msda.bound_s(*r) for r in CHUNK) / 0.020
    assert msda.roofline_share(run) == pytest.approx(want)
    assert 0 < want < 100
    assert msda.busy_share(run) == pytest.approx(25.0)
    # the stretch's kernels must match the record's count, episode for episode
    assert msda.roofline_share(planted(CHUNK * 2 + [ENC_F], 20, kernels, 0.08)) is None
    # a program without the record (the parent's) reads nothing
    for launches in ([], None):
        run = planted(launches, 20, kernels, 0.08)
        assert msda.roofline_share(run) is None and msda.busy_share(run) is None
    assert msda.kernel_of("msda_fwd_kernel_x") is None and msda.kernel_of("flash_fwd") is None


IMG = 96


def tiny():
    m = json.loads(json.dumps(TINY))
    m["MODEL"].update(BACKBONE="tiny_deformable", TEST_RESOLUTION=IMG, D_MODEL=32,
                      NUM_FEATURE_LEVELS=4, DETR_FF_DIM=32, NUM_ENCODER_LAYERS=2,
                      NUM_DECODER_LAYERS=2, BLOCK_SIZE=5 * ((IMG // 16) ** 2 + 6) + 5)
    return m


@pytest.mark.parametrize("fault", [None, "level_dropped", "bf16_locations"])
def test_tiny_cell_through_the_driver(fault):
    """The cell's driver at a tiny size, fp32 on both sides: correct, every
    compared number at fp32 rounding; the planted 4th-level drop moves the
    predictions far past it, and both plants move the first encoder
    layer's deformable sums (`msda_err`) far past it."""
    import torch

    from interactron_tpu_torch.ops import ms_deform_attn as op

    s = spec()
    w = next(x for x in s["workloads"] if x["name"] == CELL)
    model = tiny()
    run = bench.Run(s, w, 2**31 + 7, 0.2, False, torch.device("cpu"),
                    config={"config": model, "flops": deformable.count(model)},
                    traffic=dict(TRAFFIC["lockstep"], driver="serve_deformable"))
    run.fault = fault
    wrappers = op.ms_deform_attn_fwd, op.ms_deform_attn_bwd
    try:
        result, numbers = bench.execute(run)
    finally:  # the planted wrappers stay in the op module
        op.ms_deform_attn_fwd, op.ms_deform_attn_bwd = wrappers
    got = {n: v for n, v, _ in numbers}
    assert set(got) == {"step_err", "logits_err", "boxes_err", "msda_err"}
    if fault is None:
        assert result["correct"] and got["step_err"] == 0.0
        assert got["logits_err"] <= 1e-5 and got["boxes_err"] <= 1e-5
        assert got["msda_err"] <= 1e-5 and run.extra["loc_px"] <= 1e-5
    else:
        assert got["msda_err"] > 1e-3
    if fault == "level_dropped":
        assert got["logits_err"] > 1e-3
