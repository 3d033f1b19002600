"""A cell of the benchmark at a tiny size on the CPU: the real drivers,
readers and comparisons around the port's plain kernel versions."""

import json
import os

import torch

from portbench.lib import bench, flops

IMG = 32
TINY = {
    "MODEL": {"TYPE": "interactron", "NUM_CLASSES": 7, "BACKBONE": "tiny", "TEST_RESOLUTION": IMG,
              "NUM_QUERIES": 6, "D_MODEL": 16, "DETR_NUM_HEADS": 2, "NUM_ENCODER_LAYERS": 1,
              "NUM_DECODER_LAYERS": 1, "DETR_FF_DIM": 32, "NUM_LAYERS": 1, "NUM_HEADS": 2,
              "EMBEDDING_DIM": 16, "BLOCK_SIZE": 5 * ((IMG // 16) ** 2 + 6) + 5,
              "OUTPUT_SIZE": 16, "SET_COST_CLASS": 1.0, "SET_COST_BBOX": 5.0,
              "SET_COST_GIOU": 2.0, "EMBEDDING_PDROP": 0.1, "RESIDUAL_PDROP": 0.1,
              "ATTENTION_PDROP": 0.1, "ADAPTIVE_LR": 1e-3, "DTYPE": "float32"},
    "TRAINER": {"TYPE": "interactron", "BATCH_SIZE": 4, "INNER_BATCH": 2, "NUM_WORKERS": 2,
                "MAX_EPOCHS": 2, "DETECTOR_LR": 1e-5, "SUPERVISOR_LR": 1e-4,
                "GRAD_NORM_CLIP": 1.0, "LR_DECAY": False},
}
TRAFFIC = {
    "train": {"driver": "train", "batch": 4, "episodes": 12, "states": 8, "max_det": 3, "categories": 5},
    "single": {"driver": "serve", "chunk": 1, "episodes": 4, "states": 8, "max_det": 3, "categories": 5,
               "stretch_chunks": 1, "check_episodes": 2,
               "check_within": 2},
    "lockstep": {"driver": "serve", "chunk": 2, "episodes": 4, "states": 8, "max_det": 3, "categories": 5,
                 "stretch_chunks": 1, "check_episodes": 2,
               "check_within": 2},
}
# the cells whose entries (metrics, limits) a tiny run takes; "single" is the
# lockstep cell's entry with chunks of one
WORKLOADS = {"train": "interactron_scaled.train.b16", "single": "interactron.serve.lockstep10",
             "lockstep": "interactron.serve.lockstep10"}
_FLOPS = {}


def spec():
    with open(os.path.join(bench.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def make_run(kind, seed=3, seconds=0.2, trace=False, fault=None, dtype="float32",
             limits=None):
    model = json.loads(json.dumps(TINY))
    model["MODEL"]["DTYPE"] = dtype
    if "flops" not in _FLOPS:
        _FLOPS["flops"] = flops.count(model)
    s = spec()
    workload = next(w for w in s["workloads"] if w["name"] == WORKLOADS[kind])
    run = bench.Run(s, workload, seed, seconds, trace, torch.device("cpu"),
                    config={"config": model, "flops": _FLOPS["flops"]},
                    traffic=TRAFFIC[kind], limits=limits)
    run.fault = fault
    return run
