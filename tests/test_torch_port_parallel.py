"""Episode data parallelism of the port (parallel/mesh.py, the loader's rank
slices, the trainer's rank handling) on the CPU over gloo, each rank a
subprocess with torchrun's environment on a free port.

  * two ranks' summed gradients and mean metrics against one process's step
    on the whole batch (tiny interactron, fp32, dropout off, a fixed
    `frame_index`), to 1e-5 x max(max|leaf|, 1e-2) (the floor for the
    k-projection biases, whose gradient is zero in exact arithmetic and
    fp32 noise on both sides, as in test_torch_port_train.py); both
    ranks hold the same merged path state, the one-process step's;
  * `merge_path_state` against JAX's `_merge_path_state` under shard_map
    on two CPU devices, with ties;
  * the loader's slices against JAX's `EpisodeLoader(process_index=,
    process_count=)`, a divisible batch and a tail, at the data tests'
    tolerances (test_torch_port_data.py);
  * `Trainer.train` for 2 epochs at world 2 against world 1 (the
    multi-frame baseline, dropout 0, whose loss sums per-episode terms):
    weights within 1e-5; only rank 0 writes checkpoints, rank 1 logs to a
    `-p1` directory;
  * `python -m interactron_tpu_torch.train` joins the group from
    torchrun's environment;
  * the rank fold gives each rank its own dropout stream.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from interactron_tpu.data.episode_dataset import EpisodeDataset as JEpisodeDataset
from interactron_tpu.data.episode_dataset import EpisodeLoader as JEpisodeLoader
from interactron_tpu.data.synthetic import make_synthetic_dataset
from interactron_tpu.parallel.mesh import _merge_path_state, make_mesh
from interactron_tpu_torch.data.episode_dataset import EpisodeDataset, EpisodeLoader
from interactron_tpu_torch.tasks import InteractronTask
from interactron_tpu_torch.utils.config import Config, build_model, build_trainer
from test_torch_port_data import _assert_samples_equal
from tiny_config import IMG, NUM_CLASSES, tiny_batch, tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
FRAME_INDEX = [3, 0, 4, 1]

_WORKER = r"""
import json, os, sys
import numpy as np
import torch
sys.path[:0] = [%(repo)r, %(tests)r]
from interactron_tpu_torch.parallel import mesh
from interactron_tpu_torch.tasks import InteractronTask
from interactron_tpu_torch.utils.config import Config
from tiny_config import tiny_batch, tiny_config

mode, out = sys.argv[1], sys.argv[2]
assert mesh.init_distributed("cpu") == "cpu"
r, w = mesh.rank(), mesh.world_size()
res = {}
if mode == "grads":
    cfg = tiny_config(batch_size=4).to_dict()
    cfg["TRAINER"]["INNER_BATCH"] = 2
    task = InteractronTask(Config(cfg), device="cpu").init(0)
    batch = tiny_batch(np.random.RandomState(0), b=4)
    n = 4 // w
    local = {k: v[r * n:(r + 1) * n] for k, v in batch.items()}
    fi = %(frame_index)r[r * n:(r + 1) * n]
    g, m, state = mesh.data_parallel_grads(task)(
        local, torch.Generator().manual_seed(0), task.init_path_state(8), train=False,
        frame_index=fi)
    res = {"grads": {f"{grp}/{k}": v.tolist() for grp, d in g.items() for k, v in d.items()},
           "metrics": {k: float(v) for k, v in m.items()},
           "cost": state["cost"].tolist(), "action": state["action"].tolist()}
elif mode == "merge":
    cost = torch.full((3, 85), 1e30)
    action = torch.zeros((3, 85), dtype=torch.int64)
    cost[0], action[0] = 5.0 - r, 10 + r          # row 0: the last rank is lowest
    cost[1, :40], action[1, :40] = 2.0, 20 + r    # row 1: a tie, the lowest rank wins
    if r == 1:
        cost[2, 7], action[2, 7] = 0.5, 3         # row 2: one rank alone
    state = mesh.merge_path_state({"cost": cost, "action": action})
    res = {"cost": state["cost"].tolist(), "action": state["action"].tolist()}
elif mode == "fold":
    cfg = tiny_config(batch_size=2).to_dict()
    task = InteractronTask(Config(cfg), device="cpu").init(0)
    batch = tiny_batch(np.random.RandomState(0), b=2)
    for fold in (True, False):
        gen = torch.Generator().manual_seed(0)
        g, _, _ = (mesh.data_parallel_grads(task) if fold else task.grads_and_metrics)(
            batch, gen, task.init_path_state(8), train=True, frame_index=[0, 1])
        if fold:  # the summed gradient is the same on both ranks
            g = {grp: {k: v / w for k, v in d.items()} for grp, d in g.items()}
        leaf = g["fusion"]["heads.loss_decoder.layer0.weight"]
        res["folded" if fold else "unfolded"] = leaf.tolist()
        res["after_" + str(fold)] = int(torch.randint(0, 2**30, (), generator=gen))
    # each rank's own (unfolded) local gradient, to tell the streams apart
    gen = torch.Generator().manual_seed(0)
    local, _, _ = task.grads_and_metrics(batch, mesh.fold_in(gen, r), task.init_path_state(8),
                                         train=True, frame_index=[0, 1])
    res["local"] = local["fusion"]["heads.loss_decoder.layer0.weight"].tolist()
elif mode == "train":
    from interactron_tpu_torch.utils.config import build_model, build_trainer
    cfg = Config(json.loads(os.environ["PORT_CONFIG"]))
    task = build_model(cfg, device="cpu").init(42)
    trainer = build_trainer(task, cfg)
    trainer.train()
    res = {"params": {k: v.tolist() for k, v in task.state_dict().items()},
           "out_dir": trainer.out_dir, "tokens": trainer.tokens}
mesh.shutdown_distributed()
with open(out, "w") as f:
    json.dump(res, f)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(tmp_path, mode, world=2, env=None):
    """Run the worker in `mode` on `world` gloo ranks; their JSON results."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER % {"repo": REPO, "tests": TESTS, "frame_index": FRAME_INDEX})
    port = str(_free_port())
    procs, outs = [], []
    for r in range(world):
        out = tmp_path / f"{mode}-{r}.json"
        e = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen([sys.executable, str(script), mode, str(out)], env=e,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
        outs.append(out)
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-3000:]}"
    return [json.loads(o.read_text()) for o in outs]


def _close(got, want, rel=1e-5, msg="", floor=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), floor)
    np.testing.assert_allclose(got / scale, want / scale, atol=rel, rtol=0, err_msg=msg)


def test_two_rank_grads_and_metrics_match_one_process(tmp_path):
    r0, r1 = _ranks(tmp_path, "grads")
    cfg = tiny_config(batch_size=4).to_dict()
    cfg["TRAINER"]["INNER_BATCH"] = 2
    task = InteractronTask(Config(cfg), device="cpu").init(0)
    g, m, state = task.grads_and_metrics(tiny_batch(np.random.RandomState(0), b=4),
                                         torch.Generator().manual_seed(0),
                                         task.init_path_state(8), train=False,
                                         frame_index=FRAME_INDEX)
    want = {f"{grp}/{k}": v.numpy() for grp, d in g.items() for k, v in d.items()}
    assert set(r0["grads"]) == set(want)
    for k, v in want.items():
        _close(r0["grads"][k], v, msg=k, floor=1e-2)
        assert r0["grads"][k] == r1["grads"][k], k
    for k, v in m.items():
        _close(r0["metrics"][k], float(v))
    assert r0["metrics"] == r1["metrics"]
    assert r0["cost"] == r1["cost"] and r0["action"] == r1["action"]
    np.testing.assert_array_equal(np.asarray(r0["action"]), state["action"].numpy())
    np.testing.assert_allclose(np.asarray(r0["cost"], np.float32), state["cost"].numpy(),
                               rtol=1e-5)


def test_merge_path_state_matches_jax(tmp_path):
    got = _ranks(tmp_path, "merge")
    assert got[0] == got[1]
    mesh = make_mesh(jax.devices()[:2], dp=2, tp=1)

    def fn(_):
        r = jax.lax.axis_index("dp")
        cost = jnp.full((3, 85), 1e30, jnp.float32)
        action = jnp.zeros((3, 85), jnp.int32)
        cost = cost.at[0].set(5.0 - r).at[1, :40].set(2.0)
        action = action.at[0].set(10 + r).at[1, :40].set(20 + r)
        cost = jnp.where(r == 1, cost.at[2, 7].set(0.5), cost)
        action = jnp.where(r == 1, action.at[2, 7].set(3), action)
        return _merge_path_state({"cost": cost, "action": action})

    want = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(),), out_specs=P(),
                                 check_vma=False))(jnp.zeros((1,)))
    np.testing.assert_array_equal(np.asarray(got[0]["cost"], np.float32),
                                  np.asarray(want["cost"]))
    np.testing.assert_array_equal(np.asarray(got[0]["action"]), np.asarray(want["action"]))
    assert got[0]["action"][0][0] == 11 and got[0]["action"][1][0] == 20


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_tree")
    return make_synthetic_dataset(str(root), n_episodes=9, n_states=6, img_size=IMG,
                                  n_categories=NUM_CLASSES - 1)


@pytest.mark.parametrize("count,batch_size,shuffle", [(2, 4, True), (3, 6, False)])
def test_loader_slices_match_jax(tree, count, batch_size, shuffle):
    """9 episodes: batches of 4 over 2 ranks (a tail of 1, loaded whole on
    every rank), and of 6 over 3 ranks (a tail of 3, which divides)."""
    for idx in range(count):
        kw = dict(shuffle=shuffle, num_workers=0, drop_last=False, seed=3,
                  process_index=idx, process_count=count)
        want = list(JEpisodeLoader(JEpisodeDataset(*tree, "train", resolution=IMG),
                                   batch_size, **kw))
        got = list(EpisodeLoader(EpisodeDataset(*tree, "train", resolution=IMG), batch_size,
                                 **kw))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.pop("_global_rows") == b.pop("_global_rows")
            _assert_samples_equal(a, b)
    tail = got[-1]
    assert len(tail["frames"]) == (1 if count == 2 else 1)


def _records(out_dir):
    with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _multiframe_config(tree, out, batch_size=4):
    d = tiny_config("detr_multiframe", batch_size=batch_size).to_dict()
    d["MODEL"].update(DETR_DROPOUT=0.0, EMBEDDING_PDROP=0.0, RESIDUAL_PDROP=0.0,
                      ATTENTION_PDROP=0.0)
    img_root, ann = tree
    d["DATASET"] = {s: {"TYPE": "sequence", "MODE": m, "ANNOTATION_ROOT": ann,
                        "IMAGE_ROOT": img_root} for s, m in (("TRAIN", "train"), ("TEST", "test"))}
    d["TRAINER"].update(TYPE="direct_supervision", LEARNING_RATE=1e-3, OUTPUT_DIRECTORY=out)
    return d


def test_trainer_two_ranks_match_one(tree, tmp_path):
    """2 epochs (epoch 0's test epoch, one train epoch of 2 steps of 4, a
    test epoch; the test epochs' batches of 4 sharded, the tail of 1
    computed whole on both ranks): the same weights, tokens and logged
    metrics at world 2 as at world 1; rank 0 alone writes checkpoints."""
    d = _multiframe_config(tree, str(tmp_path / "two"))
    ranks = _ranks(tmp_path, "train", env={"PORT_CONFIG": json.dumps(d)})
    one = _multiframe_config(tree, str(tmp_path / "one"))
    task = build_model(Config(one), device="cpu").init(42)
    trainer = build_trainer(task, Config(one))
    trainer.train()
    for r in ranks:
        assert r["tokens"] == trainer.tokens == 8
        for k, v in task.state_dict().items():
            np.testing.assert_allclose(np.asarray(r["params"][k], np.float32), v.numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
    out0, out1 = ranks[0]["out_dir"], ranks[1]["out_dir"]
    want = _records(trainer.out_dir)
    for out in (out0, out1):
        got = _records(out)
        assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1]
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in a:
                if k != "Train/epoch_seconds":
                    _close(a[k], b[k])
    assert out1.endswith("-p1") and not out0.endswith("-p0")
    assert sorted(os.listdir(out0)) == ["detector.ckpt", "last_state.ckpt", "logs"]
    assert os.listdir(out1) == ["logs"]


def test_entry_point_under_torchrun_environment(tree, tmp_path):
    """`python -m interactron_tpu_torch.train --device cpu` on two ranks
    joins the gloo group from torchrun's environment: both exit 0, rank 0
    writes the checkpoints, rank 1 only its `-p1` log directory."""
    import yaml

    d = _multiframe_config(tree, str(tmp_path / "out"))
    d["EVALUATOR"].update(OUTPUT_DIRECTORY=str(tmp_path / "eval"))
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump(d))
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "interactron_tpu_torch.train", "--config_file", str(cfg),
         "--device", "cpu"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS="1",
                 PYTHONPATH=REPO)) for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-3000:]}"
    runs = sorted(os.listdir(tmp_path / "out"), key=lambda n: n.endswith("-p1"))
    assert len(runs) == 2 and runs[1].endswith("-p1") and not runs[0].endswith("-p1")
    assert sorted(os.listdir(tmp_path / "out" / runs[0])) == ["detector.ckpt", "last_state.ckpt",
                                                             "logs"]
    assert os.listdir(tmp_path / "out" / runs[1]) == ["logs"]


def test_uneven_batch_size_raises(tree, tmp_path, monkeypatch):
    from interactron_tpu_torch.engine import trainer as trainer_mod

    from interactron_tpu_torch.parallel.mesh import Grid

    monkeypatch.setattr(trainer_mod, "make_grid", lambda: Grid(dp=3))
    d = _multiframe_config(tree, str(tmp_path / "x"))
    with pytest.raises(ValueError, match="does not divide among 3 dp ranks"):
        build_trainer(build_model(Config(d), device="cpu"), Config(d))


def test_rank_fold_gives_each_rank_its_own_dropout_stream(tmp_path):
    r0, r1 = _ranks(tmp_path, "fold")
    # the shared stream advances alike on every rank, folded or not
    assert r0["after_True"] == r1["after_True"] and r0["after_False"] == r1["after_False"]
    # without the fold the ranks' dropout agrees; with it each rank draws
    # its own masks, and the sum holds both
    assert r0["unfolded"] == r1["unfolded"]
    assert r0["local"] != r1["local"]
    np.testing.assert_allclose(np.asarray(r0["folded"]),
                               (np.asarray(r0["local"]) + np.asarray(r1["local"])) / 2,
                               atol=1e-6)
