"""The dp x tp rank grid of the port (parallel/mesh.py `make_grid`,
`shard_heads`, the column-parallel class heads of models/layers.py), the
trainer on the grid and the kernel build barrier (parallel/lockstep.py),
on the CPU over gloo, each rank a subprocess with torchrun's environment.

  * `make_grid`'s layout and groups against JAX's `make_mesh(devices, dp,
    tp).devices` on the conftest's 8 CPU devices;
  * `shard_heads` splits exactly the leaves JAX's `param_shardings` marks
    P(None, "tp") (named through utils/from_jax.py), no bias;
  * two ranks at tp 2 `predict` from JAX's weights, against JAX's
    `jit(task.predict)` under `param_shardings` at dp 4 x tp 2, at
    test_torch_port_predict.py's atol 1e-5, and against the port's
    one-process predict (interactron and interactron_random);
  * the tp inner step's gathered head gradient and trunk gradient against
    one process at test_torch_port_train.py's rule, 1e-5 x max(max|leaf|,
    1e-2); a gather built on torch.distributed.nn.functional.all_gather
    (a reduce-scatter backward) must fail that rule;
  * four ranks at dp 2 x tp 2 `Trainer.train` for 2 epochs over 3*dp-1
    episodes (an uneven test tail) against world 1, weights within 1e-5,
    as test_torch_port_parallel.py's `test_trainer_two_ranks_match_one`;
    `replicate_over_tp` gives each tp group its tp index 0's values;
  * the build barrier with an injected build: only local rank 0 calls it,
    and no rank goes on before it has ended.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from interactron_tpu.data.synthetic import make_synthetic_dataset
from interactron_tpu.parallel.mesh import make_mesh, param_shardings
from interactron_tpu.tasks import InteractronRandomTask as JaxRandomTask
from interactron_tpu.tasks import InteractronTask as JaxTask
from interactron_tpu_torch.parallel.mesh import Grid, shard_heads
from interactron_tpu_torch.tasks import InteractronRandomTask, InteractronTask
from interactron_tpu_torch.utils.config import Config, build_model, build_trainer
from interactron_tpu_torch.utils.from_jax import _leaf, from_jax
from test_torch_port_parallel import _close, _free_port, _multiframe_config
from tiny_config import IMG, NUM_CLASSES, tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
TASKS = {"interactron": (JaxTask, InteractronTask),
         "interactron_random": (JaxRandomTask, InteractronRandomTask)}

_WORKER = r"""
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
sys.path[:0] = [%(repo)r, %(tests)r]
from interactron_tpu_torch.parallel import lockstep, mesh

mode, out = sys.argv[1], sys.argv[2]
assert mesh.init_distributed("cpu") == "cpu"
r = mesh.rank()
res = {}
if mode == "layout":
    dp, tp = int(os.environ["DP"]), int(os.environ["TP"])
    grid = mesh.make_grid(dp=dp, tp=tp)
    res = {"dp_index": grid.dp_index, "tp_index": grid.tp_index,
           "dp_group": dist.get_process_group_ranks(grid.dp_group),
           "tp_group": dist.get_process_group_ranks(grid.tp_group)}
elif mode in ("tp", "planted"):
    from interactron_tpu_torch.models import layers
    from interactron_tpu_torch.tasks import InteractronRandomTask, InteractronTask
    from interactron_tpu_torch.utils.config import Config
    from tiny_config import tiny_config
    if mode == "planted":  # the gather whose backward reduce-scatters
        from torch.distributed.nn.functional import all_gather
        layers.tp_gather = lambda y, group: torch.cat(all_gather(y.contiguous(), group=group), -1)
    model_type = os.environ["MODEL_TYPE"]
    Task = InteractronTask if model_type == "interactron" else InteractronRandomTask
    task = Task(Config(tiny_config(model_type).to_dict()), device="cpu")
    data = np.load(os.environ["WEIGHTS"])
    task.load_weights({k: data[k] for k in data.files})
    frames = np.load(os.environ["FRAMES"])
    grid = mesh.make_grid(dp=1, tp=2)
    res["sharded"] = mesh.shard_heads(task, grid)

    def full(d, k):
        # a sharded head's (E, rows, in) leaf gathered on its rows
        if k not in heads:
            return d[k]
        parts = [torch.empty_like(d[k]) for _ in range(grid.tp)]
        dist.all_gather(parts, d[k].contiguous(), group=grid.tp_group)
        return torch.cat(parts, 1)

    fast, g, _ = task.adapt({"frames": frames})
    heads = {n[len("detector."):] for n in res["sharded"] if n.startswith("detector.")}
    res["g"] = {k: full(g, k).tolist() for k in g}
    res["fast"] = {k: full(fast, k).tolist() for k in heads}
    if mode == "tp":
        pred = task.predict({"frames": frames})
        res.update({k: v.tolist() for k, v in pred.items()})
        with torch.no_grad():
            fus = task.fusion_apply(task.detr_apply(None, torch.as_tensor(frames[0])))
        res["fusion_logits"] = fus["pred_logits"].tolist()
        if model_type == "interactron":
            res["actions"] = [int(task.next_action({"frames": frames[:, :s]})[0])
                              for s in range(1, 5)]
elif mode == "train":
    from interactron_tpu_torch.engine.trainer import Trainer
    from interactron_tpu_torch.utils.config import Config, build_model
    cfg = Config(json.loads(os.environ["PORT_CONFIG"]))
    task = build_model(cfg, device="cpu").init(42)
    trainer = Trainer(task, cfg, grid=mesh.make_grid(dp=2, tp=2))
    trainer.train()
    res = {"params": {k: v.tolist() for k, v in task.state_dict().items()},
           "out_dir": trainer.out_dir, "tokens": trainer.tokens,
           "files": sorted(os.listdir(trainer.out_dir))}
elif mode == "replicate":
    grid = mesh.make_grid(dp=2, tp=2)
    tree = {"a": torch.full((3,), float(r)), "b": {"c": torch.full((2, 2), 10 + r)}}
    other = {"d": torch.tensor(r * 0.5, dtype=torch.float64)}
    mesh.replicate_over_tp(grid, tree, other)
    res = {"a": tree["a"].tolist(), "c": tree["b"]["c"].tolist(), "d": float(other["d"])}
elif mode == "barrier":
    marker = os.environ["MARKER"]
    calls = []

    def build():
        calls.append(time.time())
        time.sleep(0.5)
        if os.environ.get("FAIL"):
            raise OSError("nvcc not found")
        with open(marker, "w") as f:
            f.write(str(r))
        calls.append(time.time())

    try:
        reports = lockstep.build_barrier(int(os.environ["LOCAL_RANK"]), build)
    except RuntimeError as exc:
        reports = str(exc)
    res = {"calls": calls, "after": time.time(), "marker": os.path.exists(marker),
           "reports": reports}
mesh.shutdown_distributed()
with open(out, "w") as f:
    json.dump(res, f)
"""


def _ranks(tmp_path, mode, world, env=None):
    """Run the worker in `mode` on `world` gloo ranks; their JSON results."""
    script = tmp_path / "tp_worker.py"
    script.write_text(_WORKER % {"repo": REPO, "tests": TESTS})
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


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 2), (8, 1)])
def test_make_grid_layout_matches_make_mesh(tmp_path, dp, tp):
    got = _ranks(tmp_path, "layout", dp * tp, env={"DP": str(dp), "TP": str(tp)})
    want = np.vectorize(lambda d: d.id)(make_mesh(jax.devices()[:dp * tp], dp, tp).devices)
    layout = np.full((dp, tp), -1)
    for r, g in enumerate(got):
        layout[g["dp_index"], g["tp_index"]] = r
    np.testing.assert_array_equal(layout, want)
    for g in got:
        assert g["dp_group"] == layout[:, g["tp_index"]].tolist()
        assert g["tp_group"] == layout[g["dp_index"], :].tolist()


def _jax_pair(model_type):
    JTask, TTask = TASKS[model_type]
    jtask = JTask(tiny_config(model_type))
    params, frozen = jax.device_get(jtask.init(jax.random.PRNGKey(0)))
    return jtask, params, frozen, from_jax(params, frozen)


@pytest.mark.parametrize("model_type", list(TASKS))
def test_shard_heads_matches_param_shardings(model_type):
    JTask, TTask = TASKS[model_type]
    jtask = JTask(tiny_config(model_type))
    # the tree's structure and ranks are all param_shardings reads
    params, _ = jax.eval_shape(lambda: jtask.init(jax.random.PRNGKey(0)))
    specs = jax.tree_util.tree_flatten_with_path(
        param_shardings(params, make_mesh(jax.devices(), dp=4, tp=2)))[0]
    want = sorted(_leaf(tuple(str(k.key) for k in path), np.zeros((1, 1)))[0]
                  for path, s in specs if s.spec == P(None, "tp"))
    assert want == ["detector.class_embed.weight", "fusion.heads.logit_decoder.weight"]
    task = TTask(Config(tiny_config(model_type).to_dict()), device="cpu").init(0)
    before = task.state_dict()
    got = shard_heads(task, Grid(dp=1, tp=2, tp_index=1))
    assert sorted(got) == want
    after = task.state_dict()
    for name, v in before.items():
        if name in want:  # tp rank 1 keeps the second half of the rows
            assert torch.equal(after[name], v[v.shape[0] // 2:]), name
        else:
            assert torch.equal(after[name], v), name
    assert after["detector.class_embed.bias"].shape == (NUM_CLASSES + 1,)


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Per model type: JAX's weights and episode, JAX's tp predict, the
    port's one-process results and its two tp ranks' results."""
    runs = {}
    frames = (np.random.RandomState(0).randn(1, 5, IMG, IMG, 3) * 0.5).astype(np.float32)
    for model_type in TASKS:
        tmp = tmp_path_factory.mktemp(f"tp_{model_type}")
        jtask, params, frozen, state = _jax_pair(model_type)
        mesh = make_mesh(jax.devices(), dp=4, tp=2)
        params_tp = jax.device_put(params, param_shardings(params, mesh))
        frozen_rep = jax.device_put(frozen, NamedSharding(mesh, P()))
        want = jax.device_get(jax.jit(jtask.predict)(params_tp, frozen_rep,
                                                     {"frames": jnp.asarray(frames)}))
        task = TASKS[model_type][1](Config(tiny_config(model_type).to_dict()), device="cpu")
        task.load_weights(state)
        fast, g, _ = task.adapt({"frames": frames})
        one = {"g": g, "fast": fast, **task.predict({"frames": frames})}
        with torch.no_grad():
            one["fusion_logits"] = task.fusion_apply(
                task.detr_apply(None, torch.as_tensor(frames[0])))["pred_logits"]
        if model_type == "interactron":
            one["actions"] = [int(task.next_action({"frames": frames[:, :s]})[0])
                              for s in range(1, 5)]
        np.savez(tmp / "weights.npz", **state)
        np.save(tmp / "frames.npy", frames)
        env = {"MODEL_TYPE": model_type, "WEIGHTS": str(tmp / "weights.npz"),
               "FRAMES": str(tmp / "frames.npy")}
        runs[model_type] = {"jax": want, "one": one, "ranks": _ranks(tmp, "tp", 2, env),
                            "env": env, "tmp": tmp}
    return runs


@pytest.mark.parametrize("model_type", list(TASKS))
def test_tp_predict_matches_jax_and_one_process(tp_runs, model_type):
    run = tp_runs[model_type]
    for r in run["ranks"]:
        assert sorted(r["sharded"]) == ["detector.class_embed.weight",
                                        "fusion.heads.logit_decoder.weight"]
        for key in ("pred_logits", "pred_boxes"):
            got = np.asarray(r[key], np.float32)
            assert got.shape == run["jax"][key].shape
            np.testing.assert_allclose(got, np.asarray(run["jax"][key]), atol=1e-5, err_msg=key)
            np.testing.assert_allclose(got, run["one"][key].numpy(), atol=1e-5, err_msg=key)
        # the fusion's sharded logit_decoder, gathered
        np.testing.assert_allclose(np.asarray(r["fusion_logits"], np.float32),
                                   run["one"]["fusion_logits"].numpy(), atol=1e-5)
        if model_type == "interactron":
            assert r["actions"] == run["one"]["actions"]


def _check_inner_step(ranks, one):
    """Every rank's gathered g (head and trunk) and the head's fast weights
    against one process, at 1e-5 x max(max|leaf|, 1e-2)."""
    for r in ranks:
        assert set(r["g"]) == set(one["g"])
        for k, v in one["g"].items():
            _close(r["g"][k], v.numpy(), msg=f"g {k}", floor=1e-2)
        for k, v in r["fast"].items():
            _close(v, one["fast"][k].numpy(), msg=f"fast {k}", floor=1e-2)


def test_tp_inner_step_gradients_match_one_process(tp_runs):
    run = tp_runs["interactron"]
    _check_inner_step(run["ranks"], run["one"])
    head = np.asarray(run["ranks"][0]["g"]["class_embed.weight"])
    assert np.abs(head).max() > 1e-3  # the head's gradient is not trivially zero


def test_reduce_scatter_gather_fails_the_gradient_check(tp_runs):
    """The planted gather (torch.distributed.nn.functional.all_gather) sums
    the tp ranks' gradients in its backward: the head's gradient comes out
    tp times too large, and the check must see it."""
    run = tp_runs["interactron"]
    planted = _ranks(run["tmp"], "planted", 2, run["env"])
    with pytest.raises(AssertionError):
        _check_inner_step(planted, run["one"])
    ratio = (np.asarray(planted[0]["g"]["class_embed.weight"])
             / run["one"]["g"]["class_embed.weight"].numpy())
    np.testing.assert_allclose(np.median(ratio), 2.0, rtol=1e-3)


@pytest.fixture(scope="module")
def uneven_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_tree")
    return make_synthetic_dataset(str(root), n_episodes=3 * 2 - 1, n_states=6, img_size=IMG,
                                  n_categories=NUM_CLASSES - 1)


def test_trainer_dp2_tp2_matches_one_process(uneven_tree, tmp_path):
    """2 epochs over 5 episodes at batch 2 (dp 2): train steps of 1 episode a
    dp rank; the test epochs' batches of 2 sharded, the tail of 1 computed
    whole on every rank; the tp ranks of a dp index run the same slice with
    the heads whole. The same weights and tokens as one process; rank 0
    alone writes checkpoints, ranks 1-3 log to their `-p{r}` directories."""
    d = _multiframe_config(uneven_tree, str(tmp_path / "grid"), batch_size=2)
    ranks = _ranks(tmp_path, "train", 4, env={"PORT_CONFIG": json.dumps(d)})
    one = _multiframe_config(uneven_tree, str(tmp_path / "one"), batch_size=2)
    task = build_model(Config(one), device="cpu").init(42)
    trainer = build_trainer(task, Config(one))
    trainer.train()
    for r in ranks:
        assert r["tokens"] == trainer.tokens == 4
        for k, v in task.state_dict().items():
            np.testing.assert_allclose(np.asarray(r["params"][k], np.float32), v.numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
    assert ranks[0]["files"] == ["detector.ckpt", "last_state.ckpt", "logs"]
    assert not ranks[0]["out_dir"].endswith("-p0")
    for i, r in enumerate(ranks[1:], 1):
        assert r["files"] == ["logs"] and r["out_dir"].endswith(f"-p{i}")


def test_replicate_over_tp_takes_tp_index_zero(tmp_path):
    """dp 2 x tp 2: ranks 0, 1 end with rank 0's tensors, ranks 2, 3 with
    rank 2's, whatever each held (every dtype of the trees)."""
    got = _ranks(tmp_path, "replicate", 4)
    for r, res in enumerate(got):
        src = r - r % 2
        assert res["a"] == [float(src)] * 3 and res["c"] == [[10 + src] * 2] * 2
        assert res["d"] == src * 0.5


def test_build_barrier_builds_once_on_local_rank_zero(tmp_path):
    """Three ranks of one node: local rank 0 builds (0.5 s, then writes a
    marker); the others never call the build and leave the barrier only
    after it has ended."""
    marker = tmp_path / "built"
    got = _ranks(tmp_path, "barrier", 3, env={"MARKER": str(marker)})
    builder = got[0]
    assert len(builder["calls"]) == 2
    for r in got:
        assert r["marker"], "a rank left the barrier before the build ended"
        assert r["after"] >= builder["calls"][1]
        assert [x["built"] for x in r["reports"]] == [True, False, False]
        assert [x["local_rank"] for x in r["reports"]] == [0, 1, 2]
    assert got[1]["calls"] == [] and got[2]["calls"] == []


def test_build_barrier_failure_raises_on_every_rank(tmp_path):
    """A build that fails on local rank 0 fails every rank, none left
    waiting at the barrier."""
    got = _ranks(tmp_path, "barrier", 3, env={"MARKER": str(tmp_path / "built"), "FAIL": "1"})
    for r in got:
        assert r["reports"] == "kernel build failed on rank 0: OSError: nvcc not found"
        assert not r["marker"]
