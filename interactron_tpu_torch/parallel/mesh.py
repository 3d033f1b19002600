"""Episode data parallelism over torch.distributed (counterpart of
interactron_tpu/parallel/mesh.py and the root train.py's
`_maybe_init_distributed`).

Each rank holds the whole model and trains on its share of every batch:
the loader gives it a contiguous slice of each index batch
(data/episode_dataset.py), `data_parallel_grads` runs the task's train step
on that slice and sums the gradients over the ranks, averages the metrics,
and merges the policy path state. The port takes its gradients with
`torch.autograd.grad` (tasks/*.py), so no `.backward()` runs and the hooks
of a `DistributedDataParallel` wrapper would never fire: the sum is an
explicit `all_reduce`, one flattened fp32 bucket per parameter group, as
JAX's `psum` sums the gradient tree.

The ranks are torchrun's: `init_distributed` engages only when RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT are all set. NCCL
serves CUDA tasks, gloo CPU ones; a gloo group reducing CUDA tensors (two
ranks sharing one card in a test) stages them through host memory, since
gloo's CUDA support differs between torch builds.
"""

import os

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device="cuda", backend=None):
    """Join torchrun's process group when its environment is set. Returns
    the device this rank runs on: `cuda:LOCAL_RANK` for a CUDA `device`
    (made current), else `device` unchanged, which it also returns when the
    environment is not set. The backend is NCCL for CUDA and gloo for the
    CPU unless `backend` names one."""
    if not all(k in os.environ for k in _ENV):
        return device
    cuda = torch.device(device).type == "cuda"
    if cuda:
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if cuda else "gloo"), init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return device


def shutdown_distributed():
    """Leave the process group, where one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank():
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size():
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def all_reduce(t, op=dist.ReduceOp.SUM):
    """In-place all_reduce of `t`, through host memory where a gloo group
    meets a CUDA tensor."""
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.all_reduce(host, op=op)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op)
    return t


def fold_in(gen, r):
    """A CPU generator for rank `r` from one draw of `gen` (JAX's
    `fold_in(rng, axis_index)`): every rank draws the same value, so the
    shared stream stays in step, and each rank's stream is its own."""
    draw = int(torch.randint(0, 2**62, (), generator=gen))
    return torch.Generator().manual_seed((draw ^ ((r + 1) * 0x9E3779B97F4A7C15)) % 2**63)


def sum_grads(grads):
    """{group: {name: grad}} summed over the ranks, one flattened fp32
    all_reduce per group."""
    out = {}
    for grp, d in grads.items():
        names = list(d)
        bucket = torch.cat([d[n].reshape(-1).float() for n in names])
        all_reduce(bucket)
        pieces = bucket.split([d[n].numel() for n in names])
        out[grp] = {n: p.view_as(d[n]).to(d[n].dtype) for n, p in zip(names, pieces)}
    return out


def mean_metrics(metrics):
    """{key: 0-d tensor} averaged over the ranks in one all_reduce."""
    keys = list(metrics)
    vec = torch.stack([torch.as_tensor(metrics[k]).double() for k in keys])
    all_reduce(vec)
    vec /= world_size()
    return dict(zip(keys, vec.unbind()))


def merge_path_state(state):
    """The policy path state of every rank merged (<- `_merge_path_state`):
    each rank updated only its own episodes' rows, so each entry takes the
    lowest cost over the ranks and the action of the lowest rank that holds
    it (ties go to the lowest rank, as the serial storage keeps the first
    path it saw). State {"cost": (N, 85), "action": (N, 85)}; an empty
    state is returned as is."""
    if not state:
        return state
    cost, action = state["cost"], state["action"]
    best = all_reduce(cost.clone(), dist.ReduceOp.MIN)
    r, w = rank(), world_size()
    score = torch.where(cost <= best, torch.full_like(action, r), torch.full_like(action, w))
    win = all_reduce(score, dist.ReduceOp.MIN)
    merged = all_reduce(torch.where(win == r, action, torch.zeros_like(action)))
    return {"cost": best, "action": merged}


def data_parallel_grads(task):
    """The task's `grads_and_metrics` over the ranks (<-
    `data_parallel_grads`): called on a rank's own slice of the batch (the
    loader's), with the task's signature, it runs the local step in
    max(1, b_local // INNER_BATCH) microbatches with the rank folded into
    the dropout stream, and returns the gradients summed over the ranks,
    the metrics averaged over them and the merged path state."""

    def grads_fn(batch, gen, path_state=None, train=True, frame_index=None):
        g, m, state = task.grads_and_metrics(batch, fold_in(gen, rank()), path_state,
                                             train=train, frame_index=frame_index)
        return sum_grads(g), mean_metrics(m), merge_path_state(state)

    return grads_fn
