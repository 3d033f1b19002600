"""Episode data parallelism and tensor-parallel class heads over
torch.distributed (counterpart of interactron_tpu/parallel/mesh.py and the
root train.py's `_maybe_init_distributed`).

The ranks form a dp x tp grid (`make_grid`, <- `make_mesh`): rank r has dp
index r // tp and tp index r % tp, and holds a process group of the ranks
that share its tp index (its dp group) and one of those that share its dp
index (its tp group). Over dp, each rank holds the whole model and trains
on its share of every batch:
the loader gives it a contiguous slice of each index batch
(data/episode_dataset.py), `data_parallel_grads` runs the task's train step
on that slice and sums the gradients over the ranks, averages the metrics,
and merges the policy path state. The port takes its gradients with
`torch.autograd.grad` (tasks/*.py), so no `.backward()` runs and the hooks
of a `DistributedDataParallel` wrapper would never fire: the sum is an
explicit `all_reduce`, one flattened fp32 bucket per parameter group, as
JAX's `psum` sums the gradient tree. The dp collectives reduce over the
grid's dp group; the ranks of one tp group hold the same episodes and
compute the same step, as JAX replicates the batch over tp.

Over tp, `shard_heads` (<- `param_shardings`) keeps rows [i*N/tp,
(i+1)*N/tp) of the two N = 1236-way class-head weights on tp rank i
(`class_embed`, `logit_decoder`; their biases stay whole): such a Dense
computes its local columns, gathers them over the tp group (`tp_gather`)
and adds the whole bias; its input passes `tp_copy`, whose backward sums
the input gradient over tp. This serves `predict` and `next_action`; a
grid's training keeps the heads whole, as JAX's `data_parallel_grads`
does.

The ranks are torchrun's: `init_distributed` engages only when RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT are all set. NCCL
serves CUDA tasks, gloo CPU ones; a gloo group reducing CUDA tensors (two
ranks sharing one card in a test) stages them through host memory, since
gloo's CUDA support differs between torch builds.
"""

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device="cuda", backend=None, build=None):
    """Join torchrun's process group when its environment is set. Returns
    the device this rank runs on: for a CUDA `device`, made current, the
    card it names or else `cuda:LOCAL_RANK`; otherwise `device` unchanged,
    which it also returns when the environment is not set. The backend is
    NCCL for CUDA and gloo for the CPU unless `backend` names one.

    A CUDA group of several ranks then builds the kernels before any rank
    loads one (parallel/lockstep.py): local rank 0 runs `build`
    (`cuda_build.build_all` unless given) and every rank waits for it."""
    if not all(k in os.environ for k in _ENV):
        return device
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    local_rank = int(os.environ["LOCAL_RANK"])
    if cuda:
        device = str(dev) if dev.index is not None else f"cuda:{local_rank}"
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if cuda else "gloo"), init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    if cuda and dist.get_world_size() > 1:
        from interactron_tpu_torch.parallel.lockstep import build_barrier

        build_barrier(local_rank, build)
    return device


def shutdown_distributed():
    """Leave the process group, where one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank():
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size():
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


@dataclass(frozen=True)
class Grid:
    """This rank's place on the dp x tp grid and its two groups (None on
    the trivial grid of one process, where no collective runs)."""

    dp: int = 1
    tp: int = 1
    dp_index: int = 0
    tp_index: int = 0
    dp_group: object = None
    tp_group: object = None


def make_grid(dp=None, tp=1):
    """The dp x tp grid over the world (<- `make_mesh`): dp defaults to
    world // tp, and dp * tp must be the world. The layout is
    `np.arange(world).reshape(dp, tp)`: rank r has dp index r // tp and tp
    index r % tp. Every rank creates every group, in the same order (dp
    groups by tp index, then tp groups by dp index), as `new_group`
    requires. At world 1 it is the trivial grid."""
    world = world_size()
    dp = world // tp if dp is None else dp
    if dp * tp != world:
        raise ValueError(f"grid {dp}x{tp} != {world} ranks")
    if world == 1:
        return Grid()
    r = rank()
    dp_groups = [dist.new_group([i * tp + j for i in range(dp)]) for j in range(tp)]
    tp_groups = [dist.new_group([i * tp + j for j in range(tp)]) for i in range(dp)]
    return Grid(dp, tp, r // tp, r % tp, dp_groups[r % tp], tp_groups[r // tp])


def all_reduce(t, op=dist.ReduceOp.SUM, group=None):
    """In-place all_reduce of `t` over `group` (the world by default),
    through host memory where a gloo group meets a CUDA tensor."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(tensors, src, group):
    """Broadcast `tensors` in place from global rank `src` over `group`, one
    flat bucket per dtype (through host memory where a gloo group meets
    CUDA tensors)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        bucket = torch.cat([t.reshape(-1) for t in ts])
        if bucket.is_cuda and dist.get_backend(group) == "gloo":
            bucket = bucket.cpu()
        dist.broadcast(bucket, src, group=group)
        for t, piece in zip(ts, bucket.split([t.numel() for t in ts])):
            t.copy_(piece.view_as(t))


def replicate_over_tp(grid, *trees):
    """Nested dicts of tensors made equal, in place, on every rank of the
    grid's tp group to those of its tp index 0. The tp ranks of a dp index
    compute the same step on the same episodes, but the card's sums are not
    bitwise reproducible (cuDNN, the merged kernels' reduce-adds), and the
    ill-conditioned model would carry such bits apart over steps; JAX
    replicates these values over tp by construction. Nothing happens at tp
    1."""
    if grid.tp == 1:
        return

    def leaves(x):
        if torch.is_tensor(x):
            yield x
        elif isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)

    broadcast_([t for tree in trees for t in leaves(tree)], grid.dp_index * grid.tp,
               grid.tp_group)


def all_gather_last(t, group):
    """The tensors of every rank of `group`, in rank order, concatenated on
    the last axis (through host memory where a gloo group meets a CUDA
    tensor)."""
    src = t.contiguous()
    if src.is_cuda and dist.get_backend(group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=-1).to(t.device)


class _TPCopy(torch.autograd.Function):
    """Identity forward; backward sums the input gradient over tp, since
    each rank's head holds only its own columns' share of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), group=ctx.group), None


class _TPGather(torch.autograd.Function):
    """Forward gathers every tp rank's columns on the last axis; backward
    takes this rank's slice of the gradient, with no communication: every
    tp rank computes the same replicated loss, so the gradient of its own
    columns is already whole. (torch.distributed.nn's all_gather sums the
    ranks' gradients instead, tp times too large here.)"""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group, ctx.cols = group, y.shape[-1]
        return all_gather_last(y, group)

    @staticmethod
    def backward(ctx, g):
        start = dist.get_rank(ctx.group) * ctx.cols
        return g.narrow(-1, start, ctx.cols).contiguous(), None


def tp_copy(x, group):
    return _TPCopy.apply(x, group)


def tp_gather(y, group):
    return _TPGather.apply(y, group)


def _is_head(name):
    """Whether a Dense of this dotted name is a class head that `shard_heads`
    splits (<- `_is_head_kernel`)."""
    return "class_embed" in name or "logit_decoder" in name


def shard_heads(task, grid):
    """Split the task's class heads over the grid's tp group in place (<-
    `param_shardings`): the (N, in) weight of each Dense named by `_is_head`
    keeps rows [i*N/tp, (i+1)*N/tp) on tp rank i, its bias stays whole.
    Returns the sharded weights' names; nothing changes at tp 1."""
    from interactron_tpu_torch.models.layers import Dense

    if grid.tp == 1:
        return []
    names = []
    for name, mod in task.named_modules():
        if not (isinstance(mod, Dense) and _is_head(name) and mod.weight.dim() == 2):
            continue
        n = mod.weight.shape[0]
        if n % grid.tp:
            raise ValueError(f"tp {grid.tp} does not divide {name}'s {n} outputs")
        rows = n // grid.tp
        mod.weight = nn.Parameter(mod.weight.detach()[grid.tp_index * rows:
                                                      (grid.tp_index + 1) * rows].clone(),
                                  requires_grad=False)
        mod.tp_group = grid.tp_group
        names.append(f"{name}.weight")
    return names


def fold_in(gen, r):
    """A CPU generator for rank `r` from one draw of `gen` (JAX's
    `fold_in(rng, axis_index)`): every rank draws the same value, so the
    shared stream stays in step, and each rank's stream is its own."""
    draw = int(torch.randint(0, 2**62, (), generator=gen))
    return torch.Generator().manual_seed((draw ^ ((r + 1) * 0x9E3779B97F4A7C15)) % 2**63)


def sum_grads(grads, group=None):
    """{group: {name: grad}} summed over the ranks of `group` (the world by
    default), one flattened fp32 all_reduce per parameter group."""
    out = {}
    for grp, d in grads.items():
        names = list(d)
        bucket = torch.cat([d[n].reshape(-1).float() for n in names])
        all_reduce(bucket, group=group)
        pieces = bucket.split([d[n].numel() for n in names])
        out[grp] = {n: p.view_as(d[n]).to(d[n].dtype) for n, p in zip(names, pieces)}
    return out


def mean_metrics(metrics, group=None):
    """{key: 0-d tensor} averaged over the ranks of `group` (the world by
    default) in one all_reduce."""
    keys = list(metrics)
    vec = torch.stack([torch.as_tensor(metrics[k]).double() for k in keys])
    all_reduce(vec, group=group)
    vec /= dist.get_world_size(group)
    return dict(zip(keys, vec.unbind()))


def merge_path_state(state, group=None):
    """The policy path state of every rank of `group` (the world by
    default) merged (<- `_merge_path_state`): each rank updated only its
    own episodes' rows, so each entry takes the lowest cost over the ranks
    and the action of the lowest rank that holds it (ties go to the lowest
    rank, as the serial storage keeps the first path it saw). State
    {"cost": (N, 85), "action": (N, 85)}; an empty state is returned as
    is."""
    if not state:
        return state
    cost, action = state["cost"], state["action"]
    best = all_reduce(cost.clone(), dist.ReduceOp.MIN, group)
    r, w = dist.get_rank(group), dist.get_world_size(group)
    score = torch.where(cost <= best, torch.full_like(action, r), torch.full_like(action, w))
    win = all_reduce(score, dist.ReduceOp.MIN, group)
    merged = all_reduce(torch.where(win == r, action, torch.zeros_like(action)), group=group)
    return {"cost": best, "action": merged}


def data_parallel_grads(task, grid=None):
    """The task's `grads_and_metrics` over the grid's dp group (<-
    `data_parallel_grads`; the dp-only grid of the world by default):
    called on a rank's own slice of the batch (the loader's), with the
    task's signature, it runs the local step in max(1, b_local //
    INNER_BATCH) microbatches with the dp index folded into the dropout
    stream, and returns the gradients summed over dp, the metrics averaged
    over dp and the merged path state. The ranks of one tp group run the
    same slice and stream, and then take tp index 0's results
    (`replicate_over_tp`)."""
    grid = grid or make_grid()

    def grads_fn(batch, gen, path_state=None, train=True, frame_index=None):
        g, m, state = task.grads_and_metrics(batch, fold_in(gen, grid.dp_index), path_state,
                                             train=train, frame_index=frame_index)
        group = grid.dp_group
        g, m, state = sum_grads(g, group), mean_metrics(m, group), merge_path_state(state, group)
        replicate_over_tp(grid, g, m, state)
        return g, m, state

    return grads_fn
