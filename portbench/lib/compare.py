"""The numbers that decide `correct`, and the plain reference built for them.

Train cells, over the first three steps of the one trainer the window then
uses (the reference follows them from the same weights, batches and
generator):
  * g_err: the first step's inner gradients (the learned loss's gradient
    of each microbatch's episodes, before any step): the median leaf's
    ‖g_program - g_ref‖ / ‖g_ref‖, in units of the same for the reference
    with its weights rounded to bf16 (a seed's weights set how far any
    rounding moves g: one seed read 4x another at both precisions), the
    worst microbatch's;
  * change_gap: the median leaf's |‖Δ_program‖ - ‖Δ_ref‖| / ‖Δ_ref‖ of the
    parameters' change after three steps, over the leaves whose first
    gradient in the reference is at least a thousandth of the median
    leaf's (smaller ones move under Adam by round-off alone). A state left
    unchanged reads 1. The worst leaf's (`change_worst`) is read, not
    compared: the worst leaves are biases of 1 to 768 elements (gradients
    0.1-4x the median leaf's) whose bf16 updates take the reference's sign
    in 0-92% of their elements over the three steps, against 96-100% with
    the program in fp32 (every leaf then within 0.018), and two bf16 runs
    of one seed differ (0.05-0.09 between them): PERF.md gives the look.
Read and printed but not compared (PERF.md says why): `loss_gap`, |L_program
- L_ref| / |L_ref| of the first step's mean total loss, the later steps'
losses, and `grad_gap`, the worst leaf's |‖g‖ - ‖g_ref‖| / max(‖g_ref‖,
median) of the clipped first gradient Adam got.
Serve cells: drivers/serve.py.
"""

import statistics

import torch

from portbench.reference.config import Config
from portbench.reference.task import ReferenceTask

BETA1 = 0.9
MOVED = 1e-3  # a leaf moves when its reference gradient is at least this x the median's


def reference(model_config, weights, device):
    """The fp32 reference task holding `weights`."""
    task = ReferenceTask(Config(model_config), device)
    task.load_state_dict({k: v.to(device) for k, v in weights.items()})
    return task


def norms(named):
    return {n: float(t.detach().float().norm()) for n, t in named.items()}


def worst_gap(prog, ref, keep=None):
    """(gap, leaf): the worst leaf's |prog - ref| / max(ref, median ref)."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30) for n in names}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def moved_leaves(ref_grads):
    med = statistics.median(ref_grads.values())
    return {n for n, v in ref_grads.items() if v >= MOVED * med}


def first_moments(opts, modules):
    """{group.name: tensor}: each parameter's Adam first moment over
    1 - beta1, the gradient Adam got at its first step (zeros where it
    holds no state)."""
    out = {}
    for grp, mod in modules.items():
        state = opts[grp].state
        for name, p in mod.named_parameters():
            m = state.get(p, {}).get("exp_avg")
            out[f"{grp}.{name}"] = (m / (1.0 - BETA1)) if m is not None else torch.zeros_like(p)
    return out


def params(modules):
    return {f"{grp}.{n}": p.detach().clone() for grp, mod in modules.items()
            for n, p in mod.named_parameters()}


def median_leaf_err(got, want):
    """The median leaf's ‖got - want‖ / ‖want‖."""
    errs = [float((got[k].float() - w.float()).norm() / w.float().norm().clamp(min=1e-30))
            for k, w in want.items()]
    return statistics.median(errs)


def train_numbers(prog, ref):
    """prog and ref: {"losses": [3], "inner_g": [{leaf: tensor}] a
    microbatch, "grads": {leaf: norm}, "change": {leaf: norm}} ->
    ([(name, value)] compared, {name: value} read but not compared)."""
    loss_gap = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    by_mb = [median_leaf_err(p["g"], r["g"]) / median_leaf_err(r["unit"], r["g"])
             for p, r in zip(prog["inner_g"], ref["inner_g"])]
    g_err = max(by_mb, default=float("inf"))
    if len(prog["inner_g"]) != len(ref["inner_g"]):
        g_err = float("inf")
    moved = moved_leaves(ref["grads"])
    change_gap = statistics.median(abs(prog["change"].get(n, 0.0) - ref["change"][n])
                                   / max(ref["change"][n], 1e-30) for n in moved)
    return [("g_err", g_err), ("change_gap", change_gap)], {
        "loss_gap": loss_gap, "change_worst": worst_gap(prog["change"], ref["change"], moved),
        "g_err_by_microbatch": by_mb,
        "g_worst_leaves": worst_leaves(prog["inner_g"], ref["inner_g"])}


def worst_leaves(prog, ref, top=3):
    """Each microbatch's `top` leaves by ‖g_program - g_ref‖ / ‖g_ref‖, with
    ‖g_ref‖."""
    out = []
    for p, r in zip(prog, ref):
        errs = sorted(((float((p["g"][k].float() - w.float()).norm() / w.float().norm().clamp(
            min=1e-30)), k, float(w.float().norm())) for k, w in r["g"].items()), reverse=True)
        out.append(errs[:top])
    return out
