"""The LM train-step factory: loss and gradients by autograd, microbatch
gradient accumulation, optional int8 error-feedback gradient compression,
and AdamW. Counterpart of ``repro/train/trainer.py`` on one device.

Gradients are computed as JAX's ``value_and_grad`` gives them: in each
parameter's dtype with one microbatch (bf16 at the full configs), summed in
f32 over ``n_microbatch`` microbatches and divided by their count, as the
JAX package's scan does. The loss sees every stacked leaf (the layers of
each family, the hybrid's mamba stacks) as one autograd leaf per layer
(views of the parameters), and each gradient is added into its row of the
stacked gradient as soon as autograd has it, so no full-size gradient of a
stacked leaf is built per layer and the accumulation holds one gradient
tree at a time.

The step gives up its input state: the new parameters and moments are
written into its tensors, as the JAX launcher's jitted step donates its
state. A caller that keeps an old state clones it first.

Data parallel (``make_train_step(ctx=)`` under a multi-controller
context, the counterpart of JAX's ``batch_sharding``): each host computes
the gradients of its own rows, and the gradient tree and the loss are
averaged over the hosts (``collectives.allreduce_mean_``) after the
microbatch accumulation and before the compression, the clipping and the
update — the order JAX's psum-then-compress gives. Every host then applies
the same update to the same state.

Sharded state (``make_train_step(ctx=, specs=)``, the counterpart of the
JAX launcher's ``default_rules(mesh, fsdp=cfg.fsdp)``): :func:`state_specs`
lays the state out over the processes (``repro_torch.distributed.fsdp``),
and the state holds this process's slices of every leaf with an ``embed``
axis — parameters (``api.init_params(specs=)`` draws them a layer at a
time), and so gradients and both moments.
The loss reads each split leaf through a gather (``fsdp.Gathered``), one
layer at a time, whose backward reduce-scatters that layer's gradient as
autograd produces it; :func:`finish_step` averages only the whole leaves'
gradients and the loss over the hosts, and the update runs on the slices
(``optimizer.apply_updates(splits=)``). Error-feedback compression
(``grad_compress``) keeps its residual laid out like the parameters, as
JAX's ``train_state_axes`` gives it the parameters' axes: each process
compresses its slices of the split leaves' gradients as they arrive
reduce-scattered and the whole leaves' gradients after their average
(JAX's psum, then compress, then clip and update); a leaf split along its
last dimension takes each row's max over the processes
(``optimizer.compress_tree_``), so payload, scales and residual are the
whole leaf's bit for bit.

Sharding metadata: :func:`train_state_axes` gives the train state's
logical axes (``repro_torch.distributed.sharding``); ``make_train_step``'s
``grad_shardings`` takes the gradients' spec tree, checked against the
parameters' structure. It changes no value, as JAX's
``with_sharding_constraint`` on the gradients changes none: the port's
step keeps every gradient whole on each device.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import tree as tu
from repro_torch.distributed import collectives, fsdp
from repro_torch.train import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt: opt.AdamWState
    ef: Optional[opt.EFState]  # error-feedback residual (None = off)


def init_train_state(params, ocfg: opt.AdamWConfig, *, grad_compress: bool = False,
                     specs: Optional[TrainState] = None):
    """The state of ``params``. ``specs`` (:func:`state_specs`): ``params``
    are this process's slices (``api.init_params(specs=specs.params)``, or
    ``fsdp.shard_tree``), and the moments and the error-feedback residual
    take the slices' shapes."""
    if specs is not None:
        for p, s in zip(tu.leaves(params), tu.leaves(specs.params)):
            if s.split and p.shape[s.dim] != s.chunk:
                raise ValueError(f"a param of shape {tuple(p.shape)} is not this process's "
                                 f"slice under {s}")
    return TrainState(
        params=params,
        opt=opt.init_state(params, ocfg),
        ef=opt.ef_init(params) if grad_compress else None,
    )


def train_state_axes(param_axes: Any, ocfg: opt.AdamWConfig, *, grad_compress: bool = False):
    """The logical axes of :func:`init_train_state`'s state."""
    return TrainState(
        params=param_axes,
        opt=opt.state_axes(param_axes, ocfg),
        ef=opt.EFState(residual=param_axes) if grad_compress else None,
    )


def state_specs(param_axes: Any, param_shapes: Any, ocfg: opt.AdamWConfig, rules, ctx, *,
                grad_compress: bool = False):
    """The layout of :func:`init_train_state`'s state over the processes of
    ``ctx`` under the sharding ``rules`` (``sharding.default_rules(mesh,
    fsdp=True)`` splits every ``embed`` axis): a TrainState of
    ``fsdp.Shard``, the error-feedback residual (``grad_compress``) laid
    out like the parameters. ``param_shapes``: the params tree, ``meta``
    tensors will do."""
    return fsdp.local_specs(
        train_state_axes(param_axes, ocfg, grad_compress=grad_compress),
        init_train_state(param_shapes, ocfg, grad_compress=grad_compress), rules, ctx)


def _check_grad_shardings(grad_shardings: Any) -> Callable:
    """A check that ``grad_shardings`` (a tree of specs: tuples of mesh axis
    names or None) has the parameters' structure, run on the first step."""
    from repro_torch.distributed.sharding import is_spec

    want = tu.flatten_with_paths(grad_shardings, is_leaf=is_spec)[0]

    def check(params):
        got = tu.flatten_with_paths(params)[0]
        if got != want:
            raise ValueError(f"grad_shardings does not have the parameters' structure: "
                             f"{sorted(set(got) ^ set(want))[:4]} differ")

    return check


def _split_microbatches(batch: dict, n_mb: int) -> dict:
    def split(x):
        b = x.shape[0]
        assert b % n_mb == 0, (b, n_mb)
        return x.reshape(n_mb, b // n_mb, *x.shape[1:])

    return tu.tree_map(split, batch)


# the stacked subtrees of the params trees, by top-level key, and the number
# of leading layer axes of each: the dense, MoE, ssm and vlm families'
# ``layers`` (L, ...), the hybrid's ``mamba`` (n_super, attn_every, ...) and
# its ``tail`` (n_tail, ...), the audio family's ``encoder`` and ``decoder``
# (L, ...)
STACKED = {"layers": 1, "mamba": 2, "tail": 1, "encoder": 1, "decoder": 1}


def _autograd_views(params: dict, grads: dict, *, accumulate: bool, specs=None,
                    ctx=None) -> dict:
    """The params tree the loss sees: every leaf a detached view that
    requires grad, each subtree of :data:`STACKED` as nested lists of
    per-layer trees (one level per layer axis). Each view's gradient is
    copied (or, with ``accumulate``, added in f32) into the matching view of
    ``grads`` when autograd produces it, and then dropped. ``specs``: the
    params' layout over the processes of ``ctx``; each per-layer tree (and
    each unstacked subtree) is then an ``fsdp.Gathered`` over the views of
    this process's slices."""

    def view(p, g):
        v = p.detach().requires_grad_(True)

        def land(v_):
            if accumulate:
                g.add_(v_.grad)
            else:
                g.copy_(v_.grad)
            v_.grad = None

        v.register_post_accumulate_grad_hook(land)
        return v

    def per_layer(p, g, sp, lead: int):
        if not lead:
            views = tu.tree_map(view, p, g)
            if sp is None:
                return views
            if isinstance(views, dict):
                return fsdp.Gathered(views, sp, ctx)
            return fsdp.gather(views, sp, ctx)
        n = tu.leaves(p)[0].shape[0]
        inner = None if sp is None else tu.tree_map(lambda s: s.inner(1), sp)
        return [per_layer(tu.tree_map(lambda a: a[i], p), tu.tree_map(lambda a: a[i], g),
                          inner, lead - 1) for i in range(n)]

    return {k: per_layer(params[k], grads[k], None if specs is None else specs[k],
                         STACKED.get(k, 0)) for k in params}


def loss_and_grads(loss_fn: Callable, params: dict, batch: dict, *, n_microbatch: int = 1,
                   specs=None, ctx=None):
    """(loss, grads) of ``loss_fn`` at ``params`` over ``batch``: one
    backward in the parameters' dtype, or the f32 mean over
    ``n_microbatch`` microbatches. The loss is an f32 scalar. ``specs``:
    the params' layout over the processes of ``ctx`` (``params`` this
    process's slices); the split leaves' gradients come back as this
    process's slices of their mean over the processes."""
    f32 = torch.float32
    if n_microbatch == 1:
        grads = tu.tree_map(torch.zeros_like, params)
        loss = loss_fn(_autograd_views(params, grads, accumulate=False, specs=specs, ctx=ctx),
                       batch)
        loss.backward()
        return loss.detach().to(f32), grads
    grads = tu.tree_map(lambda p: torch.zeros(p.shape, dtype=f32, device=p.device), params)
    views = _autograd_views(params, grads, accumulate=True, specs=specs, ctx=ctx)
    mbs = _split_microbatches(batch, n_microbatch)
    loss = torch.zeros((), dtype=f32, device=tu.leaves(params)[0].device)
    for i in range(n_microbatch):
        l_mb = loss_fn(views, {k: v[i] for k, v in mbs.items()})
        l_mb.backward()
        loss = loss + l_mb.detach()
    for g in tu.leaves(grads):
        g.div_(n_microbatch)
    return loss / n_microbatch, grads


def make_train_step(
    loss_fn: Callable,
    ocfg: opt.AdamWConfig,
    *,
    n_microbatch: int = 1,
    grad_compress: bool = False,
    grad_shardings: Any = None,
    batch_sharding: Any = None,
    ctx=None,
    specs: Optional[TrainState] = None,
):
    """Returns ``train_step(state, batch) -> (new_state, metrics)``; the
    metrics are ``loss``, ``grad_norm``, ``lr`` and ``step``. ``batch`` is a
    dict of (B, ...) tensors on the parameters' device: this host's rows.

    ``ctx``: a :class:`repro_torch.distributed.runtime.DistributedContext`.
    Multi-controller: the gradients and the loss are averaged over the
    hosts before the update, so every host steps the same state.

    ``specs``: the state's layout (:func:`state_specs`, with
    ``grad_compress=`` as here) over the processes of ``ctx``'s group: the
    step takes and returns a sharded state.

    ``grad_shardings``: the gradients' spec tree (``sharding.tree_specs``
    of the parameters' axes), checked against the parameters' structure at
    the first step; it changes no value."""
    check_specs = None if grad_shardings is None else _check_grad_shardings(grad_shardings)
    if batch_sharding is not None:
        raise NotImplementedError("batch_sharding: a torch step takes no batch sharding; "
                                  "pass ctx= (a multi-controller DistributedContext) for "
                                  "the data-parallel step")
    data_parallel = ctx is not None and ctx.is_multi_controller
    if specs is not None:
        if ctx is None or ctx.backend is None:
            raise ValueError("specs= lays the state out over a job's processes: pass the "
                             "ctx= of its process group")
    split = None if specs is None else specs.params

    def train_step(state: TrainState, batch: dict):
        nonlocal check_specs
        if check_specs is not None:
            check_specs(state.params)
            check_specs = None
        loss, grads = loss_and_grads(loss_fn, state.params, batch, n_microbatch=n_microbatch,
                                     specs=split, ctx=ctx)
        return finish_step(state, loss, grads, ocfg, grad_compress=grad_compress,
                           ctx=ctx if data_parallel or split is not None else None, splits=split)

    return train_step


def finish_step(state: TrainState, loss, grads, ocfg: opt.AdamWConfig, *,
                grad_compress: bool = False, ctx=None, splits=None):
    """The step after the gradients: the data-parallel average over the
    hosts of ``ctx`` (None: one host), the error-feedback compression (its
    new residual written into ``state.ef``), the clipped AdamW update
    written into ``state``, and the metrics. Returns (new state, metrics).
    ``splits``: the params' layout (``fsdp.Shard`` per leaf); the split
    leaves' gradients arrive averaged, and only the whole ones and the loss
    are averaged here."""
    if ctx is not None:
        loss = loss.reshape(1)
        mean = tu.leaves(grads) if splits is None else [
            g for g, s in zip(tu.leaves(grads), tu.leaves(splits)) if not s.split]
        collectives.allreduce_mean_(mean + [loss], ctx)
        loss = loss[0]
    new_ef = None
    if grad_compress and state.ef is not None:
        grads = opt.compress_tree_(grads, state.ef, splits=splits, ctx=ctx)
        new_ef = state.ef
    new_params, new_opt = opt.apply_updates(state.params, grads, state.opt, ocfg, donate=True,
                                            splits=splits, ctx=ctx)
    metrics = {
        "loss": loss,
        "grad_norm": opt.global_norm(grads, splits=splits, ctx=ctx),
        "lr": opt.lr_schedule(ocfg, new_opt.step),
        "step": new_opt.step.clone(),  # the state's own step is updated in place
    }
    return TrainState(params=new_params, opt=new_opt, ef=new_ef), metrics
