"""Carry detector and training state between the JAX package and the port.

:func:`params_from_numpy` takes the JAX parameter, tdBN-state and
(optionally) fused-kernel affine-bundle pytrees as numpy arrays — e.g.
``jax.tree_util.tree_map(np.asarray, params)``, or the leaves of a detector
checkpoint — and returns the port's. The affine bundle carries
``rsqrt(var + eps)`` as the JAX package rounded it; handing it to
``compile_detector(..., affines=...)`` keeps every spike decision bit-equal
to the reference, where recomputing it with ``torch.rsqrt`` would not be.

:func:`opt_state_from_numpy` takes a JAX ``AdamWState`` (f32 or int8
``Q8Leaf`` moments) with numpy leaves and returns the port's;
:func:`tree_to_numpy` goes the other way for any of the port's trees.
:func:`train_state_from_numpy` and :func:`train_state_to_numpy` carry an LM
``TrainState`` (parameters, AdamW state, error-feedback residual) across
both ways. :func:`lm_params_from_numpy` carries any LM family's
parameters across, and :func:`lm_cache_from_numpy` / :func:`lm_cache_to_numpy`
any LM cache (``KVCache``, ``QuantKVCache``, ``RWKVState``, ``HybridCache``,
``WhisperCache``), leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.backend import resolve_device
from repro_torch.kernels.bitmask_matmul import PackedMatmulWeights
from repro_torch.train import optimizer as opt


def _tensor(a, device) -> torch.Tensor:
    """numpy → tensor on ``device`` (a writable copy: torch refuses read-only
    arrays); bfloat16 (ml_dtypes', as JAX hands it to numpy) is carried bit
    for bit."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def affine_rows(bundle: np.ndarray, kout: int) -> np.ndarray:
    """JAX (KB, 5, KBLK) bundle → (5, kout) per-channel rows."""
    b = np.asarray(bundle, np.float32)
    return b.transpose(1, 0, 2).reshape(b.shape[1], -1)[:, :kout]


def params_from_numpy(params_np: dict, bn_np: dict, affines_np: dict | None = None,
                      *, device=None):
    """(params, bn_state, affines) on ``device`` (default: the card).
    ``affines`` is {layer: (5, kout) f32} or None when no bundles are given."""
    dev = resolve_device(device)
    params = {n: {k: _tensor(v, dev) for k, v in p.items()} for n, p in params_np.items()}
    bn = {n: {k: _tensor(v, dev) for k, v in s.items()} for n, s in bn_np.items()}
    affines = None
    if affines_np is not None:
        affines = {
            n: _tensor(affine_rows(b, params[n]["w"].shape[-1]), dev)
            for n, b in affines_np.items()
        }
    return params, bn, affines


def packed_matmul_from_numpy(maskp, vals, shape, kblk: int, nblk: int, *,
                             device=None) -> PackedMatmulWeights:
    """A JAX ``PackedMatmulWeights``'s maskp/vals (numpy, e.g.
    ``np.asarray(pw.maskp)``), shape and blocks → the port's, on ``device``
    (default: the card)."""
    dev = resolve_device(device)
    return PackedMatmulWeights(
        maskp=_tensor(maskp, dev), vals=_tensor(vals, dev),
        shape=tuple(int(d) for d in shape), kblk=int(kblk), nblk=int(nblk),
    )


def opt_state_from_numpy(state_np, *, device=None) -> opt.AdamWState:
    """A JAX ``AdamWState`` whose leaves are numpy arrays (e.g.
    ``jax.tree_util.tree_map(np.asarray, state)``) → the port's, on
    ``device`` (default: the card). Moment leaves with ``q`` and ``scale``
    fields become :class:`~repro_torch.train.optimizer.Q8Leaf`."""
    dev = resolve_device(device)

    def moments(tree):
        if isinstance(tree, dict):
            return {k: moments(v) for k, v in tree.items()}
        if hasattr(tree, "q") and hasattr(tree, "scale"):
            return opt.Q8Leaf(_tensor(tree.q, dev), _tensor(tree.scale, dev))
        return _tensor(tree, dev)

    return opt.AdamWState(step=_tensor(state_np.step, dev), m=moments(state_np.m),
                          v=moments(state_np.v))


def tree_to_numpy(tree):
    """The port's tree (dicts, NamedTuples, sequences of tensors) with every
    tensor copied to a host numpy array; the containers keep their types."""
    return tu.tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                       else np.asarray(x), tree)


# leaves every family keeps in f32 whatever its param dtype: the MoE router,
# rwkv6's decay base and bonus, mamba2's decay, skip and dt bias
F32_LEAVES = frozenset({"router", "w0", "u", "A_log", "D", "dt_bias"})


def lm_params_from_numpy(tree, cfg, *, device=None) -> dict:
    """The params tree of the JAX package's ``zoo.get_api(cfg).init_params``
    (any family) with numpy leaves (f32, or ml_dtypes bf16) → the port's,
    on ``device`` (default: the card), each leaf in the dtype the port's own
    init gives it: f32 for :data:`F32_LEAVES`, ``cfg.param_dtype``
    elsewhere. A bf16 leaf that crossed as f32 comes back exactly."""
    dev = resolve_device(device)

    def leaf(keys, a):
        want = torch.float32 if keys[-1][1] in F32_LEAVES else cfg.param_dtype
        return _tensor(a, dev).to(want)

    if "layers" in tree and not isinstance(tree["layers"], dict):
        raise ValueError("the port's layers are stacked (L, ...): want params['layers'] "
                         "as a dict of stacked leaves (scan_layers=True)")
    return tu.map_with_keys(leaf, tree)


def train_state_from_numpy(state_np, cfg, *, device=None):
    """A JAX ``trainer.TrainState`` with numpy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, state)``) → the port's, on
    ``device`` (default: the card): the parameters as
    :func:`lm_params_from_numpy` gives them, the AdamW state as
    :func:`opt_state_from_numpy`, and the error-feedback residual (f32) or
    None."""
    from repro_torch.train import trainer

    dev = resolve_device(device)
    ef = None
    if state_np.ef is not None:
        ef = opt.EFState(residual=tu.tree_map(lambda a: _tensor(a, dev).float(),
                                              state_np.ef.residual))
    return trainer.TrainState(params=lm_params_from_numpy(state_np.params, cfg, device=dev),
                              opt=opt_state_from_numpy(state_np.opt, device=dev), ef=ef)


def train_state_to_numpy(state):
    """The port's ``TrainState`` with every leaf a host numpy copy (the
    step updates a state in place), bf16 widened to f32 (exact): leaf for
    leaf, by the same paths, the JAX package's ``TrainState`` under
    ``tree_map(np.asarray, ...)``."""
    return tu.tree_map(lambda x: np.array((x.float() if x.dtype == torch.bfloat16 else x)
                                          .detach().cpu().numpy()), state)


def _cache_types() -> dict:
    """The port's cache types by their fields (the JAX package's name the
    same fields)."""
    from repro_torch.models import hybrid, mamba2, rwkv6, whisper
    from repro_torch.models import transformer as tfm

    kinds = (tfm.KVCache, tfm.QuantKVCache, rwkv6.RWKVState, mamba2.MambaState,
             hybrid.HybridCache, whisper.WhisperCache)
    return {k._fields: k for k in kinds}


def lm_cache_from_numpy(cache_np, *, device=None):
    """A JAX LM cache with numpy leaves — ``KVCache``, ``QuantKVCache``,
    ``RWKVState``, ``HybridCache`` (its ``tail`` possibly None) or
    ``WhisperCache``, or a plain tuple of 2 or 4 arrays for the first two —
    → the port's type, on ``device`` (default: the card), each leaf in its
    own dtype (bf16 carried bit for bit)."""
    dev = resolve_device(device)
    kinds = _cache_types()

    def convert(node):
        if node is None:
            return None
        fields = getattr(type(node), "_fields", None)
        if fields is None and isinstance(node, tuple):  # a bare KV tuple
            fields = ("k", "v", "k_scale", "v_scale")[:len(node)]
        if fields is None:
            return _tensor(node, dev)
        return kinds[tuple(fields)](*(convert(c) for c in node))

    return convert(cache_np)


def lm_cache_to_numpy(cache):
    """Any of the port's LM caches with every leaf a host numpy array, bf16
    widened to f32 (exact), in the same NamedTuple types (tuples: a
    ``KVCache`` still unpacks as (k, v))."""
    return tu.tree_map(lambda x: (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy(),
                       cache)
