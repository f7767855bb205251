"""Between the JAX package's parameter tree and the port's named tensors:
``params_from_jax`` (JAX tree → state dict) and ``to_jax_tree`` (named
tensors: parameters, gradients, optimizer moments → the JAX tree layout);
``opt_state_from_jax`` / ``opt_state_to_jax`` carry the AdamW state
(``step``, ``m``, ``v``, ``master``) across the same way, so a run that the
JAX trainer checkpointed can continue in the port and back.

The JAX tree (as numpy arrays, or anything ``np.asarray`` takes) is
``{"embed", "units": {"0_<kind>": {leaf: (n_layers, …)}}, "final_norm",
"head"}``, ``<kind>`` the config's layer kind (``mamba`` or ``mamba2``):
``jax.vmap`` over the layer init gives every block leaf a
leading layer axis. The port keeps one ``ParameterDict`` per layer, so
that axis is split into ``layers.<i>.<leaf>``. Leaf layouts are unchanged:
both packages store dense weights (din, dout) and apply them as ``x @ W``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.optim.adamw import AdamWState


def _unit_key(cfg: ArchConfig) -> str:
    """The JAX tree's key of the layer stack: ``0_`` + the layer kind."""
    return f"0_{cfg.unit[0]}"


def params_from_jax(tree, cfg: ArchConfig, device) -> Dict[str, torch.Tensor]:
    """Returns a state dict for ``LM(cfg, device).load_state_dict``."""
    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    units = tree["units"][_unit_key(cfg)]
    out = {"embed": t(tree["embed"]), "final_norm": t(tree["final_norm"]),
           "head": t(tree["head"])}
    for k, v in units.items():
        v = np.asarray(v)
        if v.shape[0] != cfg.n_layers:
            raise ValueError(f"units leaf {k!r} has {v.shape[0]} layers, "
                             f"config {cfg.name} has {cfg.n_layers}")
        for i in range(cfg.n_layers):
            out[f"layers.{i}.{k}"] = t(v[i])
    return out


def to_jax_tree(named: Dict[str, torch.Tensor], cfg: ArchConfig):
    """The inverse map: ``{"embed", "units": {"0_<kind>": {leaf: (n_layers,
    …)}}, "final_norm", "head"}`` of f32 numpy arrays, the layer axis
    stacked back. Takes any dict keyed like ``LM.named_parameters()``
    (e.g. the gradients of a train step)."""
    def a(t):
        return t.detach().float().cpu().numpy()

    leaves = sorted({k.split(".", 2)[2] for k in named
                     if k.startswith("layers.")})
    units = {leaf: np.stack([a(named[f"layers.{i}.{leaf}"])
                             for i in range(cfg.n_layers)])
             for leaf in leaves}
    return {"embed": a(named["embed"]), "final_norm": a(named["final_norm"]),
            "head": a(named["head"]), "units": {_unit_key(cfg): units}}


def opt_state_from_jax(jstate, cfg: ArchConfig, device) -> AdamWState:
    """The port's ``AdamWState`` from the JAX one (its NamedTuple, or a
    dict with the same fields): ``m``, ``v`` and ``master`` (None when the
    JAX state has none) split along the layer axis as ``params_from_jax``
    does, ``step`` an int."""
    get = (jstate.get if isinstance(jstate, dict)
           else lambda k: getattr(jstate, k))
    master = get("master")
    return AdamWState(
        step=int(np.asarray(get("step"))),
        m=params_from_jax(get("m"), cfg, device),
        v=params_from_jax(get("v"), cfg, device),
        master=None if master is None else params_from_jax(master, cfg,
                                                           device))


def opt_state_to_jax(state: AdamWState, cfg: ArchConfig):
    """The inverse: a dict with the JAX ``AdamWState``'s fields (``step`` an
    int32 array, the trees in the JAX layout; ``AdamWState(**d)`` builds
    the JAX state)."""
    return {"step": np.asarray(state.step, np.int32),
            "m": to_jax_tree(state.m, cfg), "v": to_jax_tree(state.v, cfg),
            "master": None if state.master is None
            else to_jax_tree(state.master, cfg)}
