"""Between the JAX package's parameter tree and the port's named tensors:
``params_from_jax`` (JAX tree → state dict) and ``to_jax_tree`` (named
tensors: parameters, gradients, optimizer moments → the JAX tree layout);
``opt_state_from_jax`` / ``opt_state_to_jax`` carry the AdamW state
(``step``, ``m``, ``v``, ``master``) across the same way, so a run that the
JAX trainer checkpointed can continue in the port and back.

The JAX tree (as numpy arrays, or anything ``np.asarray`` takes) is
``{"embed", "units": {"<j>_<kind>": {leaf: (n_units, …)}}, "tail":
{"<j>_<kind>": {leaf: …}}, "final_norm", "head"}``: one entry per position
``j`` of the config's pattern unit (``0_mamba`` or ``0_mamba2`` alone for
a Mamba stack, whose units are its layers), ``jax.vmap`` over the unit
init giving every unit leaf a leading unit axis, and ``tail`` (present
when ``n_layers`` is no multiple of the unit) holding the layers past the
last whole unit, which reuse the unit's prefix. The port keeps one
``ParameterDict`` per layer: layer ``u·len(unit) + j`` is entry ``u`` of
``units["<j>_<kind>"]``, and tail layer ``n_units·len(unit) + t`` is
``tail["<t>_<kind>"]``, each as ``layers.<i>.<leaf>``; a hybrid or dense
layer's MLP, the JAX sub-block ``"<j>_ffn"`` beside ``"<j>_rec"`` or
``"<j>_attn"``, is ``ffns.<i>.<leaf>``. A dense stack's unit is one
layer (``units["0_attn"]`` and ``units["0_ffn"]`` stacked over
``n_layers``, no ``tail``). A tied embedding has no ``head`` on either
side. Leaf layouts are unchanged: both packages store dense
weights (din, dout) and apply them as ``x @ W``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import unit_layout
from repro_torch.optim.adamw import AdamWState


def _layout(cfg: ArchConfig):
    """(n_units, n_tail, the unit's sub-blocks as (JAX key ``<j>_<kind>``,
    unit position j, the port's module ``layers`` or ``ffns``))."""
    U = len(cfg.unit)
    subs = [(name, int(name.split("_")[0]),
             "ffns" if kind == "mlp" else "layers")
            for name, kind in unit_layout(cfg)]
    return cfg.n_layers // U, cfg.n_layers % U, subs


def _top(cfg: ArchConfig):
    return ("embed", "final_norm") + (() if cfg.tie_embeddings
                                      else ("head",))


def params_from_jax(tree, cfg: ArchConfig, device) -> Dict[str, torch.Tensor]:
    """Returns a state dict for ``LM(cfg, device).load_state_dict``."""
    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    n_units, n_tail, subs = _layout(cfg)
    U = len(cfg.unit)
    out = {k: t(tree[k]) for k in _top(cfg)}
    for name, j, mod in (subs if n_units else ()):
        for k, v in tree["units"][name].items():
            v = np.asarray(v)
            if v.shape[0] != n_units:
                raise ValueError(f"units leaf {name}.{k} has {v.shape[0]} "
                                 f"units, config {cfg.name} has {n_units}")
            for u in range(n_units):
                out[f"{mod}.{u * U + j}.{k}"] = t(v[u])
    for name, j, mod in subs:
        if j < n_tail:
            for k, v in tree["tail"][name].items():
                out[f"{mod}.{n_units * U + j}.{k}"] = t(v)
    return out


def to_jax_tree(named: Dict[str, torch.Tensor], cfg: ArchConfig):
    """The inverse map: ``{"embed", "units": {"<j>_<kind>": {leaf:
    (n_units, …)}}, ["tail": {"<j>_<kind>": {leaf: …}},] "final_norm",
    ["head"]}`` of f32 numpy arrays, the unit axis stacked back. Takes any
    dict keyed like ``LM.named_parameters()`` (e.g. the gradients of a
    train step)."""
    def a(t):
        return t.detach().float().cpu().numpy()

    def leaves(mod, i):
        pre = f"{mod}.{i}."
        return sorted(k[len(pre):] for k in named if k.startswith(pre))

    n_units, n_tail, subs = _layout(cfg)
    U = len(cfg.unit)
    out = {k: a(named[k]) for k in _top(cfg)}
    if n_units:
        out["units"] = {name: {leaf: np.stack(
            [a(named[f"{mod}.{u * U + j}.{leaf}"]) for u in range(n_units)])
            for leaf in leaves(mod, j)} for name, j, mod in subs}
    if n_tail:
        out["tail"] = {name: {leaf: a(named[f"{mod}.{n_units * U + j}."
                                            f"{leaf}"])
                              for leaf in leaves(mod, n_units * U + j)}
                       for name, j, mod in subs if j < n_tail}
    return out


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
