"""Shared parts of the hybrid family's LM, training and serving files
(``tests/test_torch_hybrid_*.py``): the port's and the JAX package's
recurrentgemma-2b.reduced() at a given depth with the attention window at
8 (the reduced config keeps 2048, which never binds at test lengths), the
weights carried from the port's ``init`` into the JAX tree, and a JAX
cache or harvest in the port's flat layout and back. Not a test module
(no ``test_`` prefix)."""
import dataclasses

import torch

from repro.configs.base import get_config as jget_config
from repro_torch.configs.base import get_config
from repro_torch.interop import to_jax_tree

WINDOW = 8
# recurrentgemma-2b.reduced() (two whole units) and two units plus its 2
# tail layers (26 = 8 × 3 + 2 at full size)
LAYERS = {"units": 6, "units_plus_tail": 8}


def configs(n_layers, **kw):
    """The port's and the JAX package's configs at ``n_layers``."""
    kw = dict(n_layers=n_layers, attn_window=WINDOW, **kw)
    return (dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                                **kw),
            dataclasses.replace(jget_config("recurrentgemma-2b").reduced(),
                                **kw))


def port_model(cfg, seed):
    from repro_torch.models.lm import LM
    return LM(cfg, "cpu").init(torch.Generator().manual_seed(seed))


def jax_params(model, cfg):
    """The port model's weights as a JAX tree (copies)."""
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.array, to_jax_tree(
        {k: p.detach() for k, p in model.named_parameters()}, cfg))


def flat(tree):
    """A JAX cache or packed harvest ({"units": {name: {leaf: (n_units,
    …)}}, "tail": {name: {leaf: …}}}) in the port's flat layout,
    ``name.leaf`` with the units' and the tail's layers stacked."""
    import numpy as np
    out = {}
    for name, leaves in tree.get("units", {}).items():
        for k, v in leaves.items():
            out[f"{name}.{k}"] = np.asarray(v)
    for name, leaves in tree.get("tail", {}).items():
        for k, v in leaves.items():
            key, v = f"{name}.{k}", np.asarray(v)[None]
            out[key] = np.concatenate([out[key], v]) if key in out else v
    return out


def tree(cache, cfg):
    """The inverse of ``flat`` for a decode cache: the port's flat cache as
    a JAX ``init_cache`` tree (copies: the port updates its cache in
    place)."""
    import jax.numpy as jnp
    n_units = cfg.n_layers // len(cfg.unit)
    out = {"units": {}}
    if cfg.n_layers % len(cfg.unit):
        out["tail"] = {}
    for key, v in cache.items():
        name, leaf = key.split(".")
        v = v.detach().numpy()
        out["units"].setdefault(name, {})[leaf] = jnp.array(v[:n_units])
        if "tail" in out and len(v) > n_units:
            out["tail"].setdefault(name, {})[leaf] = jnp.array(v[n_units])
    return out
