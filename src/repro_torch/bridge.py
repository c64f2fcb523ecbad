"""numpy <-> port state, for holding the port against the JAX package.

``from_numpy`` builds the port's containers (``SliceParams``,
``SchedulerState``, ``NetworkState``, ``Multipliers``, ...) from nested
dicts of numpy arrays keyed by the JAX package's field names; the container
type is recognised by its set of fields. Two fields differ from the JAX
``SchedulerState``:

  * ``het`` replaces ``het_key``: a dict of the four heterogeneity arrays
    (``link_het``, ``ec_het``, ``phase_d``, ``phase_D``), for example
    computed on the JAX side with ``repro.core.network.heterogeneity``;
  * ``rng`` may be an int seed, a uint32 array of JAX key words (the last
    axis holds a key's 32-bit words, most significant first, which make the
    port's run seed, cut to 63 bits) or an array of seeds of another
    integer type (as ``to_numpy`` returns them).

Stacked containers (a fleet's, with a leading K axis on every leaf)
convert the same way: a (K, 2) array of JAX keys gives K run seeds, and
``het`` takes K stacked sets of the four heterogeneity arrays.

``to_numpy`` is the inverse (seeds come back as an int64 array).

``lm_params_from_numpy`` builds a port language model from the JAX
package's parameter tree (``model.init(key)`` as numpy);
``adamw_state_from_numpy`` builds the port's ``AdamWState`` from the JAX
package's (step, m, v with m and v nested like the parameters), by the
same name map, and ``adamw_state_to_numpy`` is its inverse.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.types import (Decision, Heterogeneity, Multipliers, NetworkState,
                         QueueState, SchedulerState, SliceParams, seed_tensor)

_TYPES = (SchedulerState, SliceParams, NetworkState, Multipliers, QueueState,
          Decision, Heterogeneity)
_OPTIONAL = {SliceParams: set(SliceParams._field_defaults)}
_INT_FIELDS = {"t", "collect_id", "train_id"}


def _match_type(keys: set[str]):
    for cls in _TYPES:
        fields = set(cls._fields)
        if keys <= fields and fields - keys <= _OPTIONAL.get(cls, set()):
            return cls
    raise KeyError(f"no port container has the fields {sorted(keys)}")


def _seeds_of(rng: Any) -> int | list[int]:
    """The run seed of one slice (an int), or one per slice (a list)."""
    if isinstance(rng, (int, np.integer)):
        return int(rng)
    rng = np.asarray(rng)
    if rng.dtype != np.uint32:
        return rng.astype(np.int64).tolist()

    def fold(words) -> int:
        seed = 0
        for w in words:
            seed = ((seed << 32) ^ int(w)) & 0x7FFF_FFFF_FFFF_FFFF
        return seed

    if rng.ndim <= 1:
        return fold(rng.ravel())
    return [fold(key) for key in rng.reshape(-1, rng.shape[-1])]


def _tensor(name: str, value: Any, device: torch.device) -> torch.Tensor:
    dtype = torch.int32 if name in _INT_FIELDS else torch.float32
    return torch.as_tensor(np.array(value), device=device).to(dtype)  # a writable copy


def from_numpy(tree: Mapping[str, Any], device: str | torch.device):
    """Port container for a nested dict of numpy arrays (see module doc)."""
    device = torch.device(device)
    cls = _match_type(set(tree))
    kw = {}
    for name, value in tree.items():
        if value is None:
            kw[name] = None
        elif name == "rng":
            kw[name] = seed_tensor(_seeds_of(value), device)
        elif isinstance(value, Mapping):
            kw[name] = from_numpy(value, device)
        else:
            kw[name] = _tensor(name, value, device)
    return cls(**kw)


def _flat_names(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat_names(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def lm_params_from_numpy(cfg, tree: Mapping[str, Any], device: str | torch.device,
                         dtype: torch.dtype | None = None):
    """The port's model of ``cfg`` holding the parameters of a JAX parameter
    tree (nested dicts of numpy arrays: ``embed``, ``blocks`` with stacked
    (L, ...) leaves, ``final_norm``, ``head``), copied name for name. Raises
    if a name is missing on either side or a shape differs."""
    from .models import new_model  # the scheduler's users need no model code

    model = new_model(cfg, torch.device(device), dtype)
    given = _flat_names(tree)
    params = dict(model.named_parameters())
    if set(given) != set(params):
        raise KeyError(f"parameter names differ: only in the JAX tree "
                       f"{sorted(set(given) - set(params))}, only in the port "
                       f"{sorted(set(params) - set(given))}")
    with torch.no_grad():
        for name, p in params.items():
            value = np.asarray(given[name])
            if value.shape != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {value.shape}, port shape {tuple(p.shape)}")
            p.copy_(torch.as_tensor(value.astype(np.float32)))
    return model


def adamw_state_from_numpy(model, state: Any, device: str | torch.device):
    """The port's ``AdamWState`` for the parameters of ``model`` from a JAX
    ``AdamWState`` of numpy arrays (or a dict with ``step``, ``m``, ``v``);
    m and v are nested like the JAX parameter tree and land under the
    port's parameter names. Raises if a name is missing on either side or a
    shape differs."""
    from .optim import AdamWState  # the scheduler's users need no optimizer code

    get = state.get if isinstance(state, Mapping) else lambda k: getattr(state, k)
    params = dict(model.named_parameters())
    moments = {}
    for key in ("m", "v"):
        given = _flat_names(get(key))
        if set(given) != set(params):
            raise KeyError(f"{key}: names differ: only in the JAX state "
                           f"{sorted(set(given) - set(params))}, only in the port "
                           f"{sorted(set(params) - set(given))}")
        moments[key] = {}
        for name, p in params.items():
            value = np.asarray(given[name], np.float32)
            if value.shape != tuple(p.shape):
                raise ValueError(f"{key}.{name}: JAX shape {value.shape}, port shape "
                                 f"{tuple(p.shape)}")
            moments[key][name] = torch.as_tensor(value.copy(), device=device)
    step = torch.as_tensor(np.asarray(get("step")).astype(np.int32), device=device)
    return AdamWState(step=step, m=moments["m"], v=moments["v"])


def adamw_state_to_numpy(state) -> dict:
    """{"step", "m", "v"} of numpy arrays, m and v nested like the JAX
    parameter tree (the inverse of ``adamw_state_from_numpy``)."""
    def nest(flat: Mapping[str, torch.Tensor]) -> dict:
        out: dict = {}
        for name, t in flat.items():
            *path, leaf = name.split(".")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = t.detach().cpu().numpy()
        return out

    return {"step": state.step.detach().cpu().numpy(), "m": nest(state.m), "v": nest(state.v)}


def to_numpy(obj: Any):
    """Nested dict of numpy arrays for a port container (the inverse of
    ``from_numpy``)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {f: to_numpy(getattr(obj, f)) for f in obj._fields}
    if obj is None:
        return None
    raise TypeError(f"cannot convert {type(obj).__name__} to numpy")
