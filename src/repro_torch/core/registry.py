"""Decorator-based placement-strategy registry with typed configs.

The port's copy of ``repro.core.registry`` (its own registry: the port
never imports the reference package).

Every strategy class registers itself under a canonical name (plus
aliases)
together with a frozen *config dataclass* describing exactly the keyword
arguments it accepts. Construction goes through :func:`create_strategy`,
which

* resolves aliases (``"adaptive"`` -> ``"pso-adaptive"`` etc.),
* validates overrides against the config's fields — unknown kwargs are a
  hard ``TypeError`` naming the accepted fields (the historical factory
  silently dropped them),
* injects the contextual dependencies a strategy declares
  (``needs_clients`` for the telemetry-reading greedy baseline,
  ``needs_cost_model`` for the exhaustive oracle).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple


@dataclass(frozen=True)
class StrategyInfo:
    """One registry entry: the class, its typed config, and its context
    requirements."""
    name: str
    cls: type
    config_cls: type
    aliases: Tuple[str, ...] = ()
    needs_clients: bool = False
    needs_cost_model: bool = False
    description: str = ""

    @property
    def config_fields(self) -> Tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(self.config_cls))


_REGISTRY: Dict[str, StrategyInfo] = {}
_ALIASES: Dict[str, str] = {}


def register_strategy(name: str, *, config: type, aliases: Iterable[str] = (),
                      needs_clients: bool = False,
                      needs_cost_model: bool = False,
                      description: str = ""):
    """Class decorator: register a ``PlacementStrategy`` under ``name``."""
    if not dataclasses.is_dataclass(config):
        raise TypeError(f"config for {name!r} must be a dataclass, "
                        f"got {config!r}")

    def deco(cls: type) -> type:
        info = StrategyInfo(
            name=name, cls=cls, config_cls=config,
            aliases=tuple(a.lower() for a in aliases),
            needs_clients=needs_clients, needs_cost_model=needs_cost_model,
            description=description or (cls.__doc__ or "").split("\n")[0])
        key = name.lower()
        if key in _REGISTRY:
            raise ValueError(f"strategy {name!r} registered twice")
        if key in _ALIASES:
            raise ValueError(f"strategy name {name!r} already taken as an "
                             f"alias of {_ALIASES[key]!r}")
        _REGISTRY[key] = info
        for a in info.aliases:
            if a in _REGISTRY or a in _ALIASES:
                raise ValueError(f"strategy alias {a!r} already taken")
            _ALIASES[a] = key
        cls.registry_info = info
        return cls

    return deco


def resolve_strategy(name: str) -> StrategyInfo:
    key = name.lower()
    key = _ALIASES.get(key, key)
    info = _REGISTRY.get(key)
    if info is None:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown placement strategy {name!r}; "
                       f"registered: {known}")
    return info


def list_strategies() -> Tuple[StrategyInfo, ...]:
    """Registered strategies, canonical order (registration order)."""
    return tuple(_REGISTRY.values())


def strategy_names(include_aliases: bool = False) -> Tuple[str, ...]:
    names = tuple(_REGISTRY)
    return names + tuple(_ALIASES) if include_aliases else names


def build_config(name: str, overrides: Optional[Dict[str, Any]] = None):
    """Typed config for strategy ``name`` with ``overrides`` applied.

    Unknown keys raise ``TypeError`` naming the accepted fields.
    """
    info = resolve_strategy(name)
    overrides = dict(overrides or {})
    accepted = info.config_fields
    unknown = sorted(set(overrides) - set(accepted))
    if unknown:
        accepted_s = ", ".join(accepted) if accepted else "(none)"
        raise TypeError(
            f"strategy {info.name!r} got unexpected config field(s) "
            f"{unknown}; accepted fields: {accepted_s}")
    return info.config_cls(**overrides)


def create_strategy(name: str, hierarchy, *, seed: int = 0, clients=None,
                    cost_model=None, config=None, **overrides):
    """Instantiate a registered strategy.

    ``clients`` / ``cost_model`` are *context* (injected only into the
    strategies that declare they need them); everything else must be a
    field of the strategy's config dataclass — pass either a ready
    ``config`` instance or keyword ``overrides``, not both.
    """
    info = resolve_strategy(name)
    if config is not None:
        if overrides:
            raise TypeError("pass either a config instance or keyword "
                            "overrides, not both")
        if not isinstance(config, info.config_cls):
            raise TypeError(
                f"strategy {info.name!r} expects a {info.config_cls.__name__}"
                f" config, got {type(config).__name__}")
    else:
        config = build_config(info.name, overrides)

    kwargs = {f.name: getattr(config, f.name)
              for f in dataclasses.fields(config)}
    if info.needs_clients:
        if clients is None:
            raise ValueError(f"strategy {info.name!r} needs the client pool "
                             f"(pass clients=...)")
        kwargs["clients"] = clients
    if info.needs_cost_model:
        if cost_model is None:
            raise ValueError(f"strategy {info.name!r} needs a cost model "
                             f"(pass cost_model=...)")
        kwargs["cost_model"] = cost_model
    return info.cls(hierarchy, seed=seed, **kwargs)
