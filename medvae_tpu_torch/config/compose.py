"""Hydra-compatible config composition (the port's copy of
medvae_tpu/config/compose.py, which imports no JAX; the port keeps its own).

The reference drives every entry point through Hydra config groups (its
main.py:17, configs/ — groups model/, data/, training/, experiment/). This module reimplements the subset of Hydra semantics that surface
uses, so the exact same YAML tree and the exact same CLI override syntax keep
working:

  * a root ``config.yaml`` with a ``defaults`` list (``- model: base_vae``,
    ``- _self_``)
  * group config files, optionally tagged ``# @package _global_``
  * per-file ``defaults`` (relative names resolve within the same group,
    ``override /group: name`` rewrites a root default — used by experiment files)
  * CLI overrides: ``experiment=foo`` (group select), ``a.b.c=value``
    (dot-path set), ``+a.b=value`` (add new key)
  * interpolation: ``${path.to.key}`` and ``${oc.env:VAR}``

PyYAML is imported here and nowhere else in the port: `save_yaml` writes the
run artifacts (the composed config, overrides, hparams) for the others.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Iterable, Optional

import yaml


class ConfigDict(dict):
    """dict with attribute access; nested dicts are ConfigDicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get_path(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node: Any = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = ConfigDict()
            node = node[part]
        node[parts[-1]] = value

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, ConfigDict) else v for k, v in self.items()
        }


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


class _ConfigLoader(yaml.SafeLoader):
    """SafeLoader + YAML 1.2 float forms.

    pyyaml implements YAML 1.1, whose float grammar requires a decimal point
    in exponent notation — so `lr: 1e-4` loads as the *string* "1e-4".
    OmegaConf (the reference's loader) reads a float. An implicit resolver
    fixes exactly the unquoted-plain-scalar case: quoted values ("1e5" as an
    experiment tag) still load as strings, matching OmegaConf's rules.
    """


_ConfigLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$"),
    list("-+0123456789."),
)


def load_yaml(path: str | Path) -> ConfigDict:
    with open(path) as f:
        data = yaml.load(f, Loader=_ConfigLoader) or {}
    return _wrap(data)


def merge(base: ConfigDict, overlay: dict) -> ConfigDict:
    """Deep merge: overlay wins; dicts merge recursively, everything else replaces."""
    out = ConfigDict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge(ConfigDict(out[k]), v)
        else:
            out[k] = _wrap(v)
    return out


def _is_global_package(path: Path) -> bool:
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s == "---":
                continue
            if s.startswith("#"):
                if "@package" in s and "_global_" in s:
                    return True
                continue
            return False
    return False


def _parse_value(raw: str) -> Any:
    """Parse a CLI override value using YAML scalar rules (via _ConfigLoader,
    so ``training.lr=1e-3`` is the float OmegaConf would produce while an
    explicitly quoted ``tag='"1e5"'`` stays a string)."""
    try:
        return yaml.load(raw, Loader=_ConfigLoader)
    except yaml.YAMLError:
        return raw


_GROUP_RE = re.compile(r"^[A-Za-z_][\w/]*$")


def parse_overrides(overrides: Iterable[str]):
    """Split CLI overrides into (group selects, dot-path sets)."""
    groups: dict[str, Optional[str]] = {}
    sets: list[tuple[str, Any]] = []
    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        additive = ov.startswith("+")
        if additive:
            ov = ov[1:]
        if "=" not in ov:
            raise ValueError(f"Malformed override (expected key=value): {ov!r}")
        key, raw = ov.split("=", 1)
        key = key.strip()
        # group select: bare group name (no dot) matching a config-group dir is
        # resolved later by compose(); record both interpretations.
        if "." not in key and _GROUP_RE.match(key):
            groups[key] = raw.strip()
        else:
            sets.append((key, _parse_value(raw)))
    return groups, sets


class _Composer:
    def __init__(self, config_dir: Path):
        self.config_dir = Path(config_dir)

    def group_file(self, group: str, name: str) -> Path:
        return self.config_dir / group / f"{name}.yaml"

    def has_group(self, group: str, name: str) -> bool:
        return self.group_file(group, name).exists()

    def load_group(
        self, group: str, name: str, cfg: ConfigDict, seen: set
    ) -> ConfigDict:
        """Load one group config (with its own defaults) and merge into cfg."""
        path = self.group_file(group, name)
        key = (group, name)
        if key in seen:
            return cfg
        seen.add(key)
        if not path.exists():
            raise FileNotFoundError(f"Config group file not found: {path}")
        body = load_yaml(path)
        is_global = _is_global_package(path)
        defaults = body.pop("defaults", [])

        # Per-file defaults first (they are the base this file overrides).
        for entry in defaults:
            if entry == "_self_":
                continue
            if isinstance(entry, str):
                # bare name → same group
                cfg = self.load_group(group, entry, cfg, seen)
            elif isinstance(entry, dict):
                for g, n in entry.items():
                    g = g.strip()
                    if g.startswith("override "):
                        g = g[len("override ") :].strip()
                    g = g.lstrip("/")
                    cfg = self.load_group(g, n, cfg, seen)

        if is_global:
            cfg = merge(cfg, body)
        else:
            cfg = merge(cfg, ConfigDict({group: body}))
        return cfg

    def compose(
        self, config_name: str, overrides: Iterable[str] = ()
    ) -> ConfigDict:
        group_sel, sets = parse_overrides(overrides)

        root_path = self.config_dir / f"{config_name}.yaml"
        root = load_yaml(root_path)
        defaults = list(root.pop("defaults", []))

        # Resolve the root defaults list into ordered (group, name) pairs,
        # applying experiment-level `override /group:` rewrites and CLI group
        # selections.
        plan: list[tuple[str, str]] = []
        self_pos = len(defaults)
        for i, entry in enumerate(defaults):
            if entry == "_self_":
                self_pos = i
                continue
            if isinstance(entry, dict):
                for g, n in entry.items():
                    plan.append((g.lstrip("/"), n))

        # CLI group selects rewrite the plan (or append a new group, e.g.
        # `experiment=...`). A select whose value isn't a real group file is
        # treated as a plain dot-override instead.
        for g, n in group_sel.items():
            if self.has_group(g, str(n)):
                plan = [(pg, pn) for pg, pn in plan if pg != g]
                plan.append((g, str(n)))
            else:
                if (self.config_dir / g).is_dir():
                    raise FileNotFoundError(
                        f"Unknown option {n!r} for config group {g!r}"
                    )
                sets.append((g, _parse_value(str(n))))

        # Experiment files use `override /group:` in their own defaults, which
        # must rewrite the *root* plan. Pre-scan selected groups for overrides.
        plan = self._apply_group_overrides(plan)

        cfg = ConfigDict()
        seen: set = set()
        # Everything before _self_ merges first, then root body, then the rest.
        pre = [p for idx, p in enumerate(plan) if self._plan_index(defaults, p) < self_pos]
        post = [p for p in plan if p not in pre]
        for g, n in pre:
            cfg = self.load_group(g, n, cfg, seen)
        cfg = merge(cfg, root)
        for g, n in post:
            cfg = self.load_group(g, n, cfg, seen)

        for key, value in sets:
            cfg.set_path(key, value)

        resolve_interpolations(cfg)
        return cfg

    def _plan_index(self, defaults: list, pair: tuple[str, str]) -> int:
        for i, entry in enumerate(defaults):
            if isinstance(entry, dict):
                for g, _ in entry.items():
                    if g.lstrip("/") == pair[0]:
                        return i
        return len(defaults)

    def _apply_group_overrides(
        self, plan: list[tuple[str, str]]
    ) -> list[tuple[str, str]]:
        """Scan planned group files for `override /group: name` defaults and
        rewrite earlier plan entries accordingly (hydra experiment pattern)."""
        result = list(plan)
        for g, n in list(plan):
            path = self.group_file(g, n)
            if not path.exists():
                continue
            body = load_yaml(path)
            for entry in body.get("defaults", []):
                if not isinstance(entry, dict):
                    continue
                for key, name in entry.items():
                    key = key.strip()
                    if key.startswith("override "):
                        target = key[len("override ") :].strip().lstrip("/")
                        result = [
                            (pg, pn) if pg != target else (target, name)
                            for pg, pn in result
                        ]
        return result


_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


def resolve_interpolations(cfg: ConfigDict, max_passes: int = 10) -> None:
    """Resolve ${a.b} / ${oc.env:VAR} in-place (iterated to a fixed point)."""

    def resolve_str(s: str) -> Any:
        full = _INTERP_RE.fullmatch(s.strip())

        def lookup(expr: str) -> Any:
            expr = expr.strip()
            if expr.startswith("oc.env:"):
                var = expr[len("oc.env:") :]
                if "," in var:
                    var, default = var.split(",", 1)
                    return os.environ.get(var.strip(), default.strip())
                return os.environ.get(var, "")
            return cfg.get_path(expr, f"${{{expr}}}")

        if full:  # whole-string interpolation keeps the value's type
            return lookup(full.group(1))
        return _INTERP_RE.sub(lambda m: str(lookup(m.group(1))), s)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            for k in list(node.keys()):
                node[k] = walk(node[k])
            return node
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str) and "${" in node:
            return resolve_str(node)
        return node

    for _ in range(max_passes):
        before = repr(cfg)
        walk(cfg)
        if repr(cfg) == before:
            break


def compose(
    config_dir: str | Path, config_name: str = "config", overrides: Iterable[str] = ()
) -> ConfigDict:
    """Compose a config tree the way `hydra.main` would (see module docstring)."""
    return _Composer(Path(config_dir)).compose(config_name, overrides)


def save_yaml(data: Any, path: str | Path) -> None:
    """Write plain data (a ConfigDict as a dict) to `path` as block YAML."""
    if isinstance(data, ConfigDict):
        data = data.to_dict()
    with open(path, "w") as f:
        yaml.safe_dump(data, f, default_flow_style=False)
