"""Hydra-style YAML config composition over ``conf/``.

The port's copy of ``rlvae_tpu/config/compose.py``, with the same
behaviour on the same files:

- a root config with a ``defaults`` list selecting options from config
  groups (``- model: riemannian_flow_vae`` loads
  ``conf/model/riemannian_flow_vae.yaml``), group configs with defaults of
  their own (inheritance), and ``_self_``;
- ``# @package <path>`` directives (``_global_`` or a dotted path; a group
  config without one lands under its group's name);
- overrides: group selection (``model=vanilla_vae``), dotted values
  (``model.latent_dim=32``), additions (``+key=val``) and deletions
  (``~key``), applied in order after composition;
- ``${dotted.path}`` interpolation and ``${now:%fmt}`` timestamps;
- multirun: comma-separated values expand to a cartesian product
  (:func:`expand_multirun`).

PyYAML reads and writes the files.  It is imported inside the functions
that parse or dump YAML, never when this module is imported, so every
value keeps PyYAML's YAML 1.1 reading: ``1e-6`` without a dot is the
string ``'1e-6'`` (``conf/model/*.yaml`` ``epsilon``,
``conf/training/*.yaml`` ``min_lr``), and only override values and sweep
axes are coerced to floats (:func:`coerce_scalar`).
"""

from __future__ import annotations

import copy
import datetime
import itertools
import re
from pathlib import Path
from typing import Any, Iterator, List, Optional, Sequence, Tuple


class Config(dict):
    """Nested dict with attribute access and dotted ``get``/``set``."""

    def __init__(self, data: Optional[dict] = None):
        super().__init__()
        for k, v in (data or {}).items():
            self[k] = _wrap(v)

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value):
        self[name] = _wrap(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    def get(self, key, default=None):
        cur: Any = self
        for part in str(key).split("."):
            if isinstance(cur, dict) and part in cur:
                cur = cur[part]
            else:
                return default
        return cur

    def set(self, dotted_key: str, value):
        parts = dotted_key.split(".")
        cur = self
        for p in parts[:-1]:
            if p not in cur or not isinstance(cur[p], Config):
                cur[p] = Config()
            cur = cur[p]
        cur[parts[-1]] = _wrap(value)

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()}

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))


def _wrap(value):
    if isinstance(value, Config):
        return value
    if isinstance(value, dict):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _deep_merge(base: Config, other: dict) -> Config:
    """Merge ``other`` into ``base`` in place (other wins; dicts merge recursively)."""
    for k, v in other.items():
        if k in base and isinstance(base[k], Config) and isinstance(v, dict):
            _deep_merge(base[k], v)
        else:
            base[k] = _wrap(copy.deepcopy(v) if isinstance(v, (dict, list)) else v)
    return base


_PACKAGE_RE = re.compile(r"^#\s*@package\s+(\S+)\s*$", re.MULTILINE)


def load_yaml(text: str):
    """``yaml.safe_load`` of ``text``."""
    import yaml

    return yaml.safe_load(text)


def dump_yaml(data, **kwargs) -> str:
    """``yaml.safe_dump`` of ``data``."""
    import yaml

    return yaml.safe_dump(data, **kwargs)


def _load_yaml(path: Path) -> Tuple[dict, Optional[str]]:
    """Load a YAML file, returning (data, package_directive)."""
    text = path.read_text()
    m = _PACKAGE_RE.search(text)
    package = m.group(1) if m else None
    data = load_yaml(text) or {}
    if not isinstance(data, dict):
        raise ValueError(f"Config file {path} must contain a mapping, got {type(data)}")
    return data, package


def _place_at_package(data: dict, package: Optional[str], group: Optional[str]) -> dict:
    """Nest ``data`` under its package path: ``_global_`` (or no directive
    for the root config) merges at the root, a group config without a
    directive lands under its group's name."""
    if package in (None, "_group_"):
        package = group
    if package in (None, "_global_"):
        return data
    out: dict = {}
    cur = out
    parts = package.split(".")
    for p in parts[:-1]:
        cur[p] = {}
        cur = cur[p]
    cur[parts[-1]] = data
    return out


class OverrideSpec:
    """A parsed override: ``key=value``, ``+key=value`` or ``~key``, with
    comma-separated values for a sweep."""

    def __init__(self, raw: str):
        self.raw = raw
        self.delete = raw.startswith("~")
        self.add = raw.startswith("+")
        body = raw.lstrip("+~")
        if "=" in body:
            self.key, raw_val = body.split("=", 1)
            self.values = [_parse_value(v) for v in _split_csv(raw_val)]
        elif self.delete:
            self.key, self.values = body, [None]
        else:
            raise ValueError(
                f"Malformed override '{raw}': expected key=value, +key=value, or ~key"
            )

    @property
    def is_sweep(self) -> bool:
        return len(self.values) > 1


def _split_csv(raw: str) -> List[str]:
    """Split on commas not inside brackets (so list values survive)."""
    parts, depth, cur = [], 0, []
    for ch in raw:
        if ch in "[{(":
            depth += 1
        elif ch in ")}]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


_SCI_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def coerce_scalar(value):
    """YAML 1.1 reads bare scientific notation such as ``3e-4`` as a string
    (it needs ``3.0e-4``); turn such strings into floats."""
    if isinstance(value, str) and _SCI_RE.match(value.strip()):
        return float(value)
    return value


def _parse_value(raw: str):
    import yaml

    raw = raw.strip()
    if raw == "null":
        return None
    try:
        return coerce_scalar(yaml.safe_load(raw))
    except yaml.YAMLError:
        return raw


_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def _resolve_interpolations(cfg: Config, max_passes: int = 8) -> None:
    """Resolve ``${a.b}`` and ``${now:%fmt}`` strings in place."""
    now = datetime.datetime.now()

    def resolve_str(s: str):
        def sub(m: "re.Match[str]"):
            expr = m.group(1)
            if expr.startswith("now:"):
                return now.strftime(expr[4:])
            val = cfg.get(expr)
            if val is None and cfg.get(expr, "\0") == "\0":
                return m.group(0)  # unresolved; leave literal
            return str(val)

        full = _INTERP_RE.fullmatch(s)
        if full and not full.group(1).startswith("now:"):
            val = cfg.get(full.group(1), "\0")
            if val != "\0":
                return val  # a whole-string reference keeps the value's type
        return _INTERP_RE.sub(sub, s)

    def walk(node):
        changed = False
        items = list(node.items()) if isinstance(node, Config) else list(enumerate(node))
        for k, v in items:
            if isinstance(v, str) and "${" in v:
                nv = resolve_str(v)
                if nv != v:
                    node[k] = nv
                    changed = True
            elif isinstance(v, (Config, list)):
                changed |= walk(v)
        return changed

    for _ in range(max_passes):
        if not walk(cfg):
            break


def _compose_impl(config_dir: Path, config_name: str, specs: List[OverrideSpec]) -> Config:
    root_data, root_pkg = _load_yaml(config_dir / f"{config_name}.yaml")
    defaults = root_data.pop("defaults", [])

    group_selects = {
        s.key: s.values[0]
        for s in specs
        if not s.delete and "=" in s.raw and "." not in s.key and (config_dir / s.key).is_dir()
    }
    consumed = set(group_selects)

    cfg = Config()
    self_merged = False

    def merge_self():
        nonlocal self_merged
        _deep_merge(cfg, _place_at_package(root_data, root_pkg, None))
        self_merged = True

    def merge_group_option(group: Optional[str], option: str) -> None:
        """Load a group option with its own defaults list; a bare entry
        there names a sibling file of the same group."""
        path = (config_dir / group / f"{option}.yaml") if group else (config_dir / f"{option}.yaml")
        data, pkg = _load_yaml(path)
        sub_defaults = data.pop("defaults", [])
        merged_self = False
        for sub in sub_defaults:
            if sub == "_self_":
                _deep_merge(cfg, _place_at_package(data, pkg, group))
                merged_self = True
            elif isinstance(sub, dict):
                (g, opt), = sub.items()
                merge_group_option(g, opt)
            else:
                merge_group_option(group, sub)
        if not merged_self:
            _deep_merge(cfg, _place_at_package(data, pkg, group))

    visited_groups = set()
    for entry in defaults:
        if entry == "_self_":
            merge_self()
            continue
        if isinstance(entry, dict):
            (group, option), = entry.items()
        else:
            group, option = None, entry
        if group is not None:
            visited_groups.add(group)
            option = group_selects.get(group, option)
            if option is None:
                continue
        merge_group_option(group, option)

    # a selection of a group the root defaults do not name merges after them
    for group, option in group_selects.items():
        if group not in visited_groups and option is not None:
            merge_group_option(group, option)

    if not self_merged:
        merge_self()

    for group, option in group_selects.items():
        cfg.set(f"_groups_.{group}", option)

    for s in specs:
        if s.key in consumed:
            continue
        if s.delete:
            _delete_key(cfg, s.key)
        else:
            cfg.set(s.key, s.values[0])

    _resolve_interpolations(cfg)
    return cfg


def _delete_key(cfg: Config, dotted: str) -> None:
    parts = dotted.split(".")
    cur: Any = cfg
    for p in parts[:-1]:
        if not isinstance(cur, dict) or p not in cur:
            return
        cur = cur[p]
    if isinstance(cur, dict):
        cur.pop(parts[-1], None)


def expand_multirun(overrides: Sequence[str]) -> Iterator[List[str]]:
    """Expand comma-valued overrides into the cartesian product of runs."""
    specs = [OverrideSpec(o) for o in overrides]
    axes: List[List[str]] = []
    for s in specs:
        prefix = "~" if s.delete else ("+" if s.add else "")
        axes.append([f"{prefix}{s.key}={_to_cli(v)}" if "=" in s.raw else s.raw for v in s.values])
    for combo in itertools.product(*axes):
        yield list(combo)


def _to_cli(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, (list, dict)):
        return dump_yaml(value, default_flow_style=True).strip()
    return str(value)


def save_config(cfg: Config, path: str | Path) -> None:
    """Write ``cfg`` as YAML (``yaml.safe_dump``, keys in their order)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(dump_yaml(cfg.to_dict(), sort_keys=False))


def compose(config_dir: str | Path, config_name: str = "config",
            overrides: Optional[Sequence[str]] = None) -> Config:
    """Compose a config from a Hydra-style config directory.

    Group selections in ``overrides`` (``model=vanilla_vae``) replace
    defaults; dotted value overrides apply after composition in the order
    given.  An override with several values raises: use
    :func:`expand_multirun`."""
    config_dir = Path(config_dir)
    specs = [OverrideSpec(o) for o in (overrides or [])]
    for s in specs:
        if s.is_sweep:
            raise ValueError(
                f"Override '{s.raw}' has multiple values; use expand_multirun() for sweeps"
            )
    return _compose_impl(config_dir, config_name, specs)
