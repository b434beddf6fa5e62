"""Typed config tree with CLI override (stdlib copy of
``fedml_tpu/core/config.py``).

The reference configures every experiment through per-main argparse
blocks (~20 flags each, canonical set at
``fedml_experiments/distributed/fedavg/main_fedavg.py:46-105``) plus
positional shell wrappers.  Here one dataclass is the single source of
truth: ``cli_parser`` derives an argparse parser from any dataclass's
fields (names, types, defaults, docstrings), so every experiment main is
``cfg = parse_config(ExperimentConfig, argv)`` and the run record is
``asdict(cfg)`` — serialized, diffable, reproducible (SURVEY.md §5.6).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from typing import Any, Optional, Sequence, Type, TypeVar, get_args, get_origin

T = TypeVar("T")


def _field_types(cls) -> dict:
    """Resolved annotations (PEP 563 postpones them to strings)."""
    try:
        return typing.get_type_hints(cls)
    except Exception:
        return {f.name: f.type for f in dataclasses.fields(cls)}


def _arg_type(ftype):
    origin = get_origin(ftype)
    if origin is not None:  # Optional[X] / Union
        args = [a for a in get_args(ftype) if a is not type(None)]
        if len(args) == 1:
            return _arg_type(args[0])
        return str
    if ftype is bool:
        return None  # handled as flag pair
    return ftype


def cli_parser(
    cls: Type, parser: Optional[argparse.ArgumentParser] = None,
    prefix: str = "",
) -> argparse.ArgumentParser:
    """Build (or extend) an argparse parser from a dataclass.

    Nested dataclass fields become dotted flags (``--server.lr``).
    Booleans get ``--flag`` / ``--no-flag`` pairs.
    """
    parser = parser or argparse.ArgumentParser(
        description=(cls.__doc__ or "").strip().splitlines()[0]
        if cls.__doc__ else None
    )
    hints = _field_types(cls)
    for f in dataclasses.fields(cls):
        name = f"{prefix}{f.name}"
        ftype = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(ftype if isinstance(ftype, type) else None):
            cli_parser(ftype, parser, prefix=f"{name}.")
            continue
        default = (
            f.default
            if f.default is not dataclasses.MISSING
            else (f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
        )
        if dataclasses.is_dataclass(type(default)):
            cli_parser(type(default), parser, prefix=f"{name}.")
            continue
        atype = _arg_type(ftype) if isinstance(ftype, type) or get_origin(ftype) else str
        if ftype is bool or atype is None and isinstance(default, bool):
            group = parser.add_mutually_exclusive_group()
            group.add_argument(f"--{name}", dest=name, action="store_true",
                               default=default)
            group.add_argument(f"--no-{name}", dest=name, action="store_false")
        else:
            if not callable(atype):
                atype = str
            parser.add_argument(f"--{name}", type=atype, default=default)
    return parser


def parse_config(cls: Type[T], argv: Optional[Sequence[str]] = None) -> T:
    """Parse argv into an instance of the dataclass ``cls``."""
    ns = vars(cli_parser(cls).parse_args(argv))

    def build(c, prefix=""):
        kwargs = {}
        hints = _field_types(c)
        for f in dataclasses.fields(c):
            name = f"{prefix}{f.name}"
            hint = hints.get(f.name, f.type)
            ft = hint if isinstance(hint, type) else None
            default = (
                f.default if f.default is not dataclasses.MISSING
                else (f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
            )
            if dataclasses.is_dataclass(ft):
                kwargs[f.name] = build(ft, prefix=f"{name}.")
            elif dataclasses.is_dataclass(type(default)):
                kwargs[f.name] = build(type(default), prefix=f"{name}.")
            else:
                kwargs[f.name] = ns.get(name, default)
        return c(**kwargs)

    return build(cls)


def config_to_json(cfg: Any) -> str:
    """Serialize any (nested) dataclass config to one JSON line — the
    run record."""
    return json.dumps(dataclasses.asdict(cfg), default=str, sort_keys=True)
