"""Dataclass-tree → CLI flags (the reference's tyro-style config-as-flags).

A copy of ``gaussctrl_exp_tpu/utils/cliconf.py``. The reference exposes
every config field as a dotted flag (``--pipeline.datamanager.subset-num``)
through tyro; this small reflection shim gives the same surface: nested
dataclasses become dotted argparse options, underscores and dashes are
interchangeable, and an unknown flag is refused. A bool flag given alone
(``--trace``) means True.
"""

from __future__ import annotations

import argparse
import dataclasses
import typing
from pathlib import Path


def _is_simple(tp) -> bool:
    return tp in (int, float, str, bool, Path) or (
        typing.get_origin(tp) is typing.Union
        and set(typing.get_args(tp)) <= {int, float, str, bool, Path, type(None)}
    )


def _base_type(tp):
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return args[0]
    return tp


def add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix: str = "") -> None:
    for f in dataclasses.fields(cls):
        tp = f.type
        if isinstance(tp, str):
            hints = typing.get_type_hints(cls)
            tp = hints.get(f.name, str)
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(_base_type(tp)):
            add_dataclass_args(parser, _base_type(tp), prefix=f"{name}.")
        elif _is_simple(tp):
            base = _base_type(tp)
            flag = "--" + name.replace("_", "-")
            if base is bool:
                parser.add_argument(flag, type=lambda s: s.lower() in ("1", "true", "yes"), nargs="?",
                                    const=True, default=None, metavar="{True,False}")
            else:
                parser.add_argument(flag, type=base if base is not Path else Path, default=None)
        # tuples/lists etc: skip (not used by the reference's flag surface)


def apply_overrides(cfg, args: argparse.Namespace, prefix: str = ""):
    """Return a copy of the (frozen or not) dataclass tree with CLI overrides."""
    updates = {}
    for f in dataclasses.fields(cfg):
        name = f"{prefix}{f.name}"
        val = getattr(cfg, f.name)
        if dataclasses.is_dataclass(val):
            updates[f.name] = apply_overrides(val, args, prefix=f"{name}.")
        else:
            arg_name = name.replace(".", "__").replace("-", "_")
            # argparse stores "a.b" as attribute "a.b"
            ns_val = getattr(args, name, None)
            if ns_val is None:
                ns_val = getattr(args, arg_name, None)
            if ns_val is not None:
                updates[f.name] = ns_val
    return dataclasses.replace(cfg, **updates)


def parse_config(cls, argv=None, description: str = ""):
    parser = argparse.ArgumentParser(description=description)
    add_dataclass_args(parser, cls)
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        raise SystemExit(f"unknown arguments: {unknown}")
    # argparse converts --a.b-c to attribute "a.b_c"; normalize lookup in
    # apply_overrides via getattr on the raw dest names
    return apply_overrides(cls(), args), args
