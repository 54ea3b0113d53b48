"""Composite gadgets by derivation: allocate, select, witness hooks and
variable encoding, as in the JAX package's gadgets/derive.py (era-boojum's
cs_derive crate: CSAllocatable, CSSelectable, WitnessHookable,
CSVarLengthEncodable). Where Rust derives these at compile time, a
structural recursion over the fields of a dataclass does it at run time:

    @derive_gadget
    @dataclass
    class Point:
        x: Num
        y: Num

    p = Point.allocate(cs, {"x": 3, "y": 4})
    q = Point.select(cs, flag, p, r)
    hook = Point.witness_hook(cs, p); hook() -> {"x": 3, "y": 4}

Any field whose type provides `allocate`/`select`/`get_value` composes,
nested derived gadgets, lists and tuples included.
"""

from __future__ import annotations

import dataclasses

from .boolean import Boolean
from .num import Num


def _allocate_value(cls, cs, witness):
    if dataclasses.is_dataclass(cls) and hasattr(cls, "allocate"):
        return cls.allocate(cs, witness)
    if hasattr(cls, "allocate_checked"):
        return cls.allocate_checked(cs, witness)
    if hasattr(cls, "allocate"):
        return cls.allocate(cs, witness)
    raise TypeError(f"field type {cls} is not allocatable")


def _select_value(cs, flag, a, b):
    if type(a) is not type(b):
        raise TypeError("select over mismatched types")
    if isinstance(a, (list, tuple)):
        out = [ _select_value(cs, flag, x, y) for x, y in zip(a, b) ]
        return type(a)(out)
    t = type(a)
    if hasattr(t, "select"):
        return t.select(cs, flag, a, b)
    raise TypeError(f"{t} is not selectable")


def _witness_value(cs, v):
    if isinstance(v, (list, tuple)):
        return type(v)(_witness_value(cs, x) for x in v)
    if dataclasses.is_dataclass(v) and hasattr(type(v), "witness_hook"):
        return type(v).witness_hook(cs, v)()
    if hasattr(v, "get_value"):
        return v.get_value(cs)
    raise TypeError(f"{type(v)} is not witnessable")


def encode_variables(v) -> list:
    """A gadget (or a nested structure of gadgets) as its ordered list of
    circuit variables, field by field (era-boojum's CSVarLengthEncodable
    derive): the encoding commitment chains and public inputs take."""
    if isinstance(v, (list, tuple)):
        out = []
        for x in v:
            out.extend(encode_variables(x))
        return out
    if isinstance(v, (Num, Boolean)):
        return [v.var]
    if isinstance(v, int):  # a raw variable place
        return [v]
    if dataclasses.is_dataclass(v):
        out = []
        for f in dataclasses.fields(v):
            out.extend(encode_variables(getattr(v, f.name)))
        return out
    if hasattr(v, "encode_vars"):
        return list(v.encode_vars())
    raise TypeError(f"{type(v)} is not var-length encodable")


def derive_gadget(cls):
    """Class decorator adding allocate / select / witness_hook /
    encoding_length / encode_vars to a dataclass of gadget fields."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError("derive_gadget expects a dataclass")
    import typing

    hints = typing.get_type_hints(cls)
    fields = dataclasses.fields(cls)

    def allocate(cs, witness: dict):
        kwargs = {}
        for f in fields:
            kwargs[f.name] = _allocate_value(hints[f.name], cs, witness[f.name])
        return cls(**kwargs)

    def select(cs, flag: Boolean, a, b):
        kwargs = {
            f.name: _select_value(cs, flag, getattr(a, f.name), getattr(b, f.name))
            for f in fields
        }
        return cls(**kwargs)

    def witness_hook(cs, value):
        """A deferred witness getter: call the returned closure after
        synthesis for the values."""

        def hook():
            return {
                f.name: _witness_value(cs, getattr(value, f.name))
                for f in fields
            }

        return hook

    def encode_vars(self):
        return encode_variables(self)

    def encoding_length(self) -> int:
        return len(encode_variables(self))

    cls.allocate = staticmethod(allocate)
    cls.select = staticmethod(select)
    cls.witness_hook = staticmethod(witness_hook)
    cls.encode_vars = encode_vars
    cls.encoding_length = encoding_length
    return cls


__all__ = ["derive_gadget", "encode_variables"]
