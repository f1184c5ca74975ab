"""ROS 2 interface schemas (IDL), their loader and a payload validator
(the port's copy of ``boundplanner_tpu/idl/``: the same four schema files
and the same pure-Python parser).

The reference ships an interface package (`boundmpcmsg/`: MPCData.msg,
Vector.msg, Trajectory.srv, MPCParams.srv) that colcon compiles into
Python message classes. The schemas here are the same files (the field
set is the wire contract), with:

- a small .msg/.srv parser (`load_msg` / `load_srv`);
- `validate(schema, payload)`, which checks a payload dict against a
  schema (field membership, scalar or sequence kind), so that
  `ros_compat.mpc_data_dict` and `ros_compat.to_mpc_data_msg` emit only
  fields the IDL defines, with compatible kinds.

The real ROS message classes need a colcon workspace;
`ros_compat.to_mpc_data_msg` takes them from an importable `boundmpcmsg`
package at run time.
"""

from __future__ import annotations

import os
import re
from typing import Dict, NamedTuple, Tuple

import numpy as np

_IDL_DIR = os.path.dirname(__file__)

_SCALAR_TYPES = {
    "bool", "byte", "char",
    "int8", "uint8", "int16", "uint16", "int32", "uint32", "int64", "uint64",
    "float32", "float64", "string",
}


class Field(NamedTuple):
    type: str        # base type, e.g. "float32", "Vector", "std_msgs/Header"
    is_array: bool
    name: str


def _parse_fields(text: str) -> Dict[str, Field]:
    fields: Dict[str, Field] = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        m = re.match(r"^([\w/]+)(\[\d*\])?\s+(\w+)$", line)
        if m is None:
            raise ValueError(f"unparseable IDL line: {line!r}")
        base, arr, name = m.groups()
        fields[name] = Field(type=base, is_array=arr is not None, name=name)
    return fields


def load_msg(name: str) -> Dict[str, Field]:
    """Parse idl/msg/<name>.msg into an ordered {field name: Field} dict."""
    with open(os.path.join(_IDL_DIR, "msg", f"{name}.msg")) as f:
        return _parse_fields(f.read())


def load_srv(name: str) -> Tuple[Dict[str, Field], Dict[str, Field]]:
    """Parse idl/srv/<name>.srv into (request fields, response fields)."""
    with open(os.path.join(_IDL_DIR, "srv", f"{name}.srv")) as f:
        req, _, resp = f.read().partition("\n---\n")
    return _parse_fields(req), _parse_fields(resp)


def validate(schema: Dict[str, Field], payload: Dict) -> None:
    """Raise ValueError if any payload entry is absent from the schema or
    has an incompatible kind (scalar vs sequence). Payloads may be partial
    (absent fields take IDL defaults on the wire)."""
    for name, value in payload.items():
        if name not in schema:
            raise ValueError(f"field {name!r} not in schema")
        f = schema[name]
        seq = isinstance(value, (list, tuple))
        if f.is_array or f.type not in _SCALAR_TYPES:
            # arrays and composite types (Vector, Header) arrive as
            # sequences / dicts
            if not (seq or isinstance(value, dict)):
                raise ValueError(
                    f"field {name!r}: expected sequence/composite for "
                    f"{f.type}{'[]' if f.is_array else ''}, got {type(value)}"
                )
        else:
            if seq:
                raise ValueError(f"field {name!r}: expected scalar {f.type}")
            if f.type == "bool" and not isinstance(value, (bool, np.bool_)):
                raise ValueError(f"field {name!r}: expected bool")
            if f.type.startswith(("int", "uint")):
                # numpy integer scalars are wire-valid ints; Python bools
                # are ints by inheritance but a bool for an int field is a
                # caller mistake — reject it
                is_int = isinstance(value, (int, np.integer))
                if not is_int or isinstance(value, (bool, np.bool_)):
                    raise ValueError(
                        f"field {name!r}: expected int, got {type(value)}"
                    )
