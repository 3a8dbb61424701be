"""Reader/writer for the OpenCV FileStorage YAML dialect.

Port of `rt_depth_map_tpu/calib/fs_yaml.py`, whose reader needs PyYAML; the
machine the port runs on has none, so this reader parses the dialect by
hand. It reads what OpenCV's `FileStorage` writes for a calibration: the
`%YAML:1.0` directive and the `---` marker, top-level `name: value` entries
whose value is a scalar (int, float, string), a flow sequence `[ a, b, ... ]`
(over several lines), a block sequence (`- a` lines) or an
`!!opencv-matrix` mapping of `rows`, `cols`, `dt` and `data` (its data over
several lines). Matrices become numpy arrays of their `dt`, as in the
original. `write_filestorage` is the original's, unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

_DT_TO_NUMPY = {
    "d": np.float64,
    "f": np.float32,
    "i": np.int32,
    "s": np.int16,
    "u": np.uint8,
}
_NUMPY_TO_DT = {np.dtype(v): k for k, v in _DT_TO_NUMPY.items()}
_MATRIX_TAGS = ("!!opencv-matrix", "!opencv-matrix")
_SPECIAL = {".inf": float("inf"), "+.inf": float("inf"),
            "-.inf": float("-inf"), ".nan": float("nan")}


def _scalar(token: str) -> Any:
    """A plain or quoted YAML scalar: int, float, or string."""
    t = token.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "\"'":
        return t[1:-1]
    if t.lower() in _SPECIAL:
        return _SPECIAL[t.lower()]
    for cast in (int, float):
        try:
            return cast(t)
        except ValueError:
            pass
    return t


def _flow_sequence(text: str, where: str) -> List[Any]:
    body = text.strip()
    if not (body.startswith("[") and body.endswith("]")):
        raise ValueError(f"{where}: expected a [ ... ] sequence, got {text!r}")
    body = body[1:-1].strip()
    return [_scalar(v) for v in body.split(",")] if body else []


def _value(text: str, where: str) -> Any:
    return (_flow_sequence(text, where) if text.lstrip().startswith("[")
            else _scalar(text))


def _logical_lines(text: str) -> List[str]:
    """Lines without the directive, markers, comments and blanks; a flow
    sequence's lines joined into one."""
    out: List[str] = []
    pending = None
    for raw in text.splitlines():
        stripped = raw.strip()
        if pending is None and (not stripped or stripped.startswith(("%", "#"))
                                or stripped in ("---", "...")):
            continue
        pending = raw.rstrip() if pending is None else f"{pending} {stripped}"
        if pending.count("[") <= pending.count("]"):
            out.append(pending)
            pending = None
    if pending is not None:
        raise ValueError(f"unterminated sequence: {pending[:60]!r}")
    return out


def _split_key(line: str, where: str):
    key, sep, rest = line.strip().partition(":")
    if not sep or not key:
        raise ValueError(f"{where}: expected 'name: value', got {line.strip()!r}")
    return key.strip().strip("\"'"), rest.strip()


def _matrix(fields: Dict[str, Any], where: str) -> np.ndarray:
    rows, cols = int(fields["rows"]), int(fields["cols"])
    dtype = _DT_TO_NUMPY.get(fields.get("dt", "d"), np.float64)
    data = np.asarray(fields["data"], dtype=dtype)
    if data.size != rows * cols:
        raise ValueError(f"{where}: {data.size} values for a {rows}x{cols} matrix")
    return data.reshape(rows, cols)


def read_filestorage(path: str) -> Dict[str, Any]:
    """Parse an OpenCV FileStorage YAML file into a dict.

    opencv-matrix nodes become numpy arrays; scalars and plain lists pass
    through (e.g. `ROI1: [49, 43, 233, 156]` -> list of ints).
    """
    with open(path, "r") as f:
        lines = _logical_lines(f.read())
    data: Dict[str, Any] = {}
    i = 0
    while i < len(lines):
        line = lines[i]
        if line[0].isspace():
            raise ValueError(f"{path}: unexpected indented line {line.strip()!r}")
        name, rest = _split_key(line, path)
        block = []  # the indented lines that belong to this entry
        i += 1
        while i < len(lines) and lines[i][0].isspace():
            block.append(lines[i].strip())
            i += 1
        where = f"{path}: {name}"
        if rest in _MATRIX_TAGS:
            fields = dict(_split_key(b, where) for b in block)
            fields = {k: _value(v, where) for k, v in fields.items()}
            data[name] = _matrix(fields, where)
        elif block:
            if rest or not all(b.startswith("-") for b in block):
                raise ValueError(f"{where}: unsupported nested entry")
            data[name] = [_scalar(b[1:]) for b in block]
        else:
            data[name] = _value(rest, where) if rest else None
    return data


def _format_matrix(name: str, arr: np.ndarray) -> str:
    arr = np.atleast_2d(np.asarray(arr))
    dt = _NUMPY_TO_DT.get(arr.dtype, "d")
    if dt == "d":
        vals = ", ".join(repr(float(v)) for v in arr.ravel())
    else:
        vals = ", ".join(str(int(v)) for v in arr.ravel())
    return (
        f"{name}: !!opencv-matrix\n"
        f"   rows: {arr.shape[0]}\n"
        f"   cols: {arr.shape[1]}\n"
        f"   dt: {dt}\n"
        f"   data: [ {vals} ]\n"
    )


def write_filestorage(path: str, entries: Dict[str, Any]) -> None:
    """Write a dict to OpenCV FileStorage YAML (matrices, scalars, lists)."""
    out = ["%YAML:1.0\n"]
    for name, value in entries.items():
        if isinstance(value, np.ndarray):
            out.append(_format_matrix(name, value))
        elif isinstance(value, (list, tuple)):
            out.append(f"{name}: [ " + ", ".join(str(v) for v in value) + " ]\n")
        elif isinstance(value, float):
            out.append(f"{name}: {value!r}\n")
        else:
            out.append(f"{name}: {value}\n")
    with open(path, "w") as f:
        f.write("".join(out))
