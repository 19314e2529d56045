"""Typed CSV row parsing.

Parity: reference exprgrad/io/csvformat.nim:20-195 (macro-driven typed rows
with csvColumn/csvIgnore pragmas).  The Python embedding is a dataclass
whose field annotations drive parsing; ``column`` metadata renames headers::

    @dataclasses.dataclass
    class Passenger:
        survived: bool
        age: float = csv_column("Age", default=0.0)

    for row in iter_csv("data.csv", Passenger):
        ...
"""

from __future__ import annotations

import csv as _csv
import dataclasses
from typing import Iterator, TypeVar

from ..errors import ModelRuntimeError

T = TypeVar("T")


def csv_column(name: str, default=dataclasses.MISSING):
    """Map a dataclass field to a differently named CSV column."""
    return dataclasses.field(
        default=default, metadata={"csv_column": name}
    )


_TRUE = {"1", "true", "yes", "t"}
_FALSE = {"0", "false", "no", "f", ""}


def _parse(value: str, typ) -> object:
    if typ is str:
        return value
    if typ is int:
        return int(value) if value else 0
    if typ is float:
        return float(value) if value else 0.0
    if typ is bool:
        lower = value.strip().lower()
        if lower in _TRUE:
            return True
        if lower in _FALSE:
            return False
        raise ModelRuntimeError(f"cannot parse {value!r} as bool")
    raise ModelRuntimeError(f"unsupported CSV field type {typ}")


def iter_csv(
    path: str,
    row_type: type[T],
    sep: str = ",",
    header: bool = True,
) -> Iterator[T]:
    """Yield typed rows from a CSV file."""
    fields = dataclasses.fields(row_type)
    with open(path, newline="") as f:
        reader = _csv.reader(f, delimiter=sep)
        col_of: dict[str, int] = {}
        if header:
            try:
                names = next(reader)
            except StopIteration:
                return
            col_of = {name: idx for idx, name in enumerate(names)}
        for record in reader:
            if not record:
                continue
            kwargs = {}
            for idx, field in enumerate(fields):
                col_name = field.metadata.get("csv_column", field.name)
                if header:
                    if col_name not in col_of:
                        if field.default is dataclasses.MISSING:
                            raise ModelRuntimeError(
                                f"CSV column {col_name!r} not found"
                            )
                        continue
                    raw = record[col_of[col_name]]
                else:
                    raw = record[idx]
                kwargs[field.name] = _parse(raw, field.type if not isinstance(field.type, str) else eval(field.type))  # noqa: S307
            yield row_type(**kwargs)


def load_csv_columns(
    path: str, columns: dict[str, type], sep: str = ","
) -> dict[str, list]:
    """Load named columns as typed python lists."""
    out: dict[str, list] = {name: [] for name in columns}
    with open(path, newline="") as f:
        reader = _csv.reader(f, delimiter=sep)
        names = next(reader)
        col_of = {name: idx for idx, name in enumerate(names)}
        for name in columns:
            if name not in col_of:
                raise ModelRuntimeError(f"CSV column {name!r} not found")
        for record in reader:
            if not record:
                continue
            for name, typ in columns.items():
                out[name].append(_parse(record[col_of[name]], typ))
    return out
