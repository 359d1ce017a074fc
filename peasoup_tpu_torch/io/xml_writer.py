"""Minimal XML element tree matching the reference's formatting.

Reference: include/utils/xml_util.hpp — single-quoted attributes,
2-space indentation, 15-significant-digit numeric formatting
(std::setprecision(15) default-float notation == printf %.15g), bools
as 1/0, leaf text inline.
"""

from __future__ import annotations

from typing import Union

import numpy as np

Scalar = Union[str, int, float, bool, np.floating, np.integer]


def fmt(value: Scalar) -> str:
    if isinstance(value, (bool, np.bool_)):
        return "1" if value else "0"
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        return f"{float(value):.15g}"
    # escape markup characters so filenames/source names with &, <, '
    # cannot corrupt the document (the reference writes them raw, which
    # is why its own tools need a <username> cleanup workaround)
    return (
        str(value)
        .replace("&", "&amp;")
        .replace("<", "&lt;")
        .replace(">", "&gt;")
        .replace("'", "&apos;")
    )


class Element:
    def __init__(self, name: str, value: Scalar | None = None):
        self.name = name
        self.text = "" if value is None else fmt(value)
        self.attributes: dict[str, str] = {}
        self.children: list[Element] = []

    def append(self, child: "Element") -> "Element":
        self.children.append(child)
        return child

    def add_attribute(self, key: str, value: Scalar) -> None:
        self.attributes[key] = fmt(value)

    def to_string(self, header: bool = False, level: int = 0) -> str:
        out = []
        if header:
            out.append("<?xml version='1.0' encoding='ISO-8859-1'?>\n")
        indent = "  " * level
        attrs = "".join(f" {k}='{v}'" for k, v in self.attributes.items())
        out.append(f"{indent}<{self.name}{attrs}>")
        if not self.children:
            out.append(self.text)
        else:
            out.append("\n")
            for child in self.children:
                out.append(child.to_string(False, level + 1))
            out.append(indent)
        out.append(f"</{self.name}>\n")
        return "".join(out)
