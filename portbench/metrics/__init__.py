"""One reader a per-layer metric, found by the metric's name
(``metrics/<name>.py``): ``read(ctx)`` returns the metric's value from the
traced run's context (:class:`portbench.run.Context`), or None where the
run gives it nothing to read; the harness then leaves the metric out of
the line."""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")
