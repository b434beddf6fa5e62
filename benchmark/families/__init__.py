"""One module per model family a configuration names (``"family"``): the
variables it has and how they start, the program's model, the plain
reference's model, and the arithmetic of its work."""

import importlib


def load(name: str):
    return importlib.import_module(f"benchmark.families.{name}")
