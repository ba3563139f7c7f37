"""Keep the JAX package and JAX out of the benchmark's process.

Names are compared by their top-level part whole: `mira_tpu_torch` is the
program, `mira_tpu` the JAX package it was ported from.
"""

from __future__ import annotations

import sys

BLOCKED = ("jax", "jaxlib", "flax", "mira_tpu")


def top(name: str) -> str:
    return name.split(".", 1)[0]


class Blocker:
    """A meta-path finder that refuses the blocked top-level packages."""

    def find_spec(self, name, path=None, target=None):
        if top(name) in BLOCKED:
            raise ImportError(f"the benchmark does not load {name}")
        return None


def install():
    if not any(isinstance(f, Blocker) for f in sys.meta_path):
        sys.meta_path.insert(0, Blocker())


def loaded() -> list:
    """The blocked modules present in this process."""
    return sorted(m for m in list(sys.modules) if top(m) in BLOCKED)
