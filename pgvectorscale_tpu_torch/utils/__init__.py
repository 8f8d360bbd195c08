"""Utility surface: the debug, stats and datasets modules (the analog of
the reference's util/ layer, SURVEY.md §2.8, reduced to its user-facing
pieces)."""

from .. import debug, stats
from ..io import datasets

__all__ = ["datasets", "debug", "stats"]
