"""Host-side utilities."""

from .directed import meta_graph_generation

__all__ = ["meta_graph_generation"]
