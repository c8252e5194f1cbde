from .meta_graph import meta_graph_generation

__all__ = ["meta_graph_generation"]
