from .sampling import negative_sampling, structured_negative_sampling

__all__ = ["negative_sampling", "structured_negative_sampling"]
