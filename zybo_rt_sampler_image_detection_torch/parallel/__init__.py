from . import mesh

__all__ = ["mesh"]
