from . import geometry, beamform, freq_equiv, equiv_kernel

__all__ = ["geometry", "beamform", "freq_equiv", "equiv_kernel"]
