from . import geometry, beamform, freq, freq_equiv, equiv_kernel

__all__ = ["geometry", "beamform", "freq", "freq_equiv", "equiv_kernel"]
