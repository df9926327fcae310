"""zybo_rt_sampler_image_detection_torch — the acoustic camera in PyTorch.

The PyTorch/CUDA port of ``zybo_rt_sampler_image_detection_tpu`` for an
NVIDIA H100.  It mirrors that package's layout (``ops/ ingest/ apps/
utils/``) and imports ``torch``, never ``jax``.  Ported so far: the MIMO
heatmap (UDP packets -> ingest -> steering tables -> exact
frequency-domain reformulation -> the fused equiv-power CUDA kernel ->
heatmap queue -> display) and delay-and-sum listening (the steered beam
of every frame -> audio sink).

Quick start::

    import zybo_rt_sampler_image_detection_torch as zrt
    from zybo_rt_sampler_image_detection_torch.ops import beamform
    cfg = zrt.Config()
    tables = beamform.make_tables(cfg, "lerp", device="cuda")
    heatmap = beamform.steered_power(frame, tables)       # (X, Y)
"""

from .config import Config, REFERENCE_DEAD_MICS
from . import ops
from . import ingest
from . import utils

__version__ = "0.1.0"
__all__ = ["Config", "REFERENCE_DEAD_MICS", "ops", "ingest", "utils"]
