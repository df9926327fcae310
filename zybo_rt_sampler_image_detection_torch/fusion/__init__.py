from . import decider
from .decider import SensorFusionDecider

__all__ = ["decider", "SensorFusionDecider"]
