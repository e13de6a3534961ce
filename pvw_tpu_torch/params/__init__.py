from .crs import PvwCrs
from .parameters import PvwParameters, PvwParametersBuilder
from .ring import RingPlan, get_ring

__all__ = ["PvwCrs", "PvwParameters", "PvwParametersBuilder", "RingPlan", "get_ring"]
