"""hessgpu_tpu: a Hessian interest-point detector + SIFT descriptor
framework (JAX/XLA re-architecture of sloup/hessgpu),
plus matching, two-view geometry, and SfM layers.

Public API mirrors the reference's SiftGPU/SiftMatchGPU surface
(reference SiftGPU.h:163-359) in idiomatic Python:

    from hessgpu_tpu import HessianSift, SiftMatcher, SiftConfig
    sift = HessianSift(SiftConfig())
    feats = sift.run("image.jpg")          # dict of arrays + descriptors
    matcher = SiftMatcher()
    matches = matcher.match(feats1, feats2)
"""

from .config import SiftConfig
from .detector import HessianSift
from .features import FeatureTable
from .matcher import SiftMatcher
from .params import ScaleSpaceParams

__all__ = [
    "SiftConfig",
    "HessianSift",
    "FeatureTable",
    "SiftMatcher",
    "ScaleSpaceParams",
]

__version__ = "0.1.0"
