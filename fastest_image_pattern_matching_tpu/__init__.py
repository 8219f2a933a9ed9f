"""fastest_image_pattern_matching_tpu — a JAX/XLA rotation-invariant
template-matching framework for accelerators.

Same capability surface as the reference C++ tool
(lrm2017/Fastest_Image_Pattern_Matching): image-pyramid coarse-to-fine
normalized cross-correlation with rotation search, subpixel (x, y, theta)
refinement, multi-target greedy peak extraction, rotated-rect NMS, plus an
ORB feature-matching secondary path — redesigned for an accelerator:
batched matmul/conv correlation, vmapped warps, on-device reductions, mesh
sharding.
"""

from .config import MatchConfig
from .types import LearnedPattern, MatchResult
from .models.template_matcher import (TemplateMatcher, learn_pattern, match,
                                      match_arrays, match_candidates,
                                      match_template)
from .models.batch import (BatchMatcher, match_many, match_many_arrays,
                           match_patterns)
from .aot import (AotMatcher, AotOrb, export_match_pack,
                  export_orb_pack)
from .models.orb import ORBConfig, ORBResult, orb_match, orb_match_many
from .parallel.matcher import match_batch_sharded
from .parallel.mesh import init_distributed, make_mesh
from .parallel.serving import (make_data_mesh, match_patterns_sharded,
                               orb_match_many_sharded)

__version__ = "0.3.0"

__all__ = [
    "MatchConfig", "LearnedPattern", "MatchResult",
    "TemplateMatcher", "learn_pattern", "match", "match_arrays",
    "match_candidates", "match_template",
    "BatchMatcher", "match_many", "match_many_arrays", "match_patterns",
    "AotMatcher", "AotOrb", "export_match_pack", "export_orb_pack",
    "ORBConfig", "ORBResult", "orb_match", "orb_match_many",
    "match_batch_sharded", "make_mesh", "init_distributed",
    "orb_match_many_sharded", "match_patterns_sharded", "make_data_mesh",
]
