"""Match configuration.

A typed mirror of the reference tool's user parameters and checkboxes
(reference: MatchTool/MatchToolDlg.cpp:108-117 validation ranges;
ui/MatchToolDialog.ui:103-270 defaults; MatchToolDlg.h:279-342 checkboxes).

Accelerator knobs (compute dtype, candidate capacity) are additions that do
not exist in the reference; their defaults preserve reference semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Reference compile-time constants (MatchTool/MatchToolDlg.cpp:15-18).
VISION_TOLERANCE = 0.0000001
D2R = 3.141592653589793 / 180.0
R2D = 180.0 / 3.141592653589793
MATCH_CANDIDATE_NUM = 5


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """User-facing matching parameters.

    Defaults mirror the reference Qt UI (ui/MatchToolDialog.ui:103-213):
    maxPos 70, overlap 0.1, score 0.7, tolerance 180, minReduceArea 256,
    subpixel on.
    """

    # --- core parameters (validated like MatchToolDlg.cpp:108-117) ---
    max_pos: int = 70                 # "TargetNumber", 1..200
    max_overlap: float = 0.1          # 0..0.8
    score: float = 0.7                # min score, 0..1
    tolerance_angle: float = 180.0    # 0..180 degrees
    min_reduce_area: int = 256        # 64..2048

    # --- checkboxes (MatchToolDlg.h:279-342) ---
    use_subpixel: bool = True
    bitwise_not: bool = False
    fast_mode: bool = False           # m_bStopLayer1: stop descent at layer 1

    # --- dual tolerance-range mode (m_bToleranceRange, m_dTolerance1..4,
    #     MatchToolDlg.cpp:805-816) ---
    tolerance_ranges: Optional[Tuple[float, float, float, float]] = None

    # --- accelerator knobs (not in reference) ---
    # Max refinement candidates carried through the pyramid descent. The
    # reference refines every top-layer candidate (MatchToolDlg.cpp:939);
    # None = the same: keep all n_angles*(max_pos+5) extracted peaks
    # (bounded at 2048 for pathological tiny-template/max_pos=200 sweeps).
    # Alive-masked chunk-skipping keeps dead candidates nearly free, so
    # this only costs where candidates genuinely survive. Set a number to
    # trade recall parity for speed (keeps the top scorers, sorted like
    # the reference sorts at :890).
    max_candidates: Optional[int] = None
    # Correlation compute dtype: "bf16" (default; u8-centered
    # inputs are exact in bf16, f32 accumulation) or "f32".
    compute_dtype: str = "bf16"
    # Round warped canvases to integers, emulating the reference's u8
    # rotated images (warpAffine writes u8, MatchToolDlg.cpp:856).
    quantize_warp: bool = True
    # Narrow the candidate set to the top scorers before the expensive
    # low-pyramid layers (bound: max(2*max_pos+4, 16)). OFF by default:
    # the reference refines every candidate, and weak matches (low score
    # threshold) can rank deep at the top layer (e.g. Src8's 0.53-score
    # target ranks >16th). Enable for strong-target production workloads
    # where it halves refinement cost.
    narrow_candidates: bool = False
    # Two-phase adaptive compaction: run cheap upper pyramid layers, read
    # the survivor count on the host, and dispatch the expensive low
    # layers with a right-sized candidate set. Exactly equivalent results
    # (only already-dead candidates are dropped). Superseded by the
    # on-device alive-compaction inside the single compiled program
    # (descend sorts alive-first and lax.cond-skips all-dead chunks),
    # which achieves the same adaptive cost with one fewer host
    # round-trip per match — so OFF by default; kept for A/B testing.
    two_phase: bool = False

    def __post_init__(self):
        if not (1 <= self.max_pos <= 200):
            raise ValueError(f"max_pos must be in [1, 200], got {self.max_pos}")
        if not (0.0 <= self.max_overlap <= 0.8):
            raise ValueError(f"max_overlap must be in [0, 0.8], got {self.max_overlap}")
        if not (0.0 <= self.score <= 1.0):
            raise ValueError(f"score must be in [0, 1], got {self.score}")
        if not (0.0 <= self.tolerance_angle <= 180.0):
            raise ValueError(
                f"tolerance_angle must be in [0, 180], got {self.tolerance_angle}")
        if not (64 <= self.min_reduce_area <= 2048):
            raise ValueError(
                f"min_reduce_area must be in [64, 2048], got {self.min_reduce_area}")
        if self.tolerance_ranges is not None:
            object.__setattr__(self, "tolerance_ranges",
                               tuple(self.tolerance_ranges))
            t1, t2, t3, t4 = self.tolerance_ranges
            # Reference requires left < right per range (MatchToolDlg.cpp:807-810).
            if t1 >= t2 or t3 >= t4:
                raise ValueError("tolerance_ranges: need t1 < t2 and t3 < t4")
        if self.compute_dtype not in ("bf16", "f32"):
            raise ValueError(f"compute_dtype must be 'bf16' or 'f32', got "
                             f"{self.compute_dtype!r}")

    @property
    def effective_max_candidates(self) -> int:
        if self.max_candidates is not None:
            return self.max_candidates
        # No cap (reference refines every candidate); 2048 bounds the
        # NMS pair matrix in pathological many-angle/many-target configs.
        return 2048
