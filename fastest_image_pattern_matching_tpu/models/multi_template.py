"""Multi-template (glyph/OCR-style) matching.

The reference ships an OCR demo: a disabled 36-glyph loop over the
`Test Images/M12/` character templates, matching each glyph pattern
against the source in turn (MatchTool/MatchToolDlg.cpp:714-771). This
library makes this a first-class API: learn N patterns once, match them
against one source, label results, and resolve cross-template overlaps
globally (same greedy rotated-rect NMS, but across templates).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import MatchConfig
from ..types import LearnedPattern, MatchResult
from .template_matcher import learn_pattern, match


@dataclasses.dataclass
class LabeledMatch:
    label: str
    result: MatchResult


class MultiTemplateMatcher:
    """Learn a dictionary of templates; find all of them in a source.

    cross_nms resolves overlapping detections of different templates by
    score (the reference's per-glyph loop has no cross-glyph suppression;
    ours is optional and off by default for parity).
    """

    def __init__(self, config: Optional[MatchConfig] = None):
        self.config = config or MatchConfig()
        self.patterns: Dict[str, LearnedPattern] = {}

    def learn(self, label: str, templ: np.ndarray) -> None:
        self.patterns[label] = learn_pattern(templ,
                                             self.config.min_reduce_area)

    def learn_glyph_dir(self, directory: str) -> None:
        """Learn every image in a directory as a glyph (file stem = label),
        like the M12 glyph set."""
        import glob
        import os
        from ..utils.imageio import load_gray
        for p in sorted(glob.glob(os.path.join(directory, "*"))):
            if not p.lower().endswith((".bmp", ".jpg", ".png", ".jpeg")):
                continue
            label = os.path.splitext(os.path.basename(p))[0]
            try:
                self.learn(label, load_gray(p))
            except ValueError:
                continue

    def match_all(self, src: np.ndarray, cross_nms: bool = False,
                  batched: bool = True) -> List[LabeledMatch]:
        """batched=True (default) runs same-shaped glyph patterns through
        one compiled dispatch per shape group with the source pyramid
        hoisted (models.batch.match_patterns) — the batched answer to the
        reference's 36-dispatch glyph loop. batched=False keeps the
        per-glyph path for A/B."""
        labels, pats = [], []
        for label, pat in self.patterns.items():
            t0 = pat.levels[0].templ
            if t0.shape[0] * t0.shape[1] > src.shape[0] * src.shape[1]:
                continue  # template larger than source
            labels.append(label)
            pats.append(pat)
        out: List[LabeledMatch] = []
        if batched and pats:
            from .batch import _results_from_arrays, match_patterns
            arrs = match_patterns(src, pats, self.config)
            for label, pat, arr in zip(labels, pats, arrs):
                batched_out = {k: v[None] for k, v in arr.items()}
                out.extend(LabeledMatch(label, r) for r in
                           _results_from_arrays(batched_out, 0, pat))
        else:
            for label, pat in zip(labels, pats):
                try:
                    results = match(src, pat, self.config)
                except ValueError:
                    continue
                out.extend(LabeledMatch(label, r) for r in results)
        out.sort(key=lambda m: -m.result.score)
        if cross_nms and out:
            out = self._cross_nms(out)
        return out

    def _cross_nms(self, matches: List[LabeledMatch]) -> List[LabeledMatch]:
        """Greedy cross-template suppression via the native host NMS."""
        from ..native import get_lib
        import ctypes
        lib = get_lib()
        n = len(matches)
        quads = np.zeros((n, 4, 2), np.float64)
        for i, m in enumerate(matches):
            r = m.result
            quads[i] = [r.lt, r.rt, r.rb, r.lb]
        alive = np.ones(n, np.uint8)
        # Use each pair's smaller rect area as the ratio base.
        areas = [abs((np.linalg.norm(np.subtract(m.result.rt, m.result.lt)))
                     * np.linalg.norm(np.subtract(m.result.lb, m.result.lt)))
                 for m in matches]
        base = float(np.median(areas)) if areas else 1.0
        if lib is not None:
            lib.fipm_filter_overlaps(
                quads.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
                alive.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                base, self.config.max_overlap)
            return [m for m, a in zip(matches, alive) if a]
        return matches


def match_glyphs(src: np.ndarray, glyph_dir: str,
                 config: Optional[MatchConfig] = None,
                 cross_nms: bool = True) -> List[LabeledMatch]:
    """One-call OCR-style glyph matching (the M12 demo as an API)."""
    m = MultiTemplateMatcher(config or MatchConfig(
        max_pos=10, score=0.8, tolerance_angle=0.0))
    m.learn_glyph_dir(glyph_dir)
    return m.match_all(src, cross_nms=cross_nms)


def read_string(matches: Sequence[LabeledMatch], min_score: float = 0.0,
                x_merge: float = 12.0) -> str:
    """Assemble the left-to-right string from labeled glyph matches — the
    read-out step of the reference's OCR demo (which stamps per-glyph
    results onto the image, MatchToolDlg.cpp:745-760; here a string).

    Glyphs below min_score are dropped; matches within x_merge px of the
    last ACCEPTED glyph's anchor position are treated as duplicate
    detections of the same character (keep the best score). The anchor
    does not move when a better-scoring duplicate replaces the kept one,
    so the merge window cannot chain across a row of distinct glyphs —
    but x_merge must still be below the glyph pitch, or alternating
    characters are swallowed."""
    hits = [m for m in matches if m.result.score >= min_score]
    hits.sort(key=lambda m: m.result.pos_x)
    out: List[LabeledMatch] = []
    anchor_x = None
    for m in hits:
        if out and abs(m.result.pos_x - anchor_x) < x_merge:
            if m.result.score > out[-1].result.score:
                out[-1] = m
            continue
        out.append(m)
        anchor_x = m.result.pos_x
    return "".join(m.label for m in out)
