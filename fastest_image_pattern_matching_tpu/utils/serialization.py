"""Match-result artifacts.

The reference persists almost nothing (SURVEY.md §5): QSettings UI params,
an optional ORB yaml (ORBFeatureMatcher.cpp:420-441), and matched-ROI bmp
dumps (OutputRoi, MatchToolDlg.cpp:1223-1236). This library makes records
first-class: JSON/JSONL writers for match lists and ORB results, plus ROI
dumps via the native BMP encoder.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List, Optional

import numpy as np

from ..types import MatchResult


def match_results_to_dict(results: List[MatchResult],
                          execution_ms: Optional[float] = None) -> dict:
    return {
        "execution_ms": execution_ms,
        "count": len(results),
        "matches": [{
            "index": i, "score": r.score, "angle": r.angle,
            "pos_x": r.pos_x, "pos_y": r.pos_y,
            "corners": [list(r.lt), list(r.rt), list(r.rb), list(r.lb)],
        } for i, r in enumerate(results)],
    }


def save_match_results(path: str, results: List[MatchResult],
                       execution_ms: Optional[float] = None) -> None:
    with open(path, "w") as f:
        json.dump(match_results_to_dict(results, execution_ms), f, indent=1)


def load_match_results(path: str) -> List[MatchResult]:
    with open(path) as f:
        data = json.load(f)
    out = []
    for m in data["matches"]:
        c = m["corners"]
        out.append(MatchResult(
            score=m["score"], angle=m["angle"],
            center=(m["pos_x"], m["pos_y"]),
            lt=tuple(c[0]), rt=tuple(c[1]), rb=tuple(c[2]), lb=tuple(c[3])))
    return out


def append_jsonl(path: str, record: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def save_roi_dumps(directory: str, src: np.ndarray,
                   results: List[MatchResult]) -> List[str]:
    """OutputRoi equivalent: save each match's axis-aligned bounding crop
    as roiN.bmp (MatchToolDlg.cpp:1223-1236 used LT..RB; we use the full
    rotated-corner bbox so rotated matches are fully contained)."""
    import os
    from .imageio import save_gray
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, r in enumerate(results):
        xs = [r.lt[0], r.rt[0], r.rb[0], r.lb[0]]
        ys = [r.lt[1], r.rt[1], r.rb[1], r.lb[1]]
        x0, x1 = max(0, int(min(xs))), min(src.shape[1], int(max(xs)) + 1)
        y0, y1 = max(0, int(min(ys))), min(src.shape[0], int(max(ys)) + 1)
        if x1 <= x0 or y1 <= y0:
            continue
        p = os.path.join(directory, f"roi{i}.bmp")
        save_gray(p, src[y0:y1, x0:x1])
        paths.append(p)
    return paths


def save_orb_result(path: str, result) -> bool:
    """ORB result persistence with the reference's exact cv::FileStorage
    field set (ORBFeatureMatcher.cpp:420-441: matchLocation_x/y,
    matchScore, rotationAngle, scale, isMatched, goodMatchesCount) —
    written through cv2.FileStorage when the path ends in .yml/.yaml/.xml
    (byte-level interchange with OpenCV-based systems), JSON otherwise.

    matchLocation is the projected-corner centroid; matchScore the
    inlier ratio (the reference leaves both fields' computation commented
    out, :188-190 — these are the natural definitions from its data).
    """
    if not result.is_matched:
        return False  # the reference refuses unmatched results (:422)
    loc = ([float(np.mean(result.corners[:, 0])),
            float(np.mean(result.corners[:, 1]))]
           if result.corners is not None else [0.0, 0.0])
    score = (result.num_inliers / max(result.num_good_matches, 1))
    fields = {
        "matchLocation_x": loc[0],
        "matchLocation_y": loc[1],
        "matchScore": float(score),
        "rotationAngle": float(result.rotation_angle),
        "scale": float(result.scale_mm_per_pix),
        "isMatched": 1,
        "goodMatchesCount": int(result.num_good_matches),
    }
    if path.endswith((".yml", ".yaml", ".xml")):
        import cv2
        fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
        if not fs.isOpened():
            return False
        for k, v in fields.items():
            fs.write(k, v)
        fs.release()
        return True
    with open(path, "w") as f:
        json.dump(fields, f, indent=1)
    return True


def load_orb_result(path: str) -> dict:
    """Load a saved ORB record (cv2.FileStorage yaml/xml or JSON) back
    into a plain dict of the reference's field set."""
    keys = ["matchLocation_x", "matchLocation_y", "matchScore",
            "rotationAngle", "scale", "isMatched", "goodMatchesCount"]
    if path.endswith((".yml", ".yaml", ".xml")):
        import cv2
        fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
        out = {k: fs.getNode(k).real() for k in keys}
        fs.release()
        out["isMatched"] = bool(out["isMatched"])
        out["goodMatchesCount"] = int(out["goodMatchesCount"])
        return out
    with open(path) as f:
        out = json.load(f)
    out["isMatched"] = bool(out["isMatched"])
    return out
