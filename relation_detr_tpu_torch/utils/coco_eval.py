"""COCO bbox mAP evaluation, numpy only (pycocotools' COCOeval semantics).

The port's own copy of ``relation_detr_tpu/utils/coco_eval.py``: greedy
per-(image, category) matching at IoU thresholds .5:.05:.95, crowd regions
as ignore-with-expand IoU, area-range filtering, 101-point interpolated AP,
the standard 12-stat summary and the per-category table. Held equal to the
original, stat for stat, by ``tests/test_torch_coco_eval.py``.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU of xywh boxes; crowd gt uses intersection-over-det-area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx0, dy0 = dets[:, 0], dets[:, 1]
    dx1, dy1 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx0, gy0 = gts[:, 0], gts[:, 1]
    gx1, gy1 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = np.clip(
        np.minimum(dx1[:, None], gx1[None]) - np.maximum(dx0[:, None], gx0[None]), 0, None
    )
    iy = np.clip(
        np.minimum(dy1[:, None], gy1[None]) - np.maximum(dy0[:, None], gy0[None]), 0, None
    )
    inter = ix * iy
    det_area = (dets[:, 2] * dets[:, 3])[:, None]
    gt_area = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None], det_area, det_area + gt_area - inter)
    return inter / np.maximum(union, 1e-12)


class CocoEvaluator:
    """Accumulates detections and computes the 12 COCO bbox stats."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            coco = json.load(f)
        self.img_ids = [img["id"] for img in coco["images"]]
        self.cat_ids = sorted(c["id"] for c in coco["categories"])
        self.gts = defaultdict(list)  # (img_id, cat_id) -> list of anns
        for ann in coco["annotations"]:
            self.gts[(ann["image_id"], ann["category_id"])].append(ann)
        self.dets = defaultdict(list)
        # (img_id, cat_id) -> _evaluate_img result, filled eagerly by
        # update_from_arrays so the ~ms-per-pair greedy matching overlaps the
        # device forward in the pipelined eval stream (utils/evaluation.py)
        # instead of serializing into accumulate at the end.
        self._match_cache: Dict = {}
        self._seen_imgs = set()
        self._img_cats_with_gts = defaultdict(set)
        for img_id, cat_id in self.gts:
            self._img_cats_with_gts[img_id].add(cat_id)

    def update(self, predictions: Sequence[Dict]):
        """predictions: iterable of dicts with image_id, category_id,
        bbox (xywh), score."""
        for p in predictions:
            self.dets[(p["image_id"], p["category_id"])].append(p)
            self._match_cache.pop((p["image_id"], p["category_id"]), None)

    def update_from_arrays(
        self, image_id: int, boxes_xyxy, scores, labels, skip_if_seen: bool = False
    ):
        # skip_if_seen dedups repeated WHOLE images (multi-host wraparound
        # padding, or an image arriving again via the cross-process eval
        # merge) — the reference dedups identically by unique img_ids at
        # merge time (its util/coco_eval.py:46-53). Default off:
        # incremental per-image updates remain valid.
        if skip_if_seen and image_id in self._seen_imgs:
            return
        self._seen_imgs.add(image_id)
        cats = set()
        for box, score, label in zip(boxes_xyxy, scores, labels):
            x0, y0, x1, y1 = [float(v) for v in box]
            cats.add(int(label))
            self.dets[(image_id, int(label))].append(
                {
                    "image_id": image_id,
                    "category_id": int(label),
                    "bbox": [x0, y0, x1 - x0, y1 - y0],
                    "score": float(score),
                }
            )
        for cat_id in cats | self._img_cats_with_gts.get(image_id, set()):
            if cat_id in self.cat_ids:
                self._match_cache[(image_id, cat_id)] = self._evaluate_img(
                    image_id, cat_id
                )

    @property
    def seen_images(self):
        """The ids of the images added through ``update_from_arrays``."""
        return frozenset(self._seen_imgs)

    def forget_images(self, image_ids) -> None:
        """Drops every detection of ``image_ids``, as if never added."""
        image_ids = set(image_ids)
        for key in [k for k in self.dets if k[0] in image_ids]:
            del self.dets[key]
        for key in [k for k in self._match_cache if k[0] in image_ids]:
            del self._match_cache[key]
        self._seen_imgs -= image_ids

    def _evaluate_img(self, img_id, cat_id):
        """One pass per (image, category): IoU computed once, greedy matching
        per area range vectorized over all IoU thresholds. Per-maxDet variants
        are derived in accumulate by slicing the score-ordered prefix
        (pycocotools COCOeval.evaluateImg/accumulate structure).

        Returns None when the (image, category) pair has no gts and no dets,
        else a dict with per-area-range match/ignore arrays for the top
        max(MAX_DETS) detections.
        """
        gts = self.gts.get((img_id, cat_id), [])
        dets = sorted(
            self.dets.get((img_id, cat_id), []), key=lambda d: -d["score"]
        )[: MAX_DETS[-1]]
        if not gts and not dets:
            return None
        gt_boxes = np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        gt_crowd = np.asarray([g.get("iscrowd", 0) for g in gts], bool)
        gt_area = np.asarray(
            [g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gts]
        ).reshape(-1)
        det_boxes = np.asarray([d["bbox"] for d in dets], np.float64).reshape(-1, 4)
        det_scores = np.asarray([d["score"] for d in dets])
        det_area = det_boxes[:, 2] * det_boxes[:, 3]
        ious_raw = _iou_xywh(det_boxes, gt_boxes, gt_crowd)

        num_thr, num_det, num_gt = len(IOU_THRS), len(dets), len(gts)
        thr_col = np.minimum(IOU_THRS, 1 - 1e-10)[:, None]  # (T, 1)
        out = {"det_scores": det_scores, "by_area": {}}
        for aname, area_rng in AREA_RANGES.items():
            gt_ignore = gt_crowd | (gt_area < area_rng[0]) | (gt_area > area_rng[1])
            # gts sorted ignore-last (stable), per pycocotools
            order = np.argsort(gt_ignore, kind="stable")
            gi, gc = gt_ignore[order], gt_crowd[order]
            ious = ious_raw[:, order]
            n_real = int((~gi).sum())

            gt_match = np.full((num_thr, num_gt), -1, np.int64)
            det_match = np.full((num_thr, num_det), -1, np.int64)
            det_ignore = np.zeros((num_thr, num_det), bool)
            trange = np.arange(num_thr)
            # non-ignored gts get a +2 score bonus: any candidate real gt
            # outranks every ignored one (iou <= 1), which collapses the
            # reference's two matching phases into one argmax; ties still go
            # to the LAST scanned gt within a phase (reversed argmax on the
            # ignore-last ordering).
            bonus = 2.0 * (~gi)[None, :]
            for d in range(num_det if num_gt else 0):
                iou_d = ious[d]
                # a used non-crowd gt is unavailable; crowd gts stay matchable
                cand = ((gt_match < 0) | gc[None, :]) & (iou_d[None] >= thr_col)
                score = np.where(cand, iou_d[None] + bonus, -np.inf)
                idx = (num_gt - 1) - np.argmax(score[:, ::-1], axis=1)
                hit = cand.any(axis=1)
                m = idx[hit]
                det_match[hit, d] = m
                det_ignore[hit, d] = gi[m]
                gt_match[trange[hit], m] = d
            det_oor = (det_area < area_rng[0]) | (det_area > area_rng[1])
            det_ignore = det_ignore | ((det_match == -1) & det_oor[None])
            out["by_area"][aname] = {
                "det_matched": det_match >= 0,
                "det_ignore": det_ignore,
                "num_gt": n_real,
            }
        return out

    def accumulate_and_summarize(
        self, verbose: bool = True, per_category: bool = False,
        category_names: Optional[Dict[int, str]] = None,
    ) -> Dict[str, float]:
        num_thr = len(IOU_THRS)
        precision = -np.ones((num_thr, len(RECALL_THRS), len(self.cat_ids), len(AREA_RANGES), len(MAX_DETS)))
        recall = -np.ones((num_thr, len(self.cat_ids), len(AREA_RANGES), len(MAX_DETS)))

        for ci, cat_id in enumerate(self.cat_ids):
            # one matching pass per (image, category) — served from the
            # update-time cache when available (matching then overlapped the
            # device stream); maxDet variants are prefix slices of the
            # per-image score-ordered detections
            results = []
            for img_id in self.img_ids:
                key = (img_id, cat_id)
                if key in self._match_cache:
                    r = self._match_cache[key]
                else:
                    r = self._evaluate_img(img_id, cat_id)
                if r is not None:
                    results.append(r)
            if not results:
                continue
            for ai, aname in enumerate(AREA_RANGES):
                num_gt = sum(r["by_area"][aname]["num_gt"] for r in results)
                if num_gt == 0:
                    continue
                for mi, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate(
                        [r["det_scores"][:max_det] for r in results])
                    matched = np.concatenate(
                        [r["by_area"][aname]["det_matched"][:, :max_det]
                         for r in results], axis=1)
                    ignored = np.concatenate(
                        [r["by_area"][aname]["det_ignore"][:, :max_det]
                         for r in results], axis=1)
                    order = np.argsort(-scores, kind="mergesort")
                    matched, ignored = matched[:, order], ignored[:, order]
                    tps = matched & ~ignored
                    fps = ~matched & ~ignored
                    tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                    rc_all = tp_cum / num_gt
                    pr_all = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
                    # monotone precision envelope, vectorized over thresholds
                    pr_env = np.maximum.accumulate(pr_all[:, ::-1], axis=1)[:, ::-1]
                    for t in range(num_thr):
                        rc, pr = rc_all[t], pr_env[t]
                        recall[t, ci, ai, mi] = rc[-1] if len(rc) else 0.0
                        inds = np.searchsorted(rc, RECALL_THRS, side="left")
                        valid = inds < len(pr)
                        q = np.zeros(len(RECALL_THRS))
                        q[valid] = pr[inds[valid]]
                        precision[t, :, ci, ai, mi] = q

        def _summary(ap=True, iou_thr=None, area="all", max_det=100):
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            if ap:
                s = precision[:, :, :, ai, mi]
            else:
                s = recall[:, :, ai, mi]
            if iou_thr is not None:
                t = int(np.where(np.isclose(IOU_THRS, iou_thr))[0][0])
                s = s[t : t + 1]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        stats = {
            "AP": _summary(True),
            "AP50": _summary(True, 0.5),
            "AP75": _summary(True, 0.75),
            "APs": _summary(True, area="small"),
            "APm": _summary(True, area="medium"),
            "APl": _summary(True, area="large"),
            "AR1": _summary(False, max_det=1),
            "AR10": _summary(False, max_det=10),
            "AR100": _summary(False),
            "ARs": _summary(False, area="small"),
            "ARm": _summary(False, area="medium"),
            "ARl": _summary(False, area="large"),
        }
        if verbose:
            for k, v in stats.items():
                print(f"{k:>6}: {v:.4f}")
        if per_category:
            # per-category AP/AR table (engine.py:148-176 parity)
            ai = list(AREA_RANGES).index("all")
            mi = MAX_DETS.index(100)
            rows = []
            for ci, cat_id in enumerate(self.cat_ids):
                p = precision[:, :, ci, ai, mi]
                r = recall[:, ci, ai, mi]
                ap = float(np.mean(p[p > -1])) if (p > -1).any() else float("nan")
                ar = float(np.mean(r[r > -1])) if (r > -1).any() else float("nan")
                name = (category_names or {}).get(cat_id, str(cat_id))
                rows.append((name, ap, ar))
                stats[f"AP_{name}"] = ap
            if verbose:
                width = max(len(n) for n, _, _ in rows)
                print(f"{'category':>{width}} | {'AP':>7} | {'AR':>7}")
                for name, ap, ar in rows:
                    print(f"{name:>{width}} | {ap:7.4f} | {ar:7.4f}")
        return stats
