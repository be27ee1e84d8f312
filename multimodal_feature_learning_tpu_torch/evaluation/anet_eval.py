"""Dense-captioning evaluation on ActivityNet Captions.

The port's copy of the JAX package's ``evaluation/anet_eval.py`` (the
Krishna et al. ANETcaptions protocol): per tIoU threshold, match predicted
events to GT events by IoU, score matched caption pairs with
Bleu1-4/METEOR/ROUGE_L/CIDEr per video then average across videos; unmatched
predictions are scored against a random garbage string; detection
Recall/Precision per tIoU. Accepts an in-memory submission dict.

One difference: the garbage strings come from a ``random.Random`` the caller
passes (``rng``), not from the global ``random`` module. ``random.Random(s)``
draws the stream that ``random.seed(s)`` gives the global functions, so the
same seed gives the JAX copy's scores exactly.
"""

from __future__ import annotations

import json
import random
import string
from typing import Dict, List, Optional

import numpy as np

from .metrics import Bleu, Cider, Meteor, Rouge
from .tokenizer import PTBTokenizer


def random_string(n: int, rng: random.Random) -> str:
    return "".join(rng.choice(string.ascii_lowercase) for _ in range(n))


def remove_nonascii(text: str) -> str:
    return "".join(ch if ord(ch) < 128 else " " for ch in text)


def segment_iou(a, b) -> float:
    inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
    union = min(max(a[1], b[1]) - min(a[0], b[0]), (b[1] - b[0]) + (a[1] - a[0]))
    return float(inter) / (union + 1e-8)


class ANETCaptionsEvaluator:
    PREDICTION_FIELDS = ["results", "version", "external_data"]

    def __init__(
        self,
        ground_truths: List[Dict],
        prediction: Dict,
        tious: List[float],
        max_proposals: int = 1000,
        verbose: bool = False,
        only_proposals: bool = False,
        tokenizer=None,
        scorers=None,
        rng: Optional[random.Random] = None,
    ):
        """``rng`` draws the garbage references of unmatched predictions;
        ``None`` means ``random.Random(0)``."""
        if not tious:
            raise IOError("Please input a valid tIoU.")
        if not all(f in prediction for f in self.PREDICTION_FIELDS):
            raise IOError("Invalid submission format.")
        self.verbose = verbose
        self.tious = tious
        self.only_proposals = only_proposals
        self.ground_truths = ground_truths
        self.prediction = {
            vid: preds[:max_proposals] for vid, preds in prediction["results"].items()
        }
        self.tokenizer = tokenizer or PTBTokenizer()
        if only_proposals:
            self.scorers = []
        else:
            self.scorers = scorers or [
                (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
                (Meteor(), "METEOR"),
                (Rouge(), "ROUGE_L"),
                (Cider(), "CIDEr"),
            ]
        self.rng = random.Random(0) if rng is None else rng
        self.scores: Dict = {}

    def get_vid_ids(self):
        return list(self.prediction.keys())

    def evaluate(self) -> Dict:
        self.scores = {}
        if not self.only_proposals:
            for tiou in self.tious:
                tiou_scores = self.evaluate_tiou(tiou)
                for metric, score in tiou_scores.items():
                    self.scores.setdefault(metric, []).append(score)
        self.scores["Recall"] = []
        self.scores["Precision"] = []
        for tiou in self.tious:
            precision, recall = self.evaluate_detection(tiou)
            self.scores["Recall"].append(recall)
            self.scores["Precision"].append(precision)
            self.scores[f"Recall-{tiou}"] = recall
            self.scores[f"Precision-{tiou}"] = precision
        return self.scores

    def evaluate_detection(self, tiou: float):
        vid_ids = self.get_vid_ids()
        recall = np.zeros(len(vid_ids))
        precision = np.zeros(len(vid_ids))
        for vi, vid in enumerate(vid_ids):
            best_recall = 0.0
            best_precision = 0.0
            for gt in self.ground_truths:
                if vid not in gt:
                    continue
                refs = gt[vid]
                ref_covered = set()
                pred_covered = set()
                preds = self.prediction.get(vid, [])
                for pi, pred in enumerate(preds):
                    for ri, ref_ts in enumerate(refs["timestamps"]):
                        if segment_iou(pred["timestamp"], ref_ts) > tiou:
                            ref_covered.add(ri)
                            pred_covered.add(pi)
                if preds:
                    best_precision = max(best_precision, len(pred_covered) / len(preds))
                best_recall = max(best_recall, len(ref_covered) / len(refs["timestamps"]))
            recall[vi] = best_recall
            precision[vi] = best_precision
        return float(precision.mean()), float(recall.mean())

    def evaluate_tiou(self, tiou: float) -> Dict:
        vid_ids = self.get_vid_ids()
        vid2capid: Dict[str, List[int]] = {}
        cur_res: Dict[int, List[Dict]] = {}
        cur_gts: Dict[int, List[Dict]] = {}
        uid = 0

        for vid in vid_ids:
            vid2capid[vid] = []
            for pred in self.prediction.get(vid, []):
                has_added = False
                for gt in self.ground_truths:
                    if vid not in gt:
                        continue
                    refs = gt[vid]
                    for ci, ts in enumerate(refs["timestamps"]):
                        if segment_iou(pred["timestamp"], ts) >= tiou:
                            cur_res[uid] = [{"caption": remove_nonascii(pred["sentence"])}]
                            cur_gts[uid] = [{"caption": remove_nonascii(refs["sentences"][ci])}]
                            vid2capid[vid].append(uid)
                            uid += 1
                            has_added = True
                if not has_added:
                    # an unmatched prediction is scored against garbage
                    cur_res[uid] = [{"caption": remove_nonascii(pred["sentence"])}]
                    cur_gts[uid] = [{"caption": random_string(self.rng.randint(10, 20),
                                                              self.rng)}]
                    vid2capid[vid].append(uid)
                    uid += 1

        tokenize_res = self.tokenizer.tokenize(cur_res)
        tokenize_gts = self.tokenizer.tokenize(cur_gts)
        res = {v: {i: tokenize_res[i] for i in ids} for v, ids in vid2capid.items()}
        gts = {v: {i: tokenize_gts[i] for i in ids} for v, ids in vid2capid.items()}

        output: Dict = {}
        for scorer, method in self.scorers:
            all_scores = {}
            for vid in vid_ids:
                if len(res[vid]) == 0 or len(gts[vid]) == 0:
                    score = [0] * len(method) if isinstance(method, list) else 0
                else:
                    score, _ = scorer.compute_score(gts[vid], res[vid])
                all_scores[vid] = score
            if isinstance(method, list):
                means = np.mean(list(all_scores.values()), axis=0)
                for m, name in enumerate(method):
                    output[name] = float(means[m])
            else:
                output[method] = float(np.mean(list(all_scores.values())))
            if self.verbose:
                print(f"tIoU {tiou}: {method} -> {output}")
        return output


def run_eval(eval_cfg, submission_json: Dict, gt_json,
             rng: Optional[random.Random] = None) -> Dict:
    """Scores an in-memory submission against the ground truth.

    gt_json: a GT dict, a list of GT dicts, or path(s) to GT json files.
    rng: as ``ANETCaptionsEvaluator``'s."""
    if isinstance(gt_json, (str, list)) and gt_json and isinstance(
        gt_json if isinstance(gt_json, str) else gt_json[0], str
    ):
        paths = [gt_json] if isinstance(gt_json, str) else gt_json
        gts = []
        for p in paths:
            with open(p) as f:
                gts.append(json.load(f))
    elif isinstance(gt_json, dict):
        gts = [gt_json]
    else:
        gts = list(gt_json)
    evaluator = ANETCaptionsEvaluator(
        ground_truths=gts,
        prediction=submission_json,
        tious=list(eval_cfg.tious),
        max_proposals=eval_cfg.max_proposals_per_video,
        verbose=eval_cfg.verbose,
        rng=rng,
    )
    return evaluator.evaluate()
