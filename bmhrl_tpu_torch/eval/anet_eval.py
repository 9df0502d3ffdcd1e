"""ActivityNet dense-captioning evaluator (the port's copy of
bmhrl_tpu/eval/anet_eval.py, after the Krishna et al. evaluator): a
prediction matches the reference segments it overlaps by interval IoU, a
prediction that overlaps none is scored against a random string, metrics
average per video and then across videos, and segment-detection
precision and recall come per tIoU. Every scorer is this package's own.
"""
from __future__ import annotations

import json
import random
import string
from typing import Dict, List, Sequence

import numpy as np

from bmhrl_tpu_torch.eval.meteor import Meteor
from bmhrl_tpu_torch.eval.metrics import Bleu, Cider, Rouge
from bmhrl_tpu_torch.eval.ptb_tokenizer import PTBTokenizer

PREDICTION_FIELDS = ["results", "version", "external_data"]


def _random_string(n: int) -> str:
    return "".join(random.choice(string.ascii_lowercase) for _ in range(n))


def _remove_nonascii(text: str) -> str:
    return "".join(c if ord(c) < 128 else " " for c in text)


def interval_iou(a, b) -> float:
    s1, e1 = a
    s2, e2 = b
    inter = max(0.0, min(e1, e2) - max(s1, s2))
    union = min(max(e1, e2) - min(s1, s2), (e2 - s2) + (e1 - s1))
    return float(inter) / (union + 1e-8)


class ANETCaptionsEvaluator:
    def __init__(
        self,
        ground_truth_filenames: Sequence[str],
        prediction_filename_or_dict,
        tious: Sequence[float],
        max_proposals: int = 1000,
        verbose: bool = False,
        only_proposals: bool = False,
        meteor_preset: str = "nltk",
        meteor_paraphrase_path=None,
    ):
        if not tious:
            raise ValueError("need at least one tIoU")
        self.tious = list(tious)
        self.verbose = verbose
        self.only_proposals = only_proposals
        self.ground_truths = [json.load(open(f)) for f in ground_truth_filenames]
        if isinstance(prediction_filename_or_dict, str):
            submission = json.load(open(prediction_filename_or_dict))
        else:
            submission = prediction_filename_or_dict
        if not all(f in submission for f in PREDICTION_FIELDS):
            raise ValueError("invalid submission fields")
        self.prediction = {
            vid: props[:max_proposals]
            for vid, props in submission["results"].items()
        }
        self.tokenizer = PTBTokenizer()
        self.scorers = [] if only_proposals else [
            (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
            (Meteor(meteor_preset, paraphrase_path=meteor_paraphrase_path),
             "METEOR"),
            (Rouge(), "ROUGE_L"),
            (Cider(), "CIDEr"),
        ]
        self.scores: Dict[str, List[float]] = {}

    def _gt_vid_ids(self) -> List[str]:
        ids = set()
        for gt in self.ground_truths:
            ids |= set(gt.keys())
        return list(ids)

    # -- detection precision/recall -----------------------------------------
    def evaluate_detection(self, tiou: float):
        vid_ids = self._gt_vid_ids()
        recall = np.zeros(len(vid_ids))
        precision = np.zeros(len(vid_ids))
        for vi, vid in enumerate(vid_ids):
            best_r = best_p = 0.0
            for gt in self.ground_truths:
                if vid not in gt:
                    continue
                refs = gt[vid]
                ref_cov, pred_cov = set(), set()
                preds = self.prediction.get(vid, [])
                for pi, pred in enumerate(preds):
                    for ri, rts in enumerate(refs["timestamps"]):
                        if interval_iou(pred["timestamp"], rts) > tiou:
                            ref_cov.add(ri)
                            pred_cov.add(pi)
                if preds:
                    best_p = max(best_p, len(pred_cov) / len(preds))
                best_r = max(best_r, len(ref_cov) / len(refs["timestamps"]))
            recall[vi] = best_r
            precision[vi] = best_p
        return float(precision.mean()), float(recall.mean())

    # -- captioning at one tIoU ---------------------------------------------
    def evaluate_tiou(self, tiou: float) -> Dict[str, float]:
        vid_ids = self._gt_vid_ids()
        vid2capid: Dict[str, List[int]] = {}
        cur_res: Dict[int, List[Dict[str, str]]] = {}
        cur_gts: Dict[int, List[Dict[str, str]]] = {}
        uid = 0
        for vid in vid_ids:
            vid2capid[vid] = []
            for pred in self.prediction.get(vid, []):
                added = False
                for gt in self.ground_truths:
                    if vid not in gt:
                        continue
                    caps = gt[vid]
                    for ci, cts in enumerate(caps["timestamps"]):
                        if interval_iou(pred["timestamp"], cts) >= tiou:
                            cur_res[uid] = [
                                {"caption": _remove_nonascii(pred["sentence"])}]
                            cur_gts[uid] = [
                                {"caption": _remove_nonascii(caps["sentences"][ci])}]
                            vid2capid[vid].append(uid)
                            uid += 1
                            added = True
                if not added:  # garbage reference for unmatched predictions
                    cur_res[uid] = [
                        {"caption": _remove_nonascii(pred["sentence"])}]
                    cur_gts[uid] = [
                        {"caption": _random_string(random.randint(10, 20))}]
                    vid2capid[vid].append(uid)
                    uid += 1

        tok_res = self.tokenizer.tokenize(cur_res)
        tok_gts = self.tokenizer.tokenize(cur_gts)

        output: Dict[str, float] = {}
        for scorer, method in self.scorers:
            all_scores = {}
            for vid in vid_ids:
                res_v = {i: tok_res[i] for i in vid2capid[vid]}
                gts_v = {i: tok_gts[i] for i in vid2capid[vid]}
                if not res_v:
                    score = [0] * len(method) if isinstance(method, list) else 0
                else:
                    score, _ = scorer.compute_score(gts_v, res_v)
                all_scores[vid] = score
            if isinstance(method, list):
                means = np.mean(list(all_scores.values()), axis=0)
                for mi, m in enumerate(method):
                    output[m] = float(means[mi])
            else:
                output[method] = float(np.mean(list(all_scores.values())))
        return output

    def evaluate(self) -> Dict[str, List[float]]:
        self.scores = {}
        if not self.only_proposals:
            for tiou in self.tious:
                for metric, score in self.evaluate_tiou(tiou).items():
                    self.scores.setdefault(metric, []).append(score)
        self.scores["Recall"] = []
        self.scores["Precision"] = []
        for tiou in self.tious:
            p, r = self.evaluate_detection(tiou)
            self.scores["Precision"].append(p)
            self.scores["Recall"].append(r)
        return self.scores


def calculate_metrics(
    reference_paths: Sequence[str],
    submission,
    tious: Sequence[float],
    max_prop_per_vid: int = 100,
    verbose: bool = True,
    meteor_preset: str = "nltk",
    meteor_paraphrase_path=None,
) -> Dict:
    """Score a submission against the reference files at each tIoU; adds
    the "Average across tIoUs" entry."""
    ev = ANETCaptionsEvaluator(
        reference_paths, submission, tious, max_prop_per_vid,
        verbose=verbose, meteor_preset=meteor_preset,
        meteor_paraphrase_path=meteor_paraphrase_path)
    ev.evaluate()
    metrics: Dict = {}
    for i, tiou in enumerate(tious):
        metrics[tiou] = {m: ev.scores[m][i] for m in ev.scores}
    metrics["Average across tIoUs"] = {
        m: sum(s) / float(len(s)) for m, s in ev.scores.items()}
    return metrics
