"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``reference/``), number by number, each
against its limit (``limits/<workload>.json``).

Serving, for a sample of the answered requests (drawn from the seed, with
the request of the most served tokens in it), from one reference pass over
their features:

* ``k_gap``: by how much the count head's best class lies above the best
  class that gives the program's event count (0 where they agree);
* ``score_gap``: the widest distance between the program's event scores
  and the reference's scores of the same rank (sorted, so a swap of two
  tied events costs nothing), as a share of the reference's largest score
  magnitude;
* ``segment_gap``: the widest distance from a served segment to the nearest
  of the reference's top events' segments, as a share of the duration;
* ``token_gap``: the widest gap by which a served caption token's logit lies
  below the reference's best logit at its position, the reference run over
  the prompt with the served tokens (teacher forced), up to each caption's
  first <eos>.

Training, over the first three steps, which set-up ran through the timed
path's own call and feed: ``loss_gap``, the relative gap between the
program's and the reference's loss of the first step; ``grad_gap``, by the
worst parameter, the gap between the norms of the program's and the
reference's first gradient as the optimizer got it (its first moment
after step 1 over 1 - beta1), against the larger of the reference's norm
of that parameter and of the median parameter; ``change_gap``, the same
gap of the parameters' change over the three steps, of the median
parameter, over the parameters whose reference gradient is at least a
thousandth of the median parameter's (those below move by round-off alone
under AdamW). The later steps' losses and the worst parameter's change are
kept beside them, not compared: AdamW moves an element by about the rate
whatever its gradient, so the elements whose gradient is at rounding
level on both sides take opposite steps, and those numbers swing with
them (PERF.md).
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch

BETA1 = 0.9
EOS = 3


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def print_checks(checks: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()


def count_gap(count: torch.Tensor, k: int, G: int) -> float:
    """The count head's best class above the best class that the port's
    ``argmax().clamp(1, G)`` maps to ``k``."""
    classes = torch.arange(count.shape[0], device=count.device).clamp(1, G)
    return float(count.max() - count[classes == k].max())


def sample_requests(records: List[dict], n: int, seed: int) -> List[dict]:
    """``n`` answered requests drawn from the seed, with the one of the
    most served tokens first."""
    answered = [r for r in records if r.get("events")]
    if not answered:
        return []
    tokens = [sum(int((np.asarray(e["caption"]) != 1).sum()) for e in r["events"])
              for r in answered]
    first = int(np.argmax(tokens))
    rest = [i for i in range(len(answered)) if i != first]
    picked = np.random.default_rng(seed).choice(rest, size=min(n - 1, len(rest)),
                                                replace=False) if rest else []
    return [answered[first]] + [answered[i] for i in picked]


def serve_numbers(model, ref: dict, answers: List[list], device) -> Dict[str, float]:
    """The four serving numbers of ``answers`` (each request's events as the
    server gave them) against the reference outputs ``ref`` of
    ``reference.run.serve_outputs`` on the same requests; also returns the
    reference's logits (for the control) under ``_logits``."""
    from .reference.run import caption_logits

    G = model.max_gt
    B = len(answers)
    k_gap = score_gap = seg_gap = 0.0
    S = ref["memory"].shape[1]
    crop = torch.ones((B, G, S), dtype=torch.bool, device=device)
    tokens = torch.full((B, G, model.seq_len + 1), 1, dtype=torch.long, device=device)
    tokens[:, :, 0] = model.bos_idx
    scale = float(ref["scores"].abs().max())
    for b, events in enumerate(answers):
        k = len(events)
        k_gap = max(k_gap, count_gap(ref["count"][b], k, G))
        top = ref["order"][b]
        ref_scores = ref["scores"][b, top]
        ref_segs = ref["segments"][b, top]  # (G, 2)
        dur = float(ref["durations"][b])
        for j, e in enumerate(events):
            seg = torch.tensor(e["segment"], dtype=torch.float32, device=device)
            dist = (ref_segs - seg).abs().amax(dim=1)
            q = int(dist.argmin())
            seg_gap = max(seg_gap, float(dist[q]) / dur)
            score_gap = max(score_gap, abs(e["score"] - float(ref_scores[j])) / scale)
            crop[b, j] = ref["crop"][b, q]
            tokens[b, j] = torch.tensor(e["caption"], dtype=torch.long, device=device)
    logits = caption_logits(model, ref["memory"], crop, tokens)  # (B, G, Lc-1, V)
    served = tokens[:, :, 1:model.seq_len]                         # (B, G, Lc-1)
    live = _live(served, answers, G)
    gaps = logits.max(dim=-1).values - logits.gather(-1, served[..., None])[..., 0]
    token_gap = float(gaps[live].max()) if live.any() else 0.0
    return {"k_gap": k_gap, "score_gap": score_gap, "segment_gap": seg_gap,
            "token_gap": token_gap, "tokens_compared": int(live.sum()),
            "_logits": logits, "_live": live, "_served": served, "_tokens": tokens,
            "_crop": crop}


def _live(served: torch.Tensor, answers: List[list], G: int) -> torch.Tensor:
    """(B, G, Lc-1) True at the positions the greedy decode chose: the
    returned events' positions up to and including their first <eos>."""
    B, _, T = served.shape
    k = torch.tensor([len(a) for a in answers], device=served.device)
    real = torch.arange(G, device=served.device)[None, :] < k[:, None]
    eos = (served == EOS).int()
    before = (eos.cumsum(dim=-1) - eos) == 0  # no <eos> before this position
    return real[..., None] & before


def control_token_gap(ref_numbers: dict, control_logits: torch.Tensor) -> float:
    """The control's token reading: at each compared position, the gap in
    the reference's logits of the token the control puts first."""
    logits, live = ref_numbers["_logits"], ref_numbers["_live"]
    pick = control_logits.argmax(dim=-1, keepdim=True)
    gaps = logits.max(dim=-1).values - logits.gather(-1, pick)[..., 0]
    return float(gaps[live].max()) if live.any() else 0.0


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names) -> Dict[str, float]:
    """{leaf: |‖prog‖ - ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖)}."""
    ref_norms = {n: float(ref[n].float().norm()) for n in names}
    median = float(np.median(list(ref_norms.values())))
    return {n: abs(float(prog[n].float().norm()) - ref_norms[n]) / max(ref_norms[n], median)
            for n in names}


def train_numbers(prog: dict, ref: dict, p0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The three training numbers: ``prog`` and ``ref`` hold ``losses``,
    ``moments`` (first moments after step 1) and ``params`` (after the
    last step); ``p0`` the parameters both started from. Beside them, for
    the record: every step's loss gap, the worst leaf's change gap and
    which leaves were worst, and the share of elements whose first
    gradient has opposite signs on the two sides."""
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    # a parameter the program's optimizer holds no moment of took no step
    grads_r = {n: m / (1 - BETA1) for n, m in ref["moments"].items()}
    grads_p = {n: prog["moments"][n] / (1 - BETA1) if n in prog["moments"]
               else torch.zeros_like(g) for n, g in grads_r.items()}
    grad = leaf_gaps(grads_p, grads_r, grads_r)
    norms = {n: float(g.norm()) for n, g in grads_r.items()}
    median = float(np.median(list(norms.values())))
    moved = [n for n, v in norms.items() if v >= 1e-3 * median]
    change = leaf_gaps({n: prog["params"][n] - p0[n] for n in moved},
                       {n: ref["params"][n] - p0[n] for n in moved}, moved)
    flips = sum(int(((grads_p[n] > 0) != (grads_r[n] > 0)).sum()) for n in grads_r)
    terms = {k: abs(prog["terms"][k] - v) / max(abs(v), 1e-30)
             for k, v in ref.get("terms", {}).items() if k in prog.get("terms", {})}
    elements = sum(g.numel() for g in grads_r.values())
    return {"loss_gap": loss_gaps[0], "grad_gap": max(grad.values()),
            "change_gap": float(np.median(list(change.values()))),
            "loss_gaps": loss_gaps, "losses": list(prog["losses"]),
            "change_gap_worst": max(change.values()),
            "grad_leaf": max(grad, key=grad.get), "change_leaf": max(change, key=change.get),
            "sign_flip_share": flips / elements, "first_step_term_gaps": terms,
            "leaves_compared": len(moved), "leaves": len(norms)}
