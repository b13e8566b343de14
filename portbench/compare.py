"""The numbers that decide ``correct``: what the program produced against
the plain reference, each a gap as a share of the reference's scale.

Training (a run's first three steps, through the window's own call):

* ``loss_gap``: the largest ``|loss - reference loss| / |reference loss|``
  over the steps.
* ``grad_gap``: over the leaves, the largest gap between the program's
  and the reference's norm of the first step's gradient as the optimizer
  got it (clipped), over the larger of the reference leaf's norm and the
  median leaf's.
* ``change_gap``: the same for each leaf's change over the steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf that the loss does not move, such as one under a
  softmax shift, moves under AdamW by round-off alone).

Serving: ``logit_gap``, the widest gap by which a served token's
reference logit lies below the reference's best at its position, and
``logit_gap_mean``, that gap's mean over every served position.

A cell's ``limits`` name the numbers it compares: those that its control
or a fault reads well above its sound runs (PERF.md gives the readings).
``loss_gap`` and ``logit_gap`` are computed and printed, not compared.
"""

from __future__ import annotations

import statistics

import torch


def _leaf_gaps(program: dict, reference: dict, names) -> float:
    median = statistics.median(reference[n] for n in reference)
    return max(abs(program[n] - reference[n]) / max(reference[n], median, 1e-30)
               for n in names)


def training_gaps(program: dict, reference: dict) -> dict:
    """``program`` and ``reference`` each hold ``losses`` (a list),
    ``first_grad`` and ``change`` (leaf name -> norm)."""
    losses = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"]))
    grads = reference["first_grad"]
    floor = 1e-3 * statistics.median(grads.values())
    moving = [n for n in grads if grads[n] >= floor]
    return {"loss_gap": losses,
            "grad_gap": _leaf_gaps(program["first_grad"], grads, grads),
            "change_gap": _leaf_gaps(program["change"], reference["change"], moving)}


def logit_gaps(reference_logits: list, tokens: list) -> dict:
    """``reference_logits[j]`` [n_j, V] at the positions that chose
    ``tokens[j]`` [n_j]: the widest ``max - logit[token]`` (``logit_gap``)
    and its mean over every position (``logit_gap_mean``)."""
    gaps = []
    for logits, toks in zip(reference_logits, tokens):
        toks = toks.to(logits.device).long()
        gaps.append(logits.max(-1).values - logits.gather(1, toks[:, None])[:, 0])
    every = torch.cat(gaps)
    return {"logit_gap": float(every.max()), "logit_gap_mean": float(every.mean())}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a missing or non-finite number fails)."""
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= limits[k]
               for k in limits)


def check_lines(numbers: dict, limits: dict) -> dict:
    """``{name: {"value": number, "limit": limit}}``, the result line's last key."""
    return {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
