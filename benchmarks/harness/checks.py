"""The numbers that decide `correct`, each held against its limit.

Training (the followed steps, which set-up drives through the timed
call): `loss_gap`, the largest |loss - reference loss| over the steps;
`grad_gap`, the first gradient as the optimizer holds it (the momentum
after step 1), and `update_gap`, the parameters' change over the followed
steps, each by its worst leaf: |norm - reference norm| over the larger
of the reference leaf's norm and the median leaf's. A leaf is a layer's
slice of a stacked weight, or `embed`, or `unembed`. Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of `update_gap`: they move by round-off alone. `grad_gap_median` and
`update_gap_median` are the median leaf's gaps. The reference of a block
that routes follows the program's routes (the definition's `new_routes`;
reference.Routes for the port's MoE); `route_gap` is the routes' `gap`,
for the port's MoE the widest margin by which the reference's router put
another expert first.

Scoring (the sampled requests, every position of every prompt):
`top1_gap`, the widest gap by which the reference's logit of the token
that the program puts first lies below the reference's best, and
`logprob_gap`, the largest |log p(next token)| difference from the
reference's; `top1_gap_mean` and `logprob_gap_mean`, their means over
every position, of each request, the largest over the requests.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict

import torch

QUIET_GRAD = 1e-3


@torch.no_grad()
def leaf_norms(flat: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Norm of each leaf; a stacked `layers.*` weight gives one per layer
    (`layers.wq.3`)."""
    out: Dict[str, float] = {}
    for name, t in flat.items():
        if name.startswith("layers."):
            norms = t.detach().float().flatten(1).norm(dim=1).tolist()
            out.update({f"{name}.{i}": v for i, v in enumerate(norms)})
        else:
            out[name] = t.detach().float().norm().item()
    return out


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              leaves) -> Dict[str, float]:
    """|norm - reference norm| over the larger of the reference leaf's
    norm and the median leaf's, per leaf (NaN read as inf)."""
    floor = median(ref[k] for k in leaves)
    gaps = {k: abs(got[k] - ref[k]) / max(ref[k], floor, 1e-30)
            for k in leaves}
    return {k: (math.inf if g != g else g) for k, g in gaps.items()}


def moving(ref: dict):
    """Leaves whose reference gradient is not nought to rounding."""
    floor = median(ref["grad"].values())
    return [k for k, v in ref["grad"].items() if v >= QUIET_GRAD * floor]


def train_numbers(got: dict, ref: dict) -> Dict[str, float]:
    """got, ref: {"losses": [3 floats], "grad": leaf norms, "update": leaf
    norms}."""
    loss_gap = max(abs(a - b) for a, b in zip(got["losses"], ref["losses"]))
    if any(v != v for v in got["losses"]):        # NaN
        loss_gap = float("inf")
    grad = leaf_gaps(got["grad"], ref["grad"], ref["grad"])
    update = leaf_gaps(got["update"], ref["update"], moving(ref))
    numbers = {"loss_gap": loss_gap,
               "grad_gap": max(grad.values()),
               "update_gap": max(update.values()),
               "grad_gap_median": median(grad.values()),
               "update_gap_median": median(update.values())}
    if "route_gap" in ref:
        numbers["route_gap"] = ref["route_gap"]
    return numbers


def worst_leaves(got: dict, ref: dict, n: int = 4) -> Dict[str, list]:
    """The n leaves with the widest grad and update gaps, widest first."""
    out = {}
    for part, leaves in (("grad", list(ref["grad"])), ("update", moving(ref))):
        gaps = leaf_gaps(got[part], ref[part], leaves)
        out[part] = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return out


@torch.no_grad()
def answer(logits: torch.Tensor, tokens: torch.Tensor):
    """What a scoring request's answer is judged by: the token put first
    at each position (int32), and log p of each next prompt token."""
    top = logits.argmax(-1).int()
    lse = torch.logsumexp(logits[:, :-1], -1)
    picked = logits[:, :-1].gather(-1, tokens[:, 1:, None].long())[..., 0]
    return top, picked - lse


@torch.no_grad()
def score_numbers(top: torch.Tensor, logprob: torch.Tensor,
                  ref_logits: torch.Tensor, tokens: torch.Tensor
                  ) -> Dict[str, float]:
    best = ref_logits.max(-1).values
    below = best - ref_logits.gather(-1, top.long()[..., None])[..., 0]
    _, ref_logprob = answer(ref_logits, tokens)
    off = (logprob - ref_logprob).abs()
    return {"top1_gap": below.max().item(),
            "top1_gap_mean": below.mean().item(),
            "logprob_gap": off.max().item(),
            "logprob_gap_mean": off.mean().item()}


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> bool:
    """Every number that the cell's limits name is there and within its
    limit; a cell without limits is never correct. A number without a
    limit is reported and not judged (PERF.md says why for each)."""
    return bool(limits) and all(
        name in numbers and numbers[name] <= lim["limit"]
        for name, lim in limits.items())
