"""The judgement of a served wave: the reference replays it and reads,
for every token the program served, how far that token's logit lies
below the reference's best at its position (its gap: 0 where the program
chose the reference's best).

The replay follows the engine's semantics (``moe_lm``): the wave's
prompts left-padded together, then one decode step a token, each row fed
the token the engine fed the program's model at that step: its served
token while it has one, and after that (a finished row still takes
decode steps) the engine's own next token, which with dropless experts
reaches no other row. The replay reads nothing of the program but those
tokens.

Where the pads' routing lies within ``PAD_TIE`` of a tie in some layers
(``moe_lm``), the wave is replayed on every branch of those layers' pad
choices, at most ``MAX_BRANCH_LAYERS`` of them, and judged by the branch
that agrees best.

``control_gaps`` reads, at the same positions of the same prompts and
tokens, the gap of the token that a second (lower precision) model puts
first: what the program would score had it been that model.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

# router logits of the pads' state this close to a tie between their
# K-th and (K+1)-th expert may order either way in bf16
PAD_TIE = 0.02
MAX_BRANCH_LAYERS = 3


def padded(prompts: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """(tokens, pad): the prompts left-padded with 0 to the longest, and
    where the pads are."""
    s = max(len(p) for p in prompts)
    out = np.zeros((len(prompts), s), np.int64)
    pad = np.ones((len(prompts), s), bool)
    for i, p in enumerate(prompts):
        out[i, s - len(p):] = p
        pad[i, s - len(p):] = False
    return out, pad


def _due(served, t):
    return [i for i, s in enumerate(served) if t < len(s)]


def replay(model, prompts, served, fed, device, logits_out):
    """Per-step logits of ``model`` over the wave, each decode step fed
    what the engine fed the program's model (``fed``: decode calls x
    rows). Calls ``logits_out(t, logits)`` with each step's (B, V) float32
    logits while a served token is due (t = 0: the prefill's last
    position)."""
    tokens, pad = (torch.as_tensor(a, device=device)
                   for a in padded(prompts))
    steps = max(len(s) for s in served)
    logits, cache = model.prefill(tokens, tokens.shape[1] + steps, pad)
    for t in range(steps):
        logits_out(t, logits)
        if t == steps - 1:
            break
        logits, cache = model.decode(
            cache, torch.as_tensor(fed[t], device=device).long())


def _gaps(model, prompts, served, fed, device, keep):
    out, kept = [], []

    def take(t, logits):
        rows = _due(served, t)
        tok = torch.tensor([int(served[i][t]) for i in rows],
                           device=logits.device)
        lg = logits[rows]
        g = lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]
        out.append(g.double().cpu().numpy())
        if keep:
            kept.append(logits[rows].clone())
    replay(model, prompts, served, fed, device, take)
    return np.concatenate(out), kept


def branches(model) -> list[frozenset]:
    """The pad routings to replay after a first prefill: every subset of
    the layers whose pad margin lies within ``PAD_TIE``."""
    near = sorted(i for i, m in model.pad_margin.items() if m < PAD_TIE)
    near = near[:MAX_BRANCH_LAYERS]
    return [frozenset(c) for n in range(1, len(near) + 1)
            for c in itertools.combinations(near, n)]


def gaps(model, prompts, served, fed, device, keep: bool = False):
    """(gaps, logits, branch) of the branch of the pads' routing that
    agrees best with what was served: every served token's gap, step by
    step in one float64 array, where ``keep`` each step's logits of the
    due rows on the device (what ``control_gaps`` reads), and the
    branch."""
    model.pad_flip = frozenset()
    best = _gaps(model, prompts, served, fed, device, keep) + (frozenset(),)
    for b in branches(model):
        model.pad_flip = b
        cand = _gaps(model, prompts, served, fed, device, keep) + (b,)
        if (cand[0] > 0).mean() < (best[0] > 0).mean():
            best = cand
    model.pad_flip = frozenset()
    return best


def control_gaps(control, ref_logits, prompts, served, fed, device, branch):
    """The reference's gap of the token ``control`` puts first, at every
    position where a served token is judged (the control on the
    reference's branch of the pads' routing)."""
    out = []
    control.pad_flip = branch

    def take(t, logits):
        rows = _due(served, t)
        ref = ref_logits[t]
        choice = torch.argmax(logits[rows], dim=-1)
        g = ref.max(-1).values - ref.gather(1, choice[:, None])[:, 0]
        out.append(g.double().cpu().numpy())
    replay(control, prompts, served, fed, device, take)
    return np.concatenate(out)


def well_formed(served: np.ndarray, max_new: int, eos: int) -> bool:
    """A served answer ends at its token budget or at its first eos."""
    n = len(served)
    if n == 0 or n > max_new:
        return False
    stops = np.flatnonzero(served == eos)
    if stops.size:
        return stops[0] == n - 1
    return n == max_new


def numbers(g: np.ndarray) -> dict:
    """The gap statistics of a wave's served tokens."""
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean()),
            "share_missed": float((g > 0).mean())}
