"""The comparison that decides ``correct``.

Once the window has closed, a sample of the requests it finished, drawn
from the seed and holding one of the longest prompts, is run through the
plain reference (``reference/<name>.py``): one float32 forward over each
prompt followed by its served tokens.  At every served position the
reference's logit of the served token is compared with the reference's
best logit there; the widest such gap over the sample is the number held
to the cell's limit.  The first served token comes from the prefill, the
rest from decode steps through the cache, so the gap covers both.  Greedy
decoding serves the argmax, so a sound bf16 program loses only near-ties.

The control (``control_gap``) puts the reference itself, computed on
float8-rounded operands, in the program's place: at each position of the
same sequences, the gap of the token that the float8 forward puts first.
Both readings are judged by ``judge``, against the cell's limits.
"""
from __future__ import annotations

import random
from dataclasses import dataclass

from ecobench.traffic import subseed


@dataclass
class Sample:
    batch: int  # index into the window's batches
    row: int
    prompt_len: int


def sample_requests(batches, n: int, seed: int) -> list[Sample]:
    """``n`` finished requests (fewer if fewer finished), drawn from the
    seed; the first is a request of the longest prompt length."""
    rng = random.Random(subseed(seed, "check"))
    every = [(i, r) for i, b in enumerate(batches) for r in range(b.B)]
    longest = max(b.S for b in batches)
    first = rng.choice([(i, r) for i, r in every
                        if batches[i].S == longest])
    rest = rng.sample([x for x in every if x != first],
                      min(n, len(every)) - 1)
    return [Sample(i, r, batches[i].S) for i, r in [first, *rest]]


def judge(reading: dict, limits: dict) -> tuple[bool, dict]:
    """Whether ``reading`` (``served_gap``'s or ``control_gap``'s) is
    correct under ``limits`` (``cells/<cell>.json``), and each number
    compared beside its limit."""
    checks = {name: {"value": reading[name], "limit": lim["limit"]}
              for name, lim in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def sequence(torch, batch, row: int):
    """The prompt and the served tokens fed back: every position whose
    logits chose a served token."""
    return torch.cat([batch.prompts[row], batch.answers[row, :-1]])


def served_gap(torch, ref, w, c, batches, samples) -> dict:
    """The widest gap, over the sampled requests' served tokens, between
    the reference's best logit and its logit of the served token."""
    worst, tokens = 0.0, 0
    for s in samples:
        b = batches[s.batch]
        lg = ref.logits(w, c, sequence(torch, b, s.row), s.prompt_len - 1)
        served = b.answers[s.row].to(lg.device)
        gap = lg.max(-1).values - lg.gather(1, served[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        tokens += served.numel()
        del lg
    return {"max_gap": worst, "requests": len(samples), "tokens": tokens}


def control_gap(torch, ref, w, c, batches, samples) -> dict:
    """The control's widest gap: at each served position of the sampled
    sequences, the float32 reference's best logit less its logit of the
    token the float8 forward puts first."""
    worst, tokens = 0.0, 0
    for s in samples:
        seq = sequence(torch, batches[s.batch], s.row)
        exact = ref.logits(w, c, seq, s.prompt_len - 1)
        low = ref.logits(w, c, seq, s.prompt_len - 1, precision="fp8")
        pick = low.argmax(-1, keepdim=True)
        gap = exact.max(-1).values - exact.gather(1, pick)[:, 0]
        worst = max(worst, float(gap.max()))
        tokens += pick.numel()
        del exact, low
    return {"max_gap": worst, "requests": len(samples), "tokens": tokens}
