"""The one traffic generator: a closed loop of static batches, read from a
mix file (``traffic/<mix>.json``).

A mix gives the batch, the prompt-length buckets and the answer length.
The loop sends a batch of ``batch`` prompts, all of one bucket's length,
and sends the next when every request of the previous one has its answer.
Buckets come in cycles: each cycle holds every bucket once, in an order
drawn from the seed, so every whole cycle carries the same work and a seed
changes only the order.  Prompt tokens are drawn on the device from the
seed, uniformly over the vocabulary, in the order the batches are sent.
"""
from __future__ import annotations

import hashlib
import json
import random
from dataclasses import dataclass
from pathlib import Path


def subseed(seed: int, what: str) -> int:
    """A 63-bit seed for one purpose, derived from the run's seed (any
    whole number)."""
    digest = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclass(frozen=True)
class Mix:
    batch: int
    prompt_buckets: tuple[int, ...]
    answer_tokens: int
    check_requests: int

    @property
    def capacity(self) -> int:
        """Cache positions a batch may fill: the longest prompt and its
        answer."""
        return max(self.prompt_buckets) + self.answer_tokens

    def cycle_order(self, seed: int, cycle: int) -> list[int]:
        """The prompt lengths of cycle ``cycle``, one batch each."""
        order = list(self.prompt_buckets)
        random.Random(subseed(seed, f"cycle{cycle}")).shuffle(order)
        return order


def load_mix(path: Path) -> Mix:
    spec = json.loads(Path(path).read_text())
    if spec.get("loop") != "closed":
        raise ValueError(f"{path}: only the closed loop of static batches "
                         f"is generated, got {spec.get('loop')!r}")
    buckets = tuple(int(s) for s in spec["prompt_buckets"])
    if not buckets or min(buckets) < 1 or int(spec["batch"]) < 1 or \
            int(spec["answer_tokens"]) < 1:
        raise ValueError(f"{path}: empty or non-positive sizes")
    return Mix(batch=int(spec["batch"]),
               prompt_buckets=buckets,
               answer_tokens=int(spec["answer_tokens"]),
               check_requests=int(spec["check_requests"]))


class PromptSource:
    """Prompts drawn batch after batch on ``device`` from one generator
    seeded from the run's seed and a purpose (the window's prompts, or the
    warm-up's, which then leave the window's untouched)."""

    def __init__(self, torch, seed: int, vocab: int, device,
                 what: str = "prompts"):
        self.torch, self.vocab, self.device = torch, vocab, device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(subseed(seed, what))

    def batch(self, B: int, S: int):
        return self.torch.randint(0, self.vocab, (B, S), generator=self.gen,
                                  device=self.device, dtype=self.torch.int64)
