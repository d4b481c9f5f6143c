"""Domain corpora + query datasets (the paper's Context Generator, §3.2.3).

Each domain gets a synthetic technical corpus (documents made of chunks, each
chunk carrying identifiable facts) and a query set covering the paper's six
query types: retrieval / explanation / analysis / solving / comparison /
recommendation.  Every query records its ground-truth relevant chunks,
reference answer, complexity, and ambiguity — the metadata (T_i, C_i, E_i)
the paper attaches for automated evaluation.

Domain profiles encode the paper's qualitative findings: automotive is
retrieval-heavy with precise queries; smart home is ambiguous and
reasoning-heavy (where model routing alone fails, Table 4); TechQA has long
documents (driving long prompts and 20s+ baseline latencies); etc.
"""
from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.text import embed_batch

QUERY_TYPES = ("retrieval", "explanation", "analysis", "solving", "comparison", "recommendation")


@dataclass(frozen=True)
class DomainProfile:
    name: str
    n_docs: int
    chunks_per_doc: int
    chunk_words: int  # document verbosity -> prompt length pressure
    ambiguity: float  # [0,1] how underspecified queries are (smart home high)
    reasoning_weight: float  # how much multi-step reasoning matters
    retrieval_weight: float  # how much grounding in docs matters
    distractor_rate: float  # near-duplicate facts confusing retrieval
    type_mix: dict[str, float] = field(default_factory=dict)


DOMAIN_PROFILES: dict[str, DomainProfile] = {
    "automotive": DomainProfile(
        "automotive", n_docs=60, chunks_per_doc=24, chunk_words=90,
        ambiguity=0.15, reasoning_weight=0.35, retrieval_weight=0.95,
        distractor_rate=0.25,
        type_mix={"retrieval": 0.3, "solving": 0.25, "explanation": 0.15,
                  "analysis": 0.1, "comparison": 0.1, "recommendation": 0.1},
    ),
    "smarthome": DomainProfile(
        "smarthome", n_docs=36, chunks_per_doc=12, chunk_words=60,
        ambiguity=0.75, reasoning_weight=0.85, retrieval_weight=0.45,
        distractor_rate=0.35,
        type_mix={"retrieval": 0.15, "solving": 0.25, "explanation": 0.2,
                  "analysis": 0.2, "comparison": 0.05, "recommendation": 0.15},
    ),
    "agriculture": DomainProfile(
        "agriculture", n_docs=40, chunks_per_doc=14, chunk_words=70,
        ambiguity=0.3, reasoning_weight=0.5, retrieval_weight=0.7,
        distractor_rate=0.2,
        type_mix={"retrieval": 0.25, "solving": 0.2, "explanation": 0.2,
                  "analysis": 0.15, "comparison": 0.1, "recommendation": 0.1},
    ),
    "techqa": DomainProfile(
        "techqa", n_docs=50, chunks_per_doc=30, chunk_words=140,
        ambiguity=0.45, reasoning_weight=0.7, retrieval_weight=0.85,
        distractor_rate=0.45,
        type_mix={"retrieval": 0.2, "solving": 0.3, "explanation": 0.2,
                  "analysis": 0.15, "comparison": 0.05, "recommendation": 0.1},
    ),
    "iot_security": DomainProfile(
        "iot_security", n_docs=42, chunks_per_doc=16, chunk_words=80,
        ambiguity=0.35, reasoning_weight=0.6, retrieval_weight=0.75,
        distractor_rate=0.3,
        type_mix={"retrieval": 0.25, "solving": 0.2, "explanation": 0.2,
                  "analysis": 0.2, "comparison": 0.05, "recommendation": 0.1},
    ),
}

ALL_DOMAINS = tuple(DOMAIN_PROFILES)

_NOUNS = {
    "automotive": ["brake", "sensor", "torque", "injector", "coolant", "alternator",
                   "battery", "abs", "airbag", "throttle", "camshaft", "diagnostic"],
    "smarthome": ["thermostat", "bulb", "hub", "scene", "routine", "lock", "camera",
                  "motion", "zigbee", "schedule", "dimmer", "speaker"],
    "agriculture": ["irrigation", "nitrogen", "seeder", "harvester", "soil", "yield",
                    "pesticide", "drainage", "tractor", "silage", "crop", "moisture"],
    "techqa": ["cluster", "daemon", "socket", "kernel", "firmware", "driver", "raid",
               "vlan", "hypervisor", "certificate", "registry", "scheduler"],
    "iot_security": ["firewall", "firmware", "botnet", "telemetry", "certificate",
                     "gateway", "encryption", "vlan", "credential", "exploit",
                     "patch", "audit"],
}

def nouns_for(domain: str, rng: random.Random) -> list[str]:
    return _NOUNS[domain]


_VERBS = ["configure", "reset", "calibrate", "inspect", "replace", "monitor",
          "diagnose", "update", "isolate", "schedule", "verify", "restore"]

_TEMPLATES = {
    "retrieval": "what is the {n1} {n2} specification for unit {fid}",
    "explanation": "why does the {n1} {n2} warning appear after {v1} of {fid}",
    "analysis": "what are the implications if the {n1} {n2} persists despite {v1} and {v2} on {fid}",
    "solving": "how do i {v1} the {n1} {n2} fault on {fid} step by step",
    "comparison": "should i {v1} or {v2} the {n1} {n2} for {fid}",
    "recommendation": "how should i {v1} {n1} {n2} to optimize {n3} under constraint {fid}",
}

_AMBIGUOUS_TEMPLATES = {
    "retrieval": "{n1} {fid} info",
    "explanation": "{n1} not working right {fid}",
    "analysis": "{n1} acting weird sometimes {fid}",
    "solving": "fix {n1} {fid}",
    "comparison": "{n1} or {n2} {fid}",
    "recommendation": "best {n1} setup {fid}",
}

# how much each query type leans on retrieval vs reasoning (mirrors the
# paper's taxonomy: retrieval questions need facts, analysis needs reasoning)
TYPE_NEEDS = {
    "retrieval": {"retrieval": 1.0, "reasoning": 0.2, "complexity": 0.2},
    "explanation": {"retrieval": 0.7, "reasoning": 0.5, "complexity": 0.45},
    "analysis": {"retrieval": 0.6, "reasoning": 0.95, "complexity": 0.8},
    "solving": {"retrieval": 0.8, "reasoning": 0.7, "complexity": 0.6},
    "comparison": {"retrieval": 0.5, "reasoning": 0.75, "complexity": 0.55},
    "recommendation": {"retrieval": 0.45, "reasoning": 0.9, "complexity": 0.75},
}


@dataclass
class Chunk:
    doc_id: int
    chunk_id: int  # global id
    text: str  # full body (token accounting / prompt length)
    index_text: str  # short heading indexed by the vector store
    fact_ids: tuple[int, ...]


@dataclass
class Query:
    qid: int
    text: str
    qtype: str
    relevant_chunks: tuple[int, ...]  # ground-truth chunk ids
    reference: str  # reference answer text
    complexity: float
    ambiguity: float
    prompt_words: int  # words the raw query contributes


@dataclass
class DomainData:
    profile: DomainProfile
    chunks: list[Chunk]
    queries: list[Query]
    chunk_embeddings: np.ndarray  # (n_chunks, d)
    query_embeddings: np.ndarray  # (n_queries, d)

    @property
    def name(self) -> str:
        return self.profile.name


def _make_chunk_text(rng: random.Random, domain: str, fact_id: int, words: int,
                     fact_mentions: int = 4) -> str:
    """Manual-style chunk: a recurring part/fault identifier (the retrieval
    signal) over diverse filler prose (so chunks are distinguishable — a tiny
    shared vocabulary would make every chunk look identical to a bag-of-words
    embedder, which is what real technical corpora avoid via IDF)."""
    nouns = _NOUNS[domain]
    body: list[str] = []
    for _ in range(words):
        r = rng.random()
        if r < 0.12:
            body.append(rng.choice(nouns))
        elif r < 0.20:
            body.append(rng.choice(_VERBS))
        else:
            body.append(f"w{rng.randint(0, 20000)}")
    step = max(1, words // max(fact_mentions, 1))
    for j in range(fact_mentions):
        body.insert(min(j * step, len(body)), f"fact-{fact_id}")
    return " ".join(body)


def build_domain(name: str, n_queries: int = 250, seed: int = 0) -> DomainData:
    profile = DOMAIN_PROFILES[name]
    # NOTE: process-stable hash — builtin hash(str) is randomized per process
    # (PYTHONHASHSEED) and would make datasets differ between runs.
    from repro_torch.core.text import _stable_hash

    rng = random.Random(seed * 1009 + _stable_hash(name) % 65536)
    chunks: list[Chunk] = []
    fact_to_chunks: dict[int, list[int]] = {}
    cid = 0
    fact_id = 0
    for doc in range(profile.n_docs):
        for _ in range(profile.chunks_per_doc):
            fid = fact_id
            fact_id += 1
            text = _make_chunk_text(rng, name, fid, profile.chunk_words)
            # the vector store indexes a heading, like real chunk indexing;
            # the part number dominates the heading (high effective IDF)
            head = (f"fact-{fid} fact-{fid} fact-{fid} "
                    f"{rng.choice(nouns_for(name, rng))} {rng.choice(_VERBS)}")
            chunks.append(Chunk(doc, cid, text, head, (fid,)))
            fact_to_chunks.setdefault(fid, []).append(cid)
            cid += 1
            # distractors: mention the fact id once but carry no answer
            if rng.random() < profile.distractor_rate:
                dtext = _make_chunk_text(rng, name, fid, profile.chunk_words, fact_mentions=1)
                dhead = (f"{rng.choice(nouns_for(name, rng))} fact-{fid} "
                         f"{rng.choice(_VERBS)} w{rng.randint(0, 20000)}")
                chunks.append(Chunk(doc, cid, dtext, dhead, ()))
                cid += 1

    queries: list[Query] = []
    types = list(profile.type_mix)
    weights = [profile.type_mix[t] for t in types]
    nouns = _NOUNS[name]
    for qid in range(n_queries):
        qtype = rng.choices(types, weights)[0]
        needs = TYPE_NEEDS[qtype]
        # pick 1-3 target facts (analysis/recommendation span several)
        n_facts = 1 + int(needs["reasoning"] > 0.7) + int(rng.random() < 0.3)
        fids = rng.sample(range(fact_id), n_facts)
        rel = tuple(c for f in fids for c in fact_to_chunks.get(f, ()))
        ambiguous = rng.random() < profile.ambiguity
        tmpl = (_AMBIGUOUS_TEMPLATES if ambiguous else _TEMPLATES)[qtype]
        # precise queries name every fact they span, emphasised (retrievable
        # with high k); ambiguous ones mention only the first, once.
        fid_str = f"fact-{fids[0]}" if ambiguous else " and ".join(
            f"fact-{f} fact-{f}" for f in fids)
        text = tmpl.format(
            n1=rng.choice(nouns), n2=rng.choice(nouns), n3=rng.choice(nouns),
            v1=rng.choice(_VERBS), v2=rng.choice(_VERBS),
            fid=fid_str,
        )
        complexity = min(1.0, needs["complexity"] * (0.7 + 0.6 * rng.random()))
        reference = " ".join(chunks[c].text for c in rel[:2])[:400] or text
        queries.append(Query(
            qid=qid, text=text, qtype=qtype, relevant_chunks=rel,
            reference=reference, complexity=complexity,
            ambiguity=1.0 if ambiguous else profile.ambiguity * 0.3,
            prompt_words=len(text.split()),
        ))

    return DomainData(
        profile=profile,
        chunks=chunks,
        queries=queries,
        chunk_embeddings=embed_batch([c.index_text for c in chunks]),
        query_embeddings=embed_batch([q.text for q in queries]),
    )


def train_test_split(data: DomainData, test_frac: float = 0.3, seed: int = 1):
    rng = random.Random(seed)
    idx = list(range(len(data.queries)))
    rng.shuffle(idx)
    n_test = int(len(idx) * test_frac)
    test, train = idx[:n_test], idx[n_test:]
    return train, test
