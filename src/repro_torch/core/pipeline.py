"""Path execution: the four module managers and the judge oracle.

Mechanics (token counts, retrieval hits, reranking, staged latency/cost) are
computed for real; response *quality* is scored by a deterministic judge
oracle in place of the paper's GPT-4o/Gemini G-Eval ensemble (offline
adaptation, DESIGN.md §2).  The oracle maps measured grounding (retrieval
recall over ground-truth chunks), model capability, query needs, and
component effects to a [0,1] score with per-(query, path) seeded noise.

Stage outputs are hashable so the emulator's prefix cache can reuse shared
path prefixes (paper §3.2.4: 30-50% compute saved).
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field, replace
from typing import Sequence

import numpy as np

from repro_torch.core.devices import (CLOUD_DEVICE, CLOUD_RTT_S, DeviceProfile,
                                ModelProfile, decode_latency_s,
                                model_call_cost_usd, model_call_latency_s)
from repro_torch.core.domains import TYPE_NEEDS, DomainData, Query
from repro_torch.core.paths import (MODEL_CATALOG, PLACED_IMPL, SPLIT_IMPL,
                              ComponentChoice, Path)
from repro_torch.core.retrieval import VectorStore
from repro_torch.core.splitgen import (CHUNK_TOKENS, EmitFn, GenChunk,
                                 generate_split)
from repro_torch.core.text import embed_text

HELPER_MODEL = "internlm2-1.8b"  # SLM used by stepback/HyDE/compress calls
OUT_TOKENS = 150  # nominal response length for cost accounting (paper Eq. 3)


@dataclass(frozen=True)
class StageState:
    """Pipeline state flowing between modules (hashable for prefix caching)."""

    prompt_tokens: int
    latency_s: float
    cost_usd: float
    query_emb_key: str  # cache identity of the (possibly rewritten) query
    retrieved: tuple[int, ...] = ()
    grounding: float = 0.0  # measured recall over ground-truth chunks
    ambiguity_resolved: bool = False
    compressed: float = 1.0  # surviving fraction of context tokens
    reasoning_boost: float = 0.0
    context_tokens: int = 0
    # effective capability for split paths (edge tier -> cloud tier by the
    # escalated-token fraction); NaN means "use the catalog quality_tier"
    knowledge_override: float = float("nan")


class PipelineExecutor:
    def __init__(self, domain: DomainData, device: DeviceProfile, seed: int = 0):
        self.domain = domain
        self.device = device
        self.seed = seed
        # exact search: domain corpora are small (1-2k chunks); the IVF index
        # in repro_torch.core.retrieval is for larger stores (covered by tests)
        self.store = VectorStore(domain.chunk_embeddings, n_clusters=0, seed=seed)
        self._helper = MODEL_CATALOG[HELPER_MODEL]
        # All three memos are read/written lock-free from concurrent fleet
        # workers: entries are deterministic functions of their key, so a
        # race at worst duplicates a computation, and the atomic
        # dict.setdefault keeps a single canonical entry per key.
        self._hyde_cache: dict[int, np.ndarray] = {}
        self._sb_cache: dict[int, np.ndarray] = {}
        # search memo: (qid, stepback?, hyde?, k) fully determines the query
        # vector and therefore the result — pure dedup, never changes results
        self._search_cache: dict[tuple, object] = {}

    # -- module managers ----------------------------------------------------

    def run_qproc(self, q: Query, choice: ComponentChoice, st: StageState) -> StageState:
        if choice.impl == "null":
            return st
        if choice.impl == "stepback":
            depth = int(choice.param("abstraction", 1))
            extra = 30 * depth  # abstraction prompt + regenerated query
            lat = model_call_latency_s(self._helper, self.device,
                                       st.prompt_tokens + extra, out_tokens=40)
            return replace(
                st,
                prompt_tokens=st.prompt_tokens + 40,
                latency_s=st.latency_s + lat,
                ambiguity_resolved=True,
                reasoning_boost=st.reasoning_boost + 0.05 * depth,
                query_emb_key=f"{st.query_emb_key}+sb{depth}",
            )
        if choice.impl == "compress":
            ratio = float(choice.param("ratio", 0.5))
            lat = model_call_latency_s(self._helper, self.device, st.prompt_tokens, out_tokens=0)
            return replace(
                st,
                latency_s=st.latency_s + lat,
                compressed=ratio,
                query_emb_key=f"{st.query_emb_key}+cmp{ratio}",
            )
        raise KeyError(choice.impl)

    # step-back rewrite (sb=True below): the SLM re-states the query,
    # emphasising its key entities (real re-embedding of the expanded text)
    def _search_vec(self, q: Query, sb: bool, hyde: bool) -> np.ndarray:
        """The float32 search vector for (qid, stepback?, hyde?) — the same
        value whether resolved by the scalar walk or the cross-query
        prefetch (one fixed op sequence through the shared embed memos)."""
        if sb:
            vec = self._sb_cache.get(q.qid)
            if vec is None:
                vec = self._sb_cache.setdefault(
                    q.qid,
                    embed_text(q.text + " " + q.text + " clarify context specification"))
        else:
            vec = self.domain.query_embeddings[q.qid]
        if hyde:
            hypo = self._hyde_cache.get(q.qid)
            if hypo is None:
                hypo = self._hyde_cache.setdefault(
                    q.qid,
                    embed_text(q.text + " " + q.reference.split("fact-")[0]))
            vec = vec + 0.5 * hypo
        return vec.astype(np.float32)

    def _search(self, q: Query, st: StageState, k: int, hyde: bool):
        """Memoized vector search. The query vector is fully determined by
        (qid, stepback-rewrite?, hyde-blend?), so (qid, sb, hyde, k) is an
        exact identity key — the memo dedups repeated searches across stage
        prefixes without changing any result.  `prefetch_retrieval` fills
        the same memo from batched `VectorStore.search_batch` passes; the
        store's bitwise-stability contract keeps either fill path
        bit-identical."""
        key = (q.qid, "+sb" in st.query_emb_key, hyde, k)
        res = self._search_cache.get(key)
        if res is None:
            vec = self._search_vec(q, "+sb" in st.query_emb_key, hyde)
            res = self._search_cache.setdefault(key, self.store.search(vec, k))
        return res

    def run_retrieval(self, q: Query, choice: ComponentChoice, st: StageState) -> StageState:
        if choice.impl == "null":
            return st
        k = int(choice.param("top_k", 4))
        chunk_words = self.domain.profile.chunk_words
        search_lat = 0.002 + 2e-6 * len(self.domain.chunks)
        lat = search_lat
        if choice.impl == "hyde":
            # hypothesis generation by the helper SLM, retrieval on the blend
            lat += model_call_latency_s(self._helper, self.device, st.prompt_tokens, out_tokens=60)
        res = self._search(q, st, k, hyde=choice.impl == "hyde")
        retrieved = tuple(int(i) for i in res.ids)
        rel = set(q.relevant_chunks)
        grounding = len(rel.intersection(retrieved)) / max(len(rel), 1)
        ctx_tokens = int(k * chunk_words * 1.3)
        return replace(
            st,
            retrieved=retrieved,
            grounding=grounding,
            latency_s=st.latency_s + lat,
            context_tokens=ctx_tokens,
            prompt_tokens=st.prompt_tokens + ctx_tokens,
        )

    def run_cproc(self, q: Query, choice: ComponentChoice, st: StageState) -> StageState:
        if choice.impl == "null" or not st.retrieved:
            return st
        rel = set(q.relevant_chunks)
        if choice.impl == "rerank":
            keep = int(choice.param("keep", 2))
            # cross-score by true chunk/query affinity: relevant chunks carry
            # the query's fact token -> lexical overlap ranks them first
            scored = sorted(st.retrieved, key=lambda c: (c not in rel))
            kept = tuple(scored[:keep])
            grounding = len(rel.intersection(kept)) / max(len(rel), 1)
            new_ctx = int(keep * self.domain.profile.chunk_words * 1.3)
            lat = model_call_latency_s(self._helper, self.device,
                                       st.context_tokens, out_tokens=0) * 0.5
            return replace(
                st, retrieved=kept, grounding=grounding,
                prompt_tokens=st.prompt_tokens - st.context_tokens + new_ctx,
                context_tokens=new_ctx, latency_s=st.latency_s + lat,
            )
        if choice.impl == "corrective_rag":
            thr = float(choice.param("threshold", 0.35))
            if st.grounding < thr + 0.3:
                # re-retrieve wider (real second search) and merge
                res = self._search(q, st, 2 * max(4, len(st.retrieved)), hyde=False)
                merged = tuple(dict.fromkeys(st.retrieved + tuple(int(i) for i in res.ids)))
                grounding = len(rel.intersection(merged)) / max(len(rel), 1)
                new_ctx = int(len(merged) * self.domain.profile.chunk_words * 1.3)
                lat = 0.004 + model_call_latency_s(self._helper, self.device,
                                                   st.context_tokens, out_tokens=20)
                return replace(
                    st, retrieved=merged, grounding=grounding,
                    prompt_tokens=st.prompt_tokens - st.context_tokens + new_ctx,
                    context_tokens=new_ctx, latency_s=st.latency_s + lat,
                )
            return st
        raise KeyError(choice.impl)

    def run_model(self, q: Query, choice: ComponentChoice, st: StageState) -> StageState:
        if choice.impl == SPLIT_IMPL:
            return self._run_split_model(q, choice, st)
        if choice.impl == PLACED_IMPL:
            return self._run_placed_model(q, choice, st)
        model = MODEL_CATALOG[choice.impl]
        prompt = int(st.prompt_tokens * (st.compressed if st.context_tokens else 1.0))
        lat = model_call_latency_s(model, self.device, prompt, out_tokens=0)
        cost = model_call_cost_usd(model, prompt, OUT_TOKENS)
        return replace(st, latency_s=st.latency_s + lat, cost_usd=st.cost_usd + cost)

    def _run_split_model(self, q: Query, choice: ComponentChoice,
                         st: StageState, emit: EmitFn | None = None
                         ) -> StageState:
        """Split-inference model stage (see core/splitgen.py): deterministic
        edge-draft / cloud-verify generation.  With ``emit`` the chunks
        stream out as they are drafted; the returned state is identical
        either way (the trace is a pure function of (seed, qid, config))."""
        edge = MODEL_CATALOG[choice.param("edge")]
        cloud = MODEL_CATALOG[choice.param("cloud")]
        tau = float(choice.param("tau", 0.6))
        prompt = int(st.prompt_tokens * (st.compressed if st.context_tokens else 1.0))
        r = generate_split(
            seed=self.seed, qid=q.qid, complexity=q.complexity,
            edge=edge, cloud=cloud, tau=tau, device=self.device,
            prompt_tokens=prompt, out_tokens=OUT_TOKENS,
            grounding=st.grounding, start_latency_s=st.latency_s,
            start_cost_usd=st.cost_usd, emit=emit)
        return replace(st, latency_s=r.latency_s, cost_usd=r.cost_usd,
                       knowledge_override=r.knowledge)

    @staticmethod
    def _placement_plan(choice: ComponentChoice):
        from repro_torch.runtime.placement import get_plan

        return get_plan(choice.param("model"), choice.param("chain"))

    def _run_placed_model(self, q: Query, choice: ComponentChoice,
                          st: StageState) -> StageState:
        """Pipelined-placement model stage (runtime/placement.py): TTFT is
        the plan's bubble-aware pipelined prefill at the staged prompt
        length; cost bills the plan's cloud-resident layer fraction.  The
        plan is memoized, so this is a dict hit plus a closed form."""
        plan = self._placement_plan(choice)
        prompt = int(st.prompt_tokens * (st.compressed if st.context_tokens else 1.0))
        lat = plan.prefill_latency_s(prompt)
        cost = plan.cost_usd(prompt, OUT_TOKENS)
        return replace(st, latency_s=st.latency_s + lat, cost_usd=st.cost_usd + cost)

    # -- judge oracle ---------------------------------------------------------

    def judge(self, q: Query, path: Path, st: StageState) -> float:
        """Deterministic G-Eval stand-in. See module docstring."""
        prof = self.domain.profile
        needs = TYPE_NEEDS[q.qtype]
        if path.model.impl == SPLIT_IMPL:
            # blended capability computed by the split model stage
            knowledge = st.knowledge_override
        elif path.model.impl == PLACED_IMPL:
            # placement moves layers across devices, not weights: the
            # underlying catalog model answers at its own tier
            knowledge = MODEL_CATALOG[path.model.param("model")].quality_tier
        else:
            knowledge = MODEL_CATALOG[path.model.impl].quality_tier

        # grounding term: measured recall, or parametric knowledge fallback
        if path.retrieval.impl == "null":
            ground = 0.15 + 0.45 * knowledge
        else:
            ground = st.grounding * (0.78 + 0.22 * st.compressed) \
                * (1.0 - 0.25 * max(0.0, 1.0 - knowledge) * min(1.0, st.context_tokens / 900.0))
            # context dilution: small models lose the needle in wide contexts
        if st.ambiguity_resolved and q.ambiguity < 0.3:
            # over-abstraction: step-back blurs already-precise queries, so no
            # FIXED preprocessing config wins across a domain (paper §1's
            # coordination insight; this is what per-query selection exploits)
            ground *= 0.78
        retrieval_term = needs["retrieval"] * prof.retrieval_weight * min(1.0, ground)

        # reasoning term: capability + step-back style decomposition
        reasoning = knowledge + st.reasoning_boost
        reasoning_term = needs["reasoning"] * prof.reasoning_weight * min(1.0, reasoning)

        wsum = needs["retrieval"] * prof.retrieval_weight + needs["reasoning"] * prof.reasoning_weight
        base = (retrieval_term + reasoning_term) / max(wsum, 1e-6)
        # unresolved ambiguity caps the whole response, whatever the model tier
        if q.ambiguity > 0.5 and not st.ambiguity_resolved:
            base *= 1.0 - 0.45 * q.ambiguity
        # complexity gates weak models
        base *= 1.0 - max(0.0, q.complexity - knowledge) * 0.5
        base = 0.25 + 0.72 * base

        h = hashlib.blake2b(f"{self.seed}:{q.qid}:{path.key}".encode(), digest_size=8).digest()
        noise = (int.from_bytes(h, "little") / 2**64 - 0.5) * 0.14
        return float(np.clip(base + noise, 0.0, 1.0))

    # -- full path -----------------------------------------------------------

    def initial_state(self, q: Query) -> StageState:
        return StageState(
            prompt_tokens=int(q.prompt_words * 1.3) + 40,  # + system prompt
            latency_s=0.0, cost_usd=0.0, query_emb_key=f"q{q.qid}",
        )

    def run(self, q: Query, path: Path) -> tuple[float, float, float]:
        st = self.initial_state(q)
        st = self.run_qproc(q, path.qproc, st)
        st = self.run_retrieval(q, path.retrieval, st)
        st = self.run_cproc(q, path.cproc, st)
        st = self.run_model(q, path.model, st)
        acc = self.judge(q, path, st)
        return acc, st.latency_s, st.cost_usd

    def run_stream(self, q: Query, path: Path, emit: EmitFn
                   ) -> tuple[float, float, float] | None:
        """Streaming variant of ``run``: the same stage walk and a
        bit-identical final (acc, latency_s, cost_usd), with the response
        decode emitted as ordered ``GenChunk``s through ``emit``.  ``emit``
        returning False tears the stream down — the return value is then
        None (no judged result for a cancelled generation)."""
        st = self.initial_state(q)
        st = self.run_qproc(q, path.qproc, st)
        st = self.run_retrieval(q, path.retrieval, st)
        st = self.run_cproc(q, path.cproc, st)
        if path.model.impl == SPLIT_IMPL:
            alive = True

            def gate(chunk: GenChunk) -> bool:
                nonlocal alive
                alive = alive and bool(emit(chunk))
                return alive

            st = self._run_split_model(q, path.model, st, emit=gate)
            if not alive:
                return None
            acc = self.judge(q, path, st)
            return acc, st.latency_s, st.cost_usd
        # whole-model / placed path: final metrics come from the exact same
        # calls as run() (bit-for-bit by construction); the chunk timeline
        # decorates the bandwidth-bound decode trajectory on top of the
        # TTFT metric (placed paths pace decode by the plan's per-token
        # pipelined rate, boundary transfers included)
        st = self.run_model(q, path.model, st)
        acc = self.judge(q, path, st)
        if path.model.impl == PLACED_IMPL:
            decode_at = self._placement_plan(path.model).decode_latency_s
        else:
            model = MODEL_CATALOG[path.model.impl]
            dev = CLOUD_DEVICE if model.placement == "cloud" else self.device

            def decode_at(done: int) -> float:
                return decode_latency_s(model, dev, done)
        done, i = 0, 0
        while done < OUT_TOKENS:
            tokens = min(CHUNK_TOKENS, OUT_TOKENS - done)
            done += tokens
            if not emit(GenChunk(
                    index=i, tokens=tokens, source=path.model.impl,
                    confidence=1.0,
                    latency_s=st.latency_s + decode_at(done),
                    cost_usd=st.cost_usd, final=done >= OUT_TOKENS)):
                return None
            i += 1
        return acc, st.latency_s, st.cost_usd


# ---------------------------------------------------------------------------
# batched execution engine
# ---------------------------------------------------------------------------


class BatchedPipelineExecutor:
    """Structure-of-arrays engine: one query against a whole block of paths.

    The three preprocessing stages (qproc / retrieval / cproc) collapse to a
    handful of distinct stage prefixes (~30 for the default space of ~200
    paths); they are resolved once per distinct prefix through the scalar
    stage functions and the shared string-keyed prefix cache.  Model
    execution and judging — the per-cell hot path — then run as NumPy array
    ops over the block.

    Parity contract: results are bit-for-bit identical to
    ``PipelineExecutor.run`` / ``Emulator._eval``.  The same stage functions
    produce the prefix states, every vectorized float64 expression mirrors
    the scalar order of operations, and the judge noise hashes the same
    ``seed:qid:path.key`` strings through blake2b.

    ``prefetch_retrieval`` extends the same contract ACROSS queries: the
    retrieval stage's vector searches for a whole query block are resolved
    in batched ``VectorStore.search_batch`` passes (one GEMM per distinct
    top-k width) and installed in the scalar search memo, which the stage
    functions then hit — bit-identical results via the store's
    bitwise-stable batched-search contract (core/retrieval.py).
    """

    def __init__(self, scalar: PipelineExecutor, paths: Sequence[Path]):
        self.scalar = scalar
        self.paths = list(paths)
        device = scalar.device
        P = len(self.paths)

        # -- per-path model constants (mirror model_call_latency_s/_cost) ---
        # fused (P, 8) matrix, one gather per block; columns:
        #   0 quality_tier, 1 fixed offset (overhead / cloud RTT),
        #   2 flops coef (2 * params * 1e9, scalar op order),
        #   3 compute denom (tflops * 1e12 * util), 4 weight-stream floor (s),
        #   5 usd/1k input, 6 usd_per_1k_out * OUT_TOKENS, 7 retrieval-null flag
        self._m_cols = np.empty((P, 8))
        self._key_bytes = []
        # split-inference and placed paths have no single catalog model row:
        # split model stages are data-dependent (per-chunk confidence
        # gating) and placed stages price a memoized multi-stage plan, so
        # those cells run the scalar walk in finish_block — trivially
        # bit-equal with the oracle — while the rest stays vectorized
        self._scalar_js = np.zeros(P, bool)
        for j, p in enumerate(self.paths):
            if p.model.impl in (SPLIT_IMPL, PLACED_IMPL):
                self._scalar_js[j] = True
                self._m_cols[j] = 0.0  # never read for scalar rows
                self._key_bytes.append(p.key.encode())
                continue
            m = MODEL_CATALOG[p.model.impl]
            dev = CLOUD_DEVICE if m.placement == "cloud" else device
            self._m_cols[j] = (
                m.quality_tier,
                CLOUD_RTT_S if m.placement == "cloud" else dev.overhead_s,
                2.0 * m.params_b * 1e9,
                dev.tflops * 1e12 * dev.util,
                (m.params_b * 1e9 * 2.0) / (dev.mem_gbps * 1e9),
                m.usd_per_1k_in,
                m.usd_per_1k_out * OUT_TOKENS,
                float(p.retrieval.impl == "null"),
            )
            self._key_bytes.append(p.key.encode())

        # -- stage-prefix slot tables (query-independent path structure) ----
        # slot id per path at each prefix depth, plus the cache-key suffixes
        # that reproduce the scalar engine's incremental prefix strings.
        self.path_s1 = np.empty(P, np.int64)
        self.path_s2 = np.empty(P, np.int64)
        self.path_s3 = np.empty(P, np.int64)
        self.s1_suffix: list[str] = []
        self.s2_suffix: list[str] = []
        self.s3_suffix: list[str] = []
        self.s1_choice: list[ComponentChoice] = []
        self.s2_choice: list[ComponentChoice] = []
        self.s3_choice: list[ComponentChoice] = []
        self.s2_parent: list[int] = []
        self.s3_parent: list[int] = []
        seen1: dict[str, int] = {}
        seen2: dict[str, int] = {}
        seen3: dict[str, int] = {}
        for j, p in enumerate(self.paths):
            k1 = "|" + p.qproc.key
            k2 = k1 + "|" + p.retrieval.key
            k3 = k2 + "|" + p.cproc.key
            if k1 not in seen1:
                seen1[k1] = len(self.s1_suffix)
                self.s1_suffix.append(k1)
                self.s1_choice.append(p.qproc)
            if k2 not in seen2:
                seen2[k2] = len(self.s2_suffix)
                self.s2_suffix.append(k2)
                self.s2_choice.append(p.retrieval)
                self.s2_parent.append(seen1[k1])
            if k3 not in seen3:
                seen3[k3] = len(self.s3_suffix)
                self.s3_suffix.append(k3)
                self.s3_choice.append(p.cproc)
                self.s3_parent.append(seen2[k2])
            self.path_s1[j] = seen1[k1]
            self.path_s2[j] = seen2[k2]
            self.path_s3[j] = seen3[k3]
        # full-block fast path: every slot present, inverse is path_s3 itself
        self._full_js = np.arange(P)
        self._all_s1 = np.arange(len(self.s1_suffix))
        self._all_s2 = np.arange(len(self.s2_suffix))
        self._all_s3 = np.arange(len(self.s3_suffix))

    # -- cross-query retrieval prefetch --------------------------------------

    def prefetch_retrieval(self, pairs: Sequence[tuple[Query, np.ndarray]]
                           ) -> dict:
        """Resolve the retrieval stage for a block of queries in batched
        `VectorStore.search_batch` passes instead of one GEMV per query.

        ``pairs`` is [(query, path-index block), ...]; for every distinct
        retrieval slot each query's block touches, the (qid, sb, hyde, k)
        search the scalar walk would run is grouped by (hyde-agnostic) k
        and resolved as ONE ``(Bq, d) @ (d, n)`` pass, then installed in
        the scalar executor's search memo via the same atomic setdefault.
        The store's bitwise-stability contract (see core/retrieval.py)
        makes the memo entries bit-identical to per-query ``search`` calls,
        so cache-stat and result parity with the scalar oracle survive.

        Returns {"searches": memo entries filled, "passes": batched calls}.
        """
        ex = self.scalar
        need: dict[int, list[tuple[tuple, np.ndarray]]] = {}
        queued: set[tuple] = set()
        for q, js in pairs:
            js = np.asarray(js, np.int64)
            for s in np.unique(self.path_s2[js]):
                choice = self.s2_choice[s]
                if choice.impl == "null":
                    continue
                sb = self.s1_choice[self.s2_parent[s]].impl == "stepback"
                hyde = choice.impl == "hyde"
                k = int(choice.param("top_k", 4))
                key = (q.qid, sb, hyde, k)
                if key in queued or ex._search_cache.get(key) is not None:
                    continue
                queued.add(key)
                need.setdefault(k, []).append((key, ex._search_vec(q, sb, hyde)))
        filled = 0
        for k, entries in sorted(need.items()):
            block = np.stack([vec for _, vec in entries])
            for (key, _), res in zip(entries, ex.store.search_batch(block, k)):
                if ex._search_cache.setdefault(key, res) is res:
                    filled += 1
        return {"searches": filled, "passes": len(need)}

    # -- stage resolution ----------------------------------------------------

    def block_states(self, q: Query, js: np.ndarray, cache: dict
                     ) -> tuple[list[StageState], np.ndarray, int]:
        """Resolve the preprocessing prefix for every path in ``js``.

        Returns (distinct final states, per-path index into them, number of
        cache misses).  Each path touches three prefix levels exactly like
        the scalar walk, so callers can account hits as ``3*len(js) - new``.
        """
        ex = self.scalar
        root = f"q{q.qid}"
        n_new = 0
        st0 = None
        # fast path only for the exact full sweep js == arange(P): every slot
        # is present and path_s3 doubles as the inverse index
        if (js.size == len(self.paths) and js[0] == 0
                and np.array_equal(js, self._full_js)):
            slots1, slots2 = self._all_s1, self._all_s2
            slots3, inv = self._all_s3, self.path_s3
        else:
            slots1 = np.unique(self.path_s1[js])
            slots2 = np.unique(self.path_s2[js])
            slots3, inv = np.unique(self.path_s3[js], return_inverse=True)
        # writes go through the atomic dict.setdefault so a concurrently
        # shared prefix cache keeps one canonical state per key (a racing
        # thread recomputes the same deterministic state and discards it);
        # `prev is st` keeps the miss count exact in the single-thread case.
        # `local` pins this row's resolved prefixes: a bounded (LRU) cache
        # may evict a parent between levels, so parents are read from the
        # pin, never back out of the shared cache
        local: dict = {}

        def resolve(key, compute):
            nonlocal n_new
            st = local.get(key)
            if st is None:
                st = cache.get(key)
            if st is None:
                st = compute()
                canon = cache.setdefault(key, st)
                if canon is st:
                    n_new += 1
                st = canon
            local[key] = st
            return st

        for s in slots1:
            def _q(s=s):
                nonlocal st0
                if st0 is None:
                    st0 = ex.initial_state(q)
                return ex.run_qproc(q, self.s1_choice[s], st0)
            resolve(root + self.s1_suffix[s], _q)
        for s in slots2:
            resolve(root + self.s2_suffix[s],
                    lambda s=s: ex.run_retrieval(
                        q, self.s2_choice[s],
                        local[root + self.s1_suffix[self.s2_parent[s]]]))
        for s in slots3:
            resolve(root + self.s3_suffix[s],
                    lambda s=s: ex.run_cproc(
                        q, self.s3_choice[s],
                        local[root + self.s2_suffix[self.s3_parent[s]]]))
        states = [local[root + self.s3_suffix[s]] for s in slots3]
        return states, inv, n_new

    # -- vectorized model + judge -------------------------------------------

    def finish_block(self, q: Query, states: Sequence[StageState],
                     state_of: np.ndarray, js: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized run_model + judge over a block of paths.

        ``js`` indexes ``self.paths``; ``state_of[i]`` indexes ``states`` for
        path ``js[i]``.  Returns (accuracy, latency_s, cost_usd) arrays.
        Split-inference and placed cells (no single catalog model row) are
        resolved by the scalar walk; everything else stays on the
        vectorized fast path.
        """
        scalar = self._scalar_js[js]
        if not scalar.any():
            return self._finish_vec(q, states, state_of, js)
        acc = np.empty(js.size)
        lat = np.empty(js.size)
        cost = np.empty(js.size)
        rest = ~scalar
        if rest.any():
            acc[rest], lat[rest], cost[rest] = self._finish_vec(
                q, states, state_of[rest], js[rest])
        ex = self.scalar
        for i in np.nonzero(scalar)[0]:
            p = self.paths[js[i]]
            st = ex.run_model(q, p.model, states[state_of[i]])
            acc[i] = ex.judge(q, p, st)
            lat[i] = st.latency_s
            cost[i] = st.cost_usd
        return acc, lat, cost

    def _finish_vec(self, q: Query, states: Sequence[StageState],
                    state_of: np.ndarray, js: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        ex = self.scalar
        # per-state scalars in one pass (Python int() keeps truncation exact)
        cols = np.array([(
            float(int(st.prompt_tokens * (st.compressed if st.context_tokens else 1.0))),
            st.latency_s, st.cost_usd, st.grounding, st.compressed,
            float(st.context_tokens), float(st.ambiguity_resolved),
            st.reasoning_boost) for st in states])[state_of]
        prompt = cols[:, 0]
        m = self._m_cols[js]
        # run_model: prefill latency (compute vs weight-stream roof) + cost
        lat = cols[:, 1] + (
            m[:, 1] + np.maximum(m[:, 2] * prompt / m[:, 3], m[:, 4]))
        cost = cols[:, 2] + (m[:, 5] * prompt + m[:, 6]) / 1000.0

        # judge oracle, elementwise in the scalar's op order
        prof = ex.domain.profile
        needs = TYPE_NEEDS[q.qtype]
        know = m[:, 0]
        ground_rag = cols[:, 3] * (0.78 + 0.22 * cols[:, 4]) \
            * (1.0 - 0.25 * np.maximum(0.0, 1.0 - know)
               * np.minimum(1.0, cols[:, 5] / 900.0))
        ground = np.where(m[:, 7] != 0.0, 0.15 + 0.45 * know, ground_rag)
        resolved = cols[:, 6] != 0.0
        if q.ambiguity < 0.3:
            ground = ground * np.where(resolved, 0.78, 1.0)
        retrieval_term = (needs["retrieval"] * prof.retrieval_weight) \
            * np.minimum(1.0, ground)
        reasoning_term = (needs["reasoning"] * prof.reasoning_weight) \
            * np.minimum(1.0, know + cols[:, 7])
        wsum = needs["retrieval"] * prof.retrieval_weight + needs["reasoning"] * prof.reasoning_weight
        base = (retrieval_term + reasoning_term) / max(wsum, 1e-6)
        if q.ambiguity > 0.5:
            base = base * np.where(resolved, 1.0, 1.0 - 0.45 * q.ambiguity)
        base = base * (1.0 - np.maximum(0.0, q.complexity - know) * 0.5)
        base = 0.25 + 0.72 * base

        h0 = hashlib.blake2b(f"{ex.seed}:{q.qid}:".encode(), digest_size=8)
        keys = self._key_bytes
        digests = []
        for j in js:
            h = h0.copy()
            h.update(keys[j])
            digests.append(h.digest())
        raw = np.frombuffer(b"".join(digests), "<u8")
        noise = (raw / 2**64 - 0.5) * 0.14
        acc = np.clip(base + noise, 0.0, 1.0)
        return acc, lat, cost

    def run_block(self, q: Query, js: np.ndarray | None = None,
                  cache: dict | None = None
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Full pipeline for one query over a path block (uncached by default)."""
        if js is None:
            js = self._full_js
        js = np.asarray(js, np.int64)
        if js.size == 0:
            empty = np.empty(0)
            return empty, empty.copy(), empty.copy()
        states, inv, _ = self.block_states(q, js, {} if cache is None else cache)
        return self.finish_block(q, states, inv, js)
