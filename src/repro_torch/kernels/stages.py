"""Composable init/apply device stages for the selection pipeline.

The stax/NuX ``serial`` idiom applied to serving: a :class:`Stage` is a
named ``init`` thunk; calling ``init()`` returns ``(state, apply)`` where

* **state** is the stage's device-resident capture — corpus embeddings,
  DSQE parameters, path tables — materialized as torch tensors on the
  stage's ``device`` exactly once, at init time.  State is *threaded as an
  argument* into ``apply`` (never closed over), so the same ``apply`` can
  serve several table versions.
* **apply(state, carry) -> carry** has no host callbacks, no Python side
  effects and no data-dependent shapes.  ``carry`` is a flat ``dict`` of
  batch-major tensors; a stage reads the keys it needs and returns a NEW
  dict with its outputs added (inputs are never mutated).  ``serial(...)``
  of the selection stages runs ``embed -> retrieve -> score -> argmax`` on
  the device with no host hop between stages.

Carry keys used by the selection stages (one query batch, row-aligned):

  ``emb`` (B, d_in) raw embeddings -> [dsqe projection stage, core/dsqe.py]
  -> ``z`` (B, d) unit-norm -> [:func:`retrieve_stage`] -> ``topk_vals`` /
  ``topk_ids`` (B, k) -> [:func:`score_stage`, + ``slo`` (B, 2)] ->
  ``scores`` (B, P) masked / ``set_id`` (B,) -> [:func:`decode_stage`] ->
  ``best`` (B,) / ``feasible`` (B,).

The domain-sharded variants (:func:`shard_projection_stage`,
:func:`shard_retrieve_stage`, :func:`shard_score_stage`) serve a
multi-domain server from ONE program: every table gains a leading domain
axis (padded to the per-shard maxima with validity masks) and the carry
gains a SCALAR ``domain_id`` that selects the shard's row of each table.
They are plain torch, as the JAX package leaves them to XLA.

Padding/masking rules at stage boundaries: every batch row of the carry is
either real or a pad row that the DRIVER (not the stages) appends and
slices off; stages are row-independent so pad rows cannot influence real
rows.  Anywhere a padded candidate could reach a top-k/argmax, its score
must be losing (``NEG_INF``).

Only :func:`retrieve_stage` reaches a hand-written kernel
(``retrieval_topk``) when its state lives on the card; the score stage's
``dsqe_score_from_topk`` stays plain torch, as the JAX package runs it as
XLA outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.dsqe_score.ref import dsqe_score_from_topk
from repro_torch.kernels.retrieval_topk.ops import retrieval_topk

Carry = dict
InitFn = Callable[[], tuple[Any, Callable[[Any, Carry], Carry]]]


class Stage(NamedTuple):
    """A named ``init() -> (state, apply)`` pair (see module docstring)."""
    name: str
    init: InitFn


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()


def serial(*stages: Stage) -> Stage:
    """Compose stages left-to-right into one Stage.

    ``init()`` runs every child init and returns the tuple of child states;
    the composed ``apply`` threads the carry through the child applies in
    order.  Composition is associative — ``serial`` of ``serial``s flattens
    semantically — and the result is itself a Stage, so partial pipelines
    compose further.
    """
    def init():
        pairs = [s.init() for s in stages]
        states = tuple(st for st, _ in pairs)
        applies = tuple(ap for _, ap in pairs)

        def apply(state, carry: Carry) -> Carry:
            for ap, st in zip(applies, state):
                carry = ap(st, carry)
            return carry

        return states, apply

    return Stage("serial(" + ",".join(s.name for s in stages) + ")", init)


def retrieve_stage(corpus, *, k: int, query_key: str = "z",
                   out_vals: str = "topk_vals", out_ids: str = "topk_ids",
                   device="cuda") -> Stage:
    """Top-k similarity search of ``carry[query_key]`` against ``corpus``.

    State: the (n, d) corpus, device-resident float32 (a tensor already on
    ``device`` is not copied).  Adds descending ``out_vals``/``out_ids``
    (B, k) to the carry; exact score ties admit the lowest corpus id (the
    ``retrieval_topk`` contract).
    """
    k = min(k, corpus.shape[0])

    def init():
        dev = corpus.device if isinstance(corpus, torch.Tensor) else device
        state = _f32(corpus, dev)

        def apply(corpus_dev, carry: Carry) -> Carry:
            vals, ids = retrieval_topk(carry[query_key], corpus_dev, k=k)
            return {**carry, out_vals: vals, out_ids: ids}

        return state, apply

    return Stage(f"retrieve[k={k}]", init)


def score_stage(protos, path_weights, contains, lat, cost, prior, valid, *,
                query_key: str = "z", slo_key: str = "slo",
                device="cuda") -> Stage:
    """Algorithm-3 path scoring from the retrieve stage's top-k.

    State: the seven selection tables, device-resident float32.  Consumes
    ``carry[query_key]`` (for the prototype argmax), ``topk_vals``/
    ``topk_ids`` and the per-row (B, 2) ``carry[slo_key]``; adds masked
    ``scores`` (B, P) and ``set_id`` (B,).  Infeasible entries are NEG_INF,
    never 0 — a later argmax must see them lose.
    """
    def init():
        state = tuple(_f32(t, device) for t in (
            protos, path_weights, contains, lat, cost, prior, valid))

        def apply(tables, carry: Carry) -> Carry:
            scores, set_id = dsqe_score_from_topk(
                carry[query_key], carry["topk_vals"], carry["topk_ids"],
                *tables, carry[slo_key])
            return {**carry, "scores": scores, "set_id": set_id}

        return state, apply

    return Stage("score", init)


def shard_projection_stage(layers, *, in_key: str = "emb",
                           out_key: str = "z",
                           id_key: str = "domain_id", device="cuda") -> Stage:
    """DSQE projection over stacked per-domain parameter shards.

    ``layers`` is a list of ``{"w": (D, d_i, d_o), "b": (D, d_o)}`` dicts —
    each domain's trained projection stacked on a leading domain axis.  The
    scalar ``carry[id_key]`` selects the shard's matrices; the math mirrors
    ``core/dsqe.project`` exactly (ReLU between layers, unit-norm output
    with the 1e-6 floor).
    """
    def init():
        state = tuple((_f32(l["w"], device), _f32(l["b"], device))
                      for l in layers)

        def apply(params_dev, carry: Carry) -> Carry:
            did = carry[id_key]
            x = carry[in_key]
            n = len(params_dev)
            for i, (w, b) in enumerate(params_dev):
                x = x @ w[did] + b[did]
                if i < n - 1:
                    x = torch.relu(x)
            z = x / torch.clamp_min(
                torch.linalg.norm(x, dim=-1, keepdim=True), 1e-6)
            return {**carry, out_key: z}

        return state, apply

    return Stage("dsqe_project_shards", init)


def shard_retrieve_stage(corpora, corpus_valid, *, k: int,
                         query_key: str = "z", id_key: str = "domain_id",
                         out_vals: str = "topk_vals",
                         out_ids: str = "topk_ids", device="cuda") -> Stage:
    """Top-k similarity search against the ``carry[id_key]`` corpus shard.

    State: ``corpora`` (D, N_max, d) per-domain training embeddings padded
    with zero rows to the fleet-wide ``N_max``, plus ``corpus_valid``
    (D, N_max) row masks.  Pad-row similarities are forced to ``NEG_INF``
    BEFORE the top-k (zero-fill would beat real negative similarities), so
    a pad row can only be admitted once every real row is, and its vote
    weight ``max(NEG_INF, 0) = 0`` plus its all-zero ``path_weights`` row
    contribute nothing downstream.  The stable descending sort keeps the
    lowest-id tie contract.
    """
    def init():
        state = (_f32(corpora, device), _f32(corpus_valid, device))

        def apply(state_dev, carry: Carry) -> Carry:
            corpus, valid = state_dev
            did = carry[id_key]
            sims = carry[query_key] @ corpus[did].T  # (B, N_max)
            sims = torch.where(valid[did][None, :] > 0.5, sims, NEG_INF)
            vals, ids = torch.sort(sims, dim=1, descending=True, stable=True)
            return {**carry, out_vals: vals[:, :k].contiguous(),
                    out_ids: ids[:, :k].to(torch.int32)}

        return state, apply

    return Stage(f"retrieve_shards[k={k}]", init)


def shard_score_stage(protos, proto_valid, path_weights, contains, lat, cost,
                      prior, valid, *, query_key: str = "z",
                      slo_key: str = "slo",
                      id_key: str = "domain_id", device="cuda") -> Stage:
    """Algorithm-3 scoring over the ``carry[id_key]`` table shard.

    State: the selection tables with a leading domain axis — ``protos``
    (D, K_max, d) padded with zero prototypes masked by ``proto_valid``
    (D, K_max), ``path_weights`` (D, N_max, P), ``contains`` (D, K_max, P),
    and (D, P) ``lat``/``cost``/``prior``/``valid``.  The selected shard
    row feeds the SAME ``dsqe_score_from_topk`` as the single-domain stage.
    """
    def init():
        state = tuple(_f32(t, device) for t in (
            protos, proto_valid, path_weights, contains, lat, cost, prior,
            valid))

        def apply(tables, carry: Carry) -> Carry:
            pr, pv, pw, ct, la, co, pi, va = tables
            did = carry[id_key]
            scores, set_id = dsqe_score_from_topk(
                carry[query_key], carry["topk_vals"], carry["topk_ids"],
                pr[did], pw[did], ct[did], la[did], co[did], pi[did],
                va[did], carry[slo_key], proto_valid=pv[did])
            return {**carry, "scores": scores, "set_id": set_id}

        return state, apply

    return Stage("score_shards", init)


def decode_stage(floor: float = NEG_INF / 2) -> Stage:
    """Argmax decode: adds ``best`` (B,) int32 and ``feasible`` (B,) bool.

    ``torch.argmax`` picks the FIRST maximum, matching the host oracle's
    ``np.argmax`` lowest-index tie-break; a row is feasible iff its best
    masked score clears ``floor`` (above-the-mask sentinel threshold).
    Stateless — the fallback for infeasible rows stays on the host.
    """
    def init():
        def apply(_, carry: Carry) -> Carry:
            scores = carry["scores"]
            best = torch.argmax(scores, dim=1)
            top = torch.gather(scores, 1, best[:, None])[:, 0]
            return {**carry, "best": best.to(torch.int32),
                    "feasible": top > floor}

        return None, apply

    return Stage("decode", init)
