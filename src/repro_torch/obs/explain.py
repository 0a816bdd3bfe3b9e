"""Decision attribution: the structured ``why`` record (DESIGN.md §18.3),
PyTorch port of ``repro.obs.explain``.

Every quantity a cache decision depends on already crosses the device
seam in ``LookupResult`` and the runtime's policy/partition state — this
module just collects them into one JSON-able record per request instead
of letting them evaporate after the batch:

    {"decision": "near_hit",
     "score": 0.787, "matched_slot": 1042, "matched_source_id": 17,
     "effective_threshold": 0.8, "threshold_source": "policy",
     "band": {"lo": 0.75, "hi": 0.8, "lo_source": "tenant"},
     "topk": [{"slot": 1042, "score": 0.787, "source_id": 17}, ...],
     "session_fused": false, "tenant": "acme",
     "synthesis": {"verdict": "served", "source_id": 17},
     "coalesced_into": null}

``decision`` is one of ``hit`` / ``near_hit`` / ``miss`` (and the
scheduler rewrites it to ``coalesced`` for waiters, filling
``coalesced_into`` with the leader's coalesce key). ``threshold_source``
/ ``lo_source`` say which layer supplied the edge (``policy`` vs
``tenant`` override) — the first question a per-tenant threshold bug
raises. The record is host-side only: it is built from numpy copies the
engine takes before the step that updates the slab in place, and from
the partition's host tuples, so it never reads a device tensor.
"""
from __future__ import annotations

import numpy as np


def effective_edges(policy, policy_state, partition, tenant_ix: int | None
                    ) -> dict:
    """Resolve the decision edges a given row was judged against.

    Returns ``{"threshold", "threshold_source", "band"}`` where ``band``
    is ``None`` for band-less policies and otherwise
    ``{"lo", "hi", "lo_source"}`` — mirroring exactly the override order
    the compiled step applies (§13.2 thresholds, §17.2 band_lo): tenant
    override wins when set (sentinel < 0 = none), policy state otherwise.
    """
    ps = np.asarray(policy_state, dtype=np.float32).reshape(-1)
    banded = hasattr(policy, "near")
    # policy-state layout: FixedThreshold/AdaptiveThreshold carry the
    # effective hit threshold first; BandPolicy carries [tau_lo, tau_hi,..]
    tau_hit = float(ps[1]) if banded else float(ps[0])
    tau_lo = float(ps[0]) if banded else None
    source = "policy"
    lo_source = "policy"
    if partition is not None and tenant_ix is not None:
        # the partition's host tuples (as f32, the device tables' dtype),
        # not its per-device tensors
        thr = float(np.float32(partition.thresholds[tenant_ix]))
        if thr >= 0.0:
            tau_hit, source = thr, "tenant"
        if banded:
            lo = float(np.float32(partition.band_lo[tenant_ix]))
            if lo >= 0.0:
                tau_lo, lo_source = lo, "tenant"
    band = None
    if banded:
        band = {"lo": round(tau_lo, 6), "hi": round(tau_hit, 6),
                "lo_source": lo_source}
    return {"threshold": round(tau_hit, 6), "threshold_source": source,
            "band": band}


def build_why(row: int, *, request, hit: bool, near_served: bool,
              score: float, matched_slot: int, matched_source_id: int,
              topk_slots, topk_scores, topk_source_ids,
              edges: dict, session_fused: bool,
              synthesizer_present: bool, near_band: bool,
              synthesis_source_id: int | None) -> dict:
    """One request's decision record from batch-level arrays (§18.3)."""
    if hit:
        decision = "hit"
    elif near_served:
        decision = "near_hit"
    else:
        decision = "miss"
    topk = [{"slot": int(topk_slots[j]),
             "score": round(float(topk_scores[j]), 6),
             "source_id": int(topk_source_ids[j])}
            for j in range(len(topk_slots)) if int(topk_slots[j]) >= 0]
    synthesis = None
    if synthesizer_present and near_band:
        synthesis = {
            "verdict": "served" if near_served else "abstained",
            "source_id": (int(synthesis_source_id)
                          if near_served and synthesis_source_id is not None
                          else None),
        }
    return {
        "row": int(row),
        "decision": decision,
        "score": round(float(score), 6),
        "matched_slot": int(matched_slot) if score > -np.inf else -1,
        "matched_source_id": int(matched_source_id)
        if score > -np.inf else -1,
        "effective_threshold": edges["threshold"],
        "threshold_source": edges["threshold_source"],
        "band": edges["band"],
        "in_band": bool(near_band),
        "topk": topk,
        "session_fused": bool(session_fused),
        "tenant": request.tenant,
        "session": request.session,
        "synthesis": synthesis,
        "coalesced_into": None,
    }
