"""Rank parity: the gate replay's ``parity="rank"`` judges a tick by.

The port's copy of ``rank_parity`` and ``kendall_tau`` from
``rca_tpu.engine.quantized`` (the quantized engine itself is not ported).
A replay on another device, or on a kernel whose scores move in the low
decimals, must keep the RANKING: hit@1 and hit@k equal and a Kendall-tau
floor over the common top-k.
"""

from __future__ import annotations


def kendall_tau(order_a, order_b) -> float:
    """Kendall rank correlation between two orderings of the same item
    set (1.0 = identical order, -1.0 = reversed), over the items of
    ``order_a`` that ``order_b`` holds."""
    items = [x for x in order_a if x in set(order_b)]
    k = len(items)
    if k < 2:
        return 1.0
    pos_b = {x: i for i, x in enumerate(order_b)}
    concordant = discordant = 0
    for i in range(k):
        for j in range(i + 1, k):
            d = pos_b[items[i]] - pos_b[items[j]]
            if d < 0:
                concordant += 1
            elif d > 0:
                discordant += 1
    return (concordant - discordant) / (k * (k - 1) / 2)


def rank_parity(ranked_ref, ranked_got, k: int = 3,
                tau_floor: float = 0.99) -> dict:
    """hit@1 and hit@k equality (the same leaders, as SETS for k > 1; the
    order within the tail is judged by tau) plus a Kendall-tau floor over
    the common top-k.  ``ranked_*`` are ranked dicts (``[{"component":
    ...}]``) or plain name lists."""
    def names(r):
        return [x["component"] if isinstance(x, dict) else x for x in r]

    ref, got = names(ranked_ref), names(ranked_got)
    hit1 = bool(ref[:1] == got[:1])
    hitk = bool(set(ref[:k]) == set(got[:k]))
    tau = kendall_tau(ref, got)
    return {
        "hit1_equal": hit1,
        f"hit{k}_equal": hitk,
        "kendall_tau": round(float(tau), 4),
        "ok": hit1 and hitk and tau >= tau_floor,
    }
