"""Label-selector semantics shared by feature extraction, graph building,
and the agents (reference: agents/topology_agent.py:133 selector ⊆ labels)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def selector_matches(selector: Dict[str, str], labels: Dict[str, str]) -> bool:
    """True when every selector key/value pair appears in ``labels``.

    Empty selectors match nothing (a service without a selector is
    headless/external and backs no pods directly).
    """
    if not selector:
        return False
    return all(labels.get(k) == v for k, v in selector.items())


class SelectorIndex:
    """Inverted index over N selectors for O(labels) matching per query.

    Single-label selectors (the overwhelmingly common case) resolve by one
    dict lookup per label item; multi-label selectors index on their first
    item and verify the full subset only for those candidates.  Replaces the
    O(N) scan per workload/pod that made graph building quadratic.
    """

    def __init__(self, selectors: Sequence[Dict[str, str]]):
        self.selectors = list(selectors)
        self._by_item: Dict[Tuple[str, str], List[int]] = {}
        for j, sel in enumerate(self.selectors):
            if not sel:
                continue
            # index on the lexicographically-first item for determinism
            key = min(sel.items())
            self._by_item.setdefault(key, []).append(j)

    def matches(self, labels: Dict[str, str]) -> List[int]:
        """Indices of all selectors matching ``labels``, ascending."""
        if not labels:
            return []
        hits: List[int] = []
        for item in labels.items():
            for j in self._by_item.get(item, ()):
                sel = self.selectors[j]
                if len(sel) == 1 or selector_matches(sel, labels):
                    hits.append(j)
        hits.sort()
        return hits
