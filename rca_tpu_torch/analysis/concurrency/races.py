"""Guarded-by inference + race findings over the concurrency model (the
port's copy of ``rca_tpu.analysis.concurrency.races``).

The discipline is Eraser's lockset algorithm run statically over the
model's traversal output: every write to ``Class.attr`` is observed as
(thread root, receiver context, locks held on every path).  Two
observations RACE when

- they come from different thread roots (or the same root spawned more
  than once — two copies of one entry point are just as concurrent),
- their receiver contexts can name the same object
  (:meth:`model.Context.pairs_with` — the instance-identity
  approximation), and
- their lock sets are DISJOINT: no common lock orders the two writes.

For attributes that are locked *somewhere*, the **dominant guard** (the
most frequently held lock across that attribute's write sites) names the
convention the offending site broke; attributes never locked anywhere
are flagged only on read-modify-write shapes (``+=``, container
mutation) — an unshared-lock plain assignment is publication, not a lost
update.  A separate deterministic check flags **class attributes**
mutated inside methods: a per-instance lock cannot guard class-shared
state, whatever the roots (the shape behind the watch-pump token
counter bug the reference analyzer's first run surfaced).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

from rca_tpu_torch.analysis.concurrency.model import (
    ConcurrencyModel,
    Observation,
)


@dataclasses.dataclass
class RaceFinding:
    relpath: str
    lineno: int
    func: str             # enclosing function qual (for allowlists)
    cls: str
    attr: str
    roots: Tuple[str, ...]
    dominant: Optional[str]
    held: Tuple[str, ...]  # locks held at the flagged site

    def message(self) -> str:
        roots = ", ".join(self.roots)
        held = (" while holding only {" + ", ".join(self.held) + "}"
                if self.held else " with no lock held")
        if self.dominant:
            return (
                f"`self.{self.attr}` is written from threads [{roots}]"
                f"{held}, but its dominant guard is `{self.dominant}` — "
                "racing the locked writers loses updates silently"
            )
        return (
            f"read-modify-write of `self.{self.attr}` from threads "
            f"[{roots}] with no common lock — concurrent `+=`/mutation "
            "interleaves and drops updates"
        )


@dataclasses.dataclass
class ClassAttrFinding:
    relpath: str
    lineno: int
    func: str
    cls: str
    attr: str
    under_lock: bool

    def message(self) -> str:
        tail = (
            "a per-instance lock cannot guard class-shared state"
            if self.under_lock else
            "class-shared state mutated with no guard at all"
        )
        return (
            f"`{self.cls}.{self.attr}` (a CLASS attribute) is mutated "
            f"inside a method — {tail}; use a module-level lock or an "
            "atomic counter (itertools.count)"
        )


def _conflicts(a: Observation, b: Observation) -> bool:
    if a.root.root_id == b.root.root_id and not a.root.multi:
        return False
    if not a.ctx.pairs_with(b.ctx):
        return False
    if a.locks & b.locks:
        return False
    return True


def analyze_races(model: ConcurrencyModel) -> List[RaceFinding]:
    cached = getattr(model, "_race_findings", None)
    if cached is not None:
        return cached
    findings: List[RaceFinding] = []
    for (cls, attr), obs in sorted(model.observations.items()):
        # dominant guard: the most frequently held lock across this
        # attribute's distinct write SITES (not chains, so a hot path
        # does not outvote the convention)
        site_locks: Dict[Tuple[str, int], set] = {}
        for o in obs:
            key = (o.site.func, o.site.lineno)
            cur = site_locks.get(key)
            site_locks[key] = (set(o.locks) if cur is None
                               else cur & set(o.locks))
        counts = collections.Counter()
        for locks in site_locks.values():
            counts.update(locks)
        dominant = counts.most_common(1)[0][0] if counts else None

        # conflicting observation pairs -> flag the unguarded side(s)
        flagged: Dict[Tuple[str, int], RaceFinding] = {}
        for i, a in enumerate(obs):
            for b in obs[i:]:
                if a is b and not a.root.multi:
                    continue
                if not _conflicts(a, b):
                    continue
                pair_roots = tuple(sorted(
                    {a.root.root_id, b.root.root_id}
                ))
                for o in (a, b):
                    unguarded = (
                        dominant is not None and dominant not in o.locks
                    ) or (
                        dominant is None
                        and o.site.kind in ("augassign", "mutcall")
                    )
                    if not unguarded:
                        continue
                    key = (o.site.func, o.site.lineno)
                    if key in flagged:
                        flagged[key].roots = tuple(sorted(
                            set(flagged[key].roots) | set(pair_roots)
                        ))
                        continue
                    flagged[key] = RaceFinding(
                        relpath=o.site.func.split("::")[0],
                        lineno=o.site.lineno,
                        func=o.site.func.split("::")[-1].split(".")[-1],
                        cls=cls, attr=attr, roots=pair_roots,
                        dominant=dominant,
                        held=tuple(sorted(o.locks)),
                    )
        findings.extend(flagged.values())
    findings.sort(key=lambda f: (f.relpath, f.lineno, f.attr))
    model._race_findings = findings  # one analysis per model build
    return findings


def analyze_class_attrs(model: ConcurrencyModel) -> List[ClassAttrFinding]:
    out = []
    for w in model.class_attr_writes:
        out.append(ClassAttrFinding(
            relpath=w.func.split("::")[0], lineno=w.lineno,
            func=w.func.split("::")[-1].split(".")[-1],
            cls=w.cls, attr=w.attr, under_lock=bool(w.locks),
        ))
    out.sort(key=lambda f: (f.relpath, f.lineno))
    return out
