"""causelens: provenance blocks, attribution digests and blame trees (the
port's copy of ``rca_tpu.observability.causelens``).

The engine half lives in :mod:`rca_tpu_torch.engine.attribution`; this
module wraps its block as the schema-versioned ``provenance`` object that
rides findings JSON, digests it, and renders the ASCII blame tree.

Digest contract: :func:`attribution_digest` hashes a canonicalized
(float-rounded) copy of the block, so the digest is stable across a JSON
round trip while still pinning every attribution value to ~1e-6.  The
block holds no wall time, so recomputing it gives the same digest.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional

#: provenance wrapper schema (the inner attribution block carries its own)
PROVENANCE_SCHEMA = 1

#: float rounding applied before digesting (decimal places): wide enough
#: that any real attribution change moves the digest, tight enough that
#: JSON round-trip representation noise cannot
_DIGEST_DECIMALS = 6


def digest_obj(obj: Any) -> str:
    """Stable content digest of a JSON-able object (the reference's
    ``replay/format.py::digest_obj``, copied)."""
    blob = json.dumps(obj, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:16]


def _canonical(obj: Any) -> Any:
    if isinstance(obj, float):
        return round(obj, _DIGEST_DECIMALS)
    if isinstance(obj, dict):
        return {k: _canonical(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    return obj


def attribution_digest(block: Optional[Dict[str, Any]]) -> Optional[str]:
    """Stable content digest of one attribution/provenance block (None
    in = None out)."""
    if block is None:
        return None
    return digest_obj(_canonical(block))


def provenance_block(
    attribution: Dict[str, Any],
    engine: Optional[str] = None,
    source: str = "causelens",
) -> Dict[str, Any]:
    """Wrap an engine attribution block as the ``provenance`` object
    findings JSON carries: schema-versioned, digested, with the producing
    engine stamped."""
    out: Dict[str, Any] = {
        "schema": PROVENANCE_SCHEMA,
        "source": source,
        "attribution": attribution,
        "digest": attribution_digest(attribution),
    }
    if engine is not None:
        out["engine"] = engine
    return out


# -- rendering ----------------------------------------------------------------

def _fmt(x: Any, nd: int = 3) -> str:
    if isinstance(x, float):
        return f"{x:.{nd}f}"
    return str(x)


def render_blame_tree(provenance: Dict[str, Any],
                      max_channels: int = 4,
                      max_counterfactuals: int = 3) -> str:
    """The ASCII blame tree: evidence channels → blame edges → ranked
    service, one box per candidate.  Takes either the wrapped provenance
    block or a bare engine attribution block."""
    block = provenance.get("attribution", provenance)
    lines: List[str] = []
    lines.append(
        f"causelens v{block.get('schema', '?')} · "
        f"{block.get('n_services', '?')} services / "
        f"{block.get('n_edges', '?')} edges · kernel "
        f"{block.get('kernel') or '-'} · formula "
        f"v{block.get('score_formula_version', '?')}"
    )
    digest = provenance.get("digest")
    if digest:
        lines.append(f"digest {digest}")
    cands = block.get("candidates") or []
    if not cands:
        lines.append("(no ranked candidates to attribute)")
        return "\n".join(lines)
    for entry in cands:
        lines.append("")
        lines.append(
            f"#{entry.get('rank')} {entry.get('component')}"
            f"  score {_fmt(entry.get('score'))}"
        )
        factors = entry.get("factors") or {}
        rec_err = entry.get("reconstruction_error")
        err_s = f"{rec_err:.1e}" if isinstance(rec_err, float) else "-"
        lines.append(
            f"├─ factors: evidence {_fmt(factors.get('evidence'))}"
            f" × impact {_fmt(factors.get('impact'))}"
            f" × suppression {_fmt(factors.get('suppression'))}"
            f"   (rebuilt {_fmt(entry.get('reconstructed_score'))},"
            f" err {err_s})"
        )
        channels = sorted(
            entry.get("channels") or [],
            key=lambda c: -c.get("contribution", 0.0),
        )[:max_channels]
        if channels:
            lines.append(
                "├─ evidence: " + " · ".join(
                    f"{c['channel']} {_fmt(c.get('contribution'), 2)}"
                    for c in channels
                )
            )
        path = entry.get("blame_path") or []
        if path:
            hops = " → ".join(
                f"{hop['to']} (h {_fmt(hop.get('hard'), 2)})"
                for hop in path
            )
            lines.append(f"├─ blame path: {entry.get('component')} → {hops}")
        else:
            lines.append("├─ blame path: (no broken upstream dependency)")
        cf = [
            c for c in (entry.get("counterfactuals") or [])
            if c.get("score_drop", 0.0) != 0.0
        ][:max_counterfactuals]
        if cf:
            lines.append(
                "└─ counterfactuals: " + " · ".join(
                    ("-self" if c.get("self")
                     else f"-{c['component']}")
                    + f" Δ{_fmt(c.get('score_drop'))}"
                    for c in cf
                )
            )
        else:
            lines.append("└─ counterfactuals: (none moved this score)")
    rows = block.get("saliency_rows") or []
    if rows:
        lines.append("")
        lines.append(
            "saliency (∂score/∂features, top rows): " + " · ".join(
                f"{r['component']} {_fmt(r.get('grad_l1'), 2)}"
                for r in rows[:5]
            )
        )
    return "\n".join(lines)
