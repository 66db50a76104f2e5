"""graftlint core: rule registry, suppressions, baseline, runner (the
port's copy of ``rca_tpu.analysis.core``, scanning the port).

The framework behind ``python -m rca_tpu_torch lint``.  The moving parts:

- :class:`Rule` subclasses register themselves via :func:`register`; each
  rule scopes itself (``applies_to``), carries per-file/per-function
  allowlists (``allow``), and emits :class:`Finding`\\ s from one shared
  parse of each file;
- ``# graftlint: disable=<rule>[,<rule>]`` on a flagged line suppresses it;
  ``# graftlint: disable-file=<rule>`` anywhere in a file suppresses the
  rule for the whole file (``all`` works in both);
- a checked-in baseline (``rca_tpu_torch/analysis/baseline.json``) holds
  accepted legacy hits as content fingerprints (rule + path + source
  line), so baselined findings survive line drift but die with the code
  that earned them; stale entries are reported so the baseline only ever
  shrinks.  It ships empty;
- exit-code contract (``python -m rca_tpu_torch.analysis``): 0 clean, 1
  findings, 2 usage/internal error.

The scan set is the port (``rca_tpu_torch/``), ``chip_smoke.py`` and the
port's tests (``tests/test_torch_*.py``); the fingerprint index of
``--changed`` lives under ``.graftlint_torch/``.
"""

from __future__ import annotations

import ast
import collections
import dataclasses
import hashlib
import json
import os
import re
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

# scanned by default, relative to the repo root (rules narrow further via
# applies_to; the port's tests are included so the repo-wide rules cover
# them)
SCAN_DIRS = ("rca_tpu_torch",)
SCAN_FILES = ("chip_smoke.py",)
#: the port's test files: ``tests/<prefix>*.py``
SCAN_TEST_PREFIX = "test_torch_"

_SUPPRESS_LINE = re.compile(r"#\s*graftlint:\s*disable=([\w,\- ]+)")
_SUPPRESS_FILE = re.compile(r"^\s*#\s*graftlint:\s*disable-file=([\w,\- ]+)")

#: process-wide shared parse cache: ONE ast.parse per file per run even
#: though several analyses walk the same files.  Keyed by absolute path, validated by
#: (mtime_ns, size) so an edited file reparses.  Single-threaded by
#: design (the lint is sequential; a stale double-parse is the only
#: failure mode anyway).  Trees served from here are SHARED — callers
#: must treat them as read-only.
_PARSE_CACHE: Dict[str, Tuple[Tuple[int, int], str, ast.AST]] = {}
_PARSE_STATS = {"hits": 0, "misses": 0}


def parse_file(full: str) -> Tuple[str, ast.AST]:
    """(source, tree) for ``full`` via the shared cache.  SyntaxError /
    OSError propagate to the caller, exactly like the direct parse."""
    full = os.path.abspath(full)
    st = os.stat(full)
    key = (st.st_mtime_ns, st.st_size)
    hit = _PARSE_CACHE.get(full)
    if hit is not None and hit[0] == key:
        _PARSE_STATS["hits"] += 1
        return hit[1], hit[2]
    _PARSE_STATS["misses"] += 1
    with open(full, encoding="utf-8") as f:
        source = f.read()
    tree = ast.parse(source, filename=full)
    _PARSE_CACHE[full] = (key, source, tree)
    return source, tree


def parse_cache_stats() -> Dict[str, int]:
    """Cumulative process-wide hit/miss counters (:func:`run_lint` reports
    the delta of its run)."""
    return dict(_PARSE_STATS)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int          # 1-based
    message: str
    snippet: str = ""  # stripped source of the flagged line
    func: str = ""     # enclosing function ("<module>" at top level)

    def fingerprint(self) -> str:
        """Content fingerprint for the baseline: stable across pure line
        drift (code above moving), invalidated when the flagged line
        itself changes — a baselined hit cannot silently mutate."""
        blob = f"{self.rule}|{self.path}|{self.snippet}"
        return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "message": self.message, "snippet": self.snippet,
            "fingerprint": self.fingerprint(),
        }


class FileContext:
    """One parsed file, shared by every rule that scans it."""

    def __init__(self, relpath: str, source: str, tree: ast.AST,
                 root: Optional[str] = None):
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        # repo root of this lint run: interprocedural rules build their
        # whole-package model from it, then report only the findings that
        # live in THIS file
        self.root = root or repo_root()
        self.cache: Dict[str, object] = {}  # cross-rule analysis memos

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: "Rule", lineno: int, message: str,
                func: str = "") -> Finding:
        return Finding(
            rule=rule.name, path=self.relpath, line=lineno,
            message=message, snippet=self.line(lineno), func=func,
        )

    def file_suppressed(self) -> Set[str]:
        """Rule names disabled for the whole file."""
        out: Set[str] = set()
        for line in self.lines:
            m = _SUPPRESS_FILE.match(line)
            if m:
                out |= {r.strip() for r in m.group(1).split(",") if r.strip()}
        return out

    def line_suppressed(self, lineno: int) -> Set[str]:
        """Rule names disabled on one line (trailing comment)."""
        m = _SUPPRESS_LINE.search(self.line(lineno))
        if not m:
            return set()
        return {r.strip() for r in m.group(1).split(",") if r.strip()}


class Rule:
    """One lint rule.  Subclass, set ``name``/``summary``/``why``, implement
    ``scan``, and decorate with :func:`register`."""

    name: str = ""
    summary: str = ""   # one line for --list-rules / README
    why: str = ""       # the production failure mode this rule prevents
    # per-file allowlist: repo-relative path -> function names exempt from
    # this rule in that file (the framework filters on Finding.func)
    allow: Dict[str, Set[str]] = {}

    def applies_to(self, relpath: str) -> bool:
        return True

    def scan(self, ctx: FileContext) -> List[Finding]:
        raise NotImplementedError


_REGISTRY: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate the rule and add it to the registry."""
    rule = cls()
    if not rule.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    if rule.name in _REGISTRY:
        raise ValueError(f"duplicate rule name {rule.name!r}")
    _REGISTRY[rule.name] = rule
    return cls


def all_rules() -> Dict[str, Rule]:
    """The registry, importing the bundled rule modules on first use."""
    import rca_tpu_torch.analysis.rules  # noqa: F401  (registers on import)

    return dict(sorted(_REGISTRY.items()))


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))


def default_baseline_path(root: Optional[str] = None) -> str:
    return os.path.join(root or repo_root(), "rca_tpu_torch", "analysis",
                        "baseline.json")


# -- baseline ---------------------------------------------------------------

def load_baseline(path: str) -> List[dict]:
    """Baseline entries (``[]`` when the file is absent)."""
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    entries = data.get("entries", [])
    for e in entries:
        if not {"rule", "path", "fingerprint"} <= set(e):
            raise ValueError(f"malformed baseline entry: {e!r}")
    return entries


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    entries = [
        {"rule": f.rule, "path": f.path, "fingerprint": f.fingerprint(),
         "snippet": f.snippet}
        for f in sorted(findings, key=lambda f: (f.rule, f.path, f.line))
    ]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=2)
        f.write("\n")


# -- incremental lint (`lint --changed`) -------------------------------------
#
# A fingerprint index (content sha1 per scanned file) lives under
# .graftlint_torch/ in the repo root (the JAX package's lint keeps its own
# under .graftlint/); every lint run that scans the default set refreshes
# it.  `--changed` lints only the files that are git-dirty OR whose content
# no longer matches the index.

INDEX_DIR = ".graftlint_torch"


def index_path(root: str) -> str:
    return os.path.join(root, INDEX_DIR, "index.json")


def _sha1_file(path: str) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def load_index(root: str) -> Dict[str, str]:
    path = index_path(root)
    if not os.path.exists(path):
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        files = data.get("files", {})
        return {k: v for k, v in files.items() if isinstance(v, str)}
    except (json.JSONDecodeError, OSError):
        return {}


def update_index(root: str, files: Sequence[str]) -> None:
    """Refresh index entries for ``files`` (repo-relative).  Best-effort:
    an unwritable tree must not fail the lint."""
    idx = load_index(root)
    for rel in files:
        full = os.path.join(root, rel)
        try:
            idx[rel] = _sha1_file(full)
        except OSError:
            idx.pop(rel, None)
    # atomic publish: write a sibling temp file and rename over the
    # index, so a crash mid-write leaves the previous index intact
    # (readers never observe a torn JSON document)
    tmp = index_path(root) + f".tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(index_path(root)), exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"version": 1, "files": idx}, f, indent=0,
                      sort_keys=True)
            f.write("\n")
        os.replace(tmp, index_path(root))
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _git_dirty(root: str) -> Set[str]:
    """Repo-relative paths git considers modified/untracked (empty set
    when git is unavailable — the fingerprint index still works)."""
    import subprocess

    try:
        proc = subprocess.run(
            ["git", "-C", root, "status", "--porcelain", "-z"],
            capture_output=True, timeout=10,
        )
    except (OSError, subprocess.TimeoutExpired):
        return set()
    if proc.returncode != 0:
        return set()
    out: Set[str] = set()
    for entry in proc.stdout.decode("utf-8", "replace").split("\0"):
        if len(entry) < 4:
            continue
        path = entry[3:]
        out.add(path.replace(os.sep, "/"))
    return out


def changed_files(root: str) -> List[str]:
    """The subset of the default scan set that is git-dirty or whose
    content differs from the cached fingerprint index."""
    scan = discover_files(root)
    dirty = _git_dirty(root)
    idx = load_index(root)
    out = []
    for rel in scan:
        if rel in dirty:
            out.append(rel)
            continue
        try:
            digest = _sha1_file(os.path.join(root, rel))
        except OSError:
            out.append(rel)
            continue
        if idx.get(rel) != digest:
            out.append(rel)
    return out


# -- runner -----------------------------------------------------------------

@dataclasses.dataclass
class LintResult:
    findings: List[Finding]
    suppressed: int
    baselined: int
    stale_baseline: List[dict]
    files_scanned: int
    wall_ms: float
    per_rule_ms: Dict[str, float]
    #: shared-parse-cache hits/misses attributable to this run
    parse_cache: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "clean": self.clean,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": self.suppressed,
            "baselined": self.baselined,
            "stale_baseline": self.stale_baseline,
            "files_scanned": self.files_scanned,
            "wall_ms": round(self.wall_ms, 3),
            "per_rule_ms": {
                k: round(v, 3) for k, v in sorted(self.per_rule_ms.items())
            },
            "parse_cache": dict(self.parse_cache),
        }


def discover_files(root: str, paths: Optional[Sequence[str]] = None
                   ) -> List[str]:
    """Repo-relative paths (forward slashes) to scan.  Explicit ``paths``
    (files or directories, relative to root or absolute) override the
    default scan set."""
    rels: List[str] = []
    if paths:
        for p in paths:
            full = p if os.path.isabs(p) else os.path.join(root, p)
            if os.path.isdir(full):
                for dirpath, _dirs, files in os.walk(full):
                    rels += [
                        os.path.join(dirpath, f)
                        for f in files if f.endswith(".py")
                    ]
            elif os.path.exists(full):
                rels.append(full)
            else:
                raise FileNotFoundError(p)
        return sorted(
            os.path.relpath(r, root).replace(os.sep, "/") for r in rels
        )
    for d in SCAN_DIRS:
        base = os.path.join(root, d)
        for dirpath, _dirs, files in os.walk(base):
            rels += [
                os.path.join(dirpath, f) for f in files if f.endswith(".py")
            ]
    rels += [
        os.path.join(root, f) for f in SCAN_FILES
        if os.path.exists(os.path.join(root, f))
    ]
    tests = os.path.join(root, "tests")
    if os.path.isdir(tests):
        rels += [
            os.path.join(tests, f) for f in os.listdir(tests)
            if f.startswith(SCAN_TEST_PREFIX) and f.endswith(".py")
        ]
    return sorted(
        os.path.relpath(r, root).replace(os.sep, "/") for r in rels
    )


def run_lint(
    root: Optional[str] = None,
    rules: Optional[Sequence[str]] = None,
    baseline_path: Optional[str] = None,
    paths: Optional[Sequence[str]] = None,
    use_baseline: bool = True,
) -> LintResult:
    """Run the selected rules over the repo (or ``paths``) and fold in
    suppressions + baseline.  Pure function of the tree on disk."""
    t0 = time.perf_counter()
    root = root or repo_root()
    registry = all_rules()
    if rules:
        unknown = set(rules) - set(registry)
        if unknown:
            raise KeyError(
                f"unknown rule(s): {', '.join(sorted(unknown))} "
                f"(have: {', '.join(registry)})"
            )
        selected = [registry[r] for r in rules]
    else:
        selected = list(registry.values())

    raw: List[Finding] = []
    suppressed = 0
    per_rule_ms: Dict[str, float] = {r.name: 0.0 for r in selected}
    pc0 = parse_cache_stats()
    files = discover_files(root, paths)
    for rel in files:
        full = os.path.join(root, rel)
        applicable = [r for r in selected if r.applies_to(rel)]
        if not applicable:
            continue
        try:
            source, tree = parse_file(full)
        except (SyntaxError, OSError) as exc:
            lineno = getattr(exc, "lineno", 0) or 0
            raw.append(Finding(
                rule="parse-error", path=rel, line=lineno,
                message=f"{type(exc).__name__}: {exc}",
            ))
            continue
        ctx = FileContext(rel, source, tree, root=root)
        file_off = ctx.file_suppressed()
        for rule in applicable:
            if rule.name in file_off or "all" in file_off:
                continue
            rt0 = time.perf_counter()
            for finding in rule.scan(ctx):
                allowed_funcs = rule.allow.get(rel, set())
                line_off = ctx.line_suppressed(finding.line)
                if finding.func in allowed_funcs:
                    continue
                if rule.name in line_off or "all" in line_off:
                    suppressed += 1
                    continue
                raw.append(finding)
            per_rule_ms[rule.name] += (time.perf_counter() - rt0) * 1e3

    # baseline filter: consume entries as a multiset so N identical
    # baselined lines absorb exactly N findings, not unlimited ones
    baselined = 0
    stale: List[dict] = []
    findings = raw
    if use_baseline:
        bpath = baseline_path or default_baseline_path(root)
        entries = load_baseline(bpath)
        budget = collections.Counter(
            (e["rule"], e["path"], e["fingerprint"]) for e in entries
        )
        findings = []
        for f in raw:
            key = (f.rule, f.path, f.fingerprint())
            if budget.get(key, 0) > 0:
                budget[key] -= 1
                baselined += 1
            else:
                findings.append(f)
        ran = {r.name for r in selected} | {"parse-error"}
        scanned = set(files)
        stale = [
            {"rule": rule, "path": path, "fingerprint": fp, "count": n}
            for (rule, path, fp), n in sorted(budget.items()) if n > 0
            # only entries this run could have matched count as stale
            if rule in ran and path in scanned
        ]

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    pc1 = parse_cache_stats()
    return LintResult(
        findings=findings, suppressed=suppressed, baselined=baselined,
        stale_baseline=stale, files_scanned=len(files),
        wall_ms=(time.perf_counter() - t0) * 1e3, per_rule_ms=per_rule_ms,
        parse_cache={k: pc1[k] - pc0[k] for k in ("hits", "misses")},
    )
