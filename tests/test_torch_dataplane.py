"""graftspec's static half in the port (``rca_tpu_torch/analysis/
dataplane/absint.py``, ``dtype-discipline``, ``shape-contract``) against
the JAX package's.

- every fixture of the reference's graftspec tests has a twin here: the
  jnp fixture goes through the reference's rule, its torch spelling
  through the port's, and both give the same rule ids, lines and count;
- the port's tree sweeps clean on both rules with an empty baseline, and
  the two fetch-role breaks the rules found are pinned as regressions;
- the interpreter is honest (UNKNOWN conforms), its ``promote`` is
  torch's (held against ``torch.result_type`` for every pair of the
  dtypes it names at ranks 0 and 1; the 0-dim rule is the one stated
  difference from the reference's jnp promotion), and its summaries equal
  what it proves from the bodies they summarise;
- the static facts of each ``RANKED_SIGNATURES`` entry equal the shapes
  and dtypes of what the real function returns on the CPU (129 services,
  k = 7, B = 4), and each entry agrees with its ``REFERENCE_SIGNATURES``
  twin on every shared role but the deviations the table names.
"""

from __future__ import annotations

import ast
import itertools
import json
import os

import numpy as np
import pytest
import torch

from rca_tpu.analysis import run_lint as ref_run_lint
from rca_tpu.analysis.dataplane import absint as ref_absint
from rca_tpu.analysis.dataplane import contracts as ref_contracts
from rca_tpu_torch.analysis import repo_root, run_lint
from rca_tpu_torch.analysis.__main__ import main as port_main
from rca_tpu_torch.analysis.dataplane import absint, contracts

ROOT = repo_root()
RULES = ("shape-contract", "dtype-discipline")
F, S = contracts.Fact, contracts.Sym


def _fake_repo(root, *entries):
    for rel, src in entries:
        full = root / rel
        full.parent.mkdir(parents=True, exist_ok=True)
        full.write_text(src)
    return str(root)


def _hits(result):
    return sorted((f.rule, f.line) for f in result.findings)


def _both(tmp_path, ref_entries, port_entries, rule):
    """The reference's fixture through its rule, the torch spelling
    through the port's: ``(ref findings, port findings)`` as sorted
    ``(rule, line)`` lists."""
    ref = ref_run_lint(root=_fake_repo(tmp_path / "ref", *ref_entries),
                       rules=[rule], use_baseline=False)
    port = run_lint(root=_fake_repo(tmp_path / "port", *port_entries),
                    rules=[rule], use_baseline=False)
    return _hits(ref), _hits(port)


# ---------------------------------------------------------------------------
# the reference's fixtures and their torch twins
# ---------------------------------------------------------------------------

_REF_PADS = """\
import numpy as np

def build(n, m, seg):
    n_pad = n + 1                                        # not provable
    e_pad = bucket_for(m)                                # provable
    o_pad = max(8, len(seg))                             # the r19 bug
    q_pad = max(8, 1 << max(0, (m - 1).bit_length()))    # the r19 fix
    bad_fill = np.full(8, 0, np.int32)                   # literal row id
    no_dtype = np.zeros((8, 4))                          # host float64
    ok_fill = np.full(8, n_pad - 1, np.int32)
    ok_buf = np.zeros((8, 4), np.float32)
    return n_pad, e_pad, o_pad, q_pad, bad_fill, no_dtype, ok_fill, ok_buf
"""

_TORCH_PADS = """\
import torch

def build(n, m, seg):
    n_pad = n + 1                                        # not provable
    e_pad = bucket_for(m)                                # provable
    o_pad = max(8, len(seg))                             # not provable
    q_pad = max(8, pow2_pad(m))                          # provable
    bad_fill = torch.full((8,), 0, dtype=torch.int64)    # literal row id
    no_dtype = torch.zeros((8, 4))                       # no dtype
    ok_fill = torch.full((8,), n_pad - 1, dtype=torch.int64)
    ok_buf = torch.zeros((8, 4), dtype=torch.float32)
    return n_pad, e_pad, o_pad, q_pad, bad_fill, no_dtype, ok_fill, ok_buf
"""


@pytest.mark.parametrize("spelling", ["numpy", "torch"])
def test_shape_contract_pad_and_staging_fixtures(tmp_path, spelling):
    port_src = _REF_PADS if spelling == "numpy" else _TORCH_PADS
    ref, port = _both(tmp_path, [("rca_tpu/engine/ell.py", _REF_PADS)],
                      [("rca_tpu_torch/engine/ell.py", port_src)],
                      "shape-contract")
    assert ref == port == [("shape-contract", line)
                           for line in (4, 6, 8, 9)]


def test_shape_contract_proves_the_ports_pad_spellings(tmp_path):
    """``pow2_pad(u)``, ``bucket_for``, the shift and the dp alignment of
    the serve dispatcher are provable; a count that is pow2 by accident is
    not."""
    src = """\
def pads(u, b, dp, n, buckets):
    u_pad = pow2_pad(u)
    n_pad = bucket_for(n + 1, buckets)
    b_pad = 1 << max(0, (b - 1).bit_length())
    b_pad = -(-b_pad // dp) * dp
    o_pad = max(8, 1 << max(0, (u - 1).bit_length()))
    x_pad = 2 * u
    return u_pad, n_pad, b_pad, o_pad, x_pad
"""
    root = _fake_repo(tmp_path, ("rca_tpu_torch/serve/dispatcher.py", src))
    got = run_lint(root=root, rules=["shape-contract"], use_baseline=False)
    assert _hits(got) == [("shape-contract", 7)]


_REF_GOOD_SIG = """\
import jax.numpy as jnp
from jax import lax

def _propagate_ranked(features, edges, anomaly_w, hard_w, k):
    anomaly, upstream, impact, score, resid = propagate_auto(
        features, edges, anomaly_w, hard_w)
    features, n_bad = finite_mask_rows(features)
    stacked = jnp.stack((anomaly, upstream, impact, score))
    vals, idx = lax.top_k(score, k)
    diag = stacked[:, idx]
    return stacked, diag, vals, idx, n_bad
"""

_PORT_GOOD_SIG = """\
import torch
from torch import nn

def propagate_ranked(model, features, dep_dst, n_live, kk, plan):
    a, h, u, m, score, n_bad = propagate_auto(
        model, features, dep_dst, n_live, plan)
    vals, idx = top_k(score, kk)
    stacked = torch.stack([a, u, m, score], dim=-2)
    diag = topk_diag(stacked, idx)
    return stacked, diag, vals, idx, n_bad
"""


@pytest.mark.parametrize("case", ["conforming", "swapped"])
def test_shape_contract_ranked_signature_conformance(tmp_path, case):
    """A conforming ranked body proves its declared signature; a twin
    returning (idx, vals) swapped breaks the dtype contract at both
    positions, in both packages."""
    ref_src, port_src = _REF_GOOD_SIG, _PORT_GOOD_SIG
    if case == "swapped":
        ref_src = ref_src.replace("return stacked, diag, vals, idx, n_bad",
                                  "return stacked, diag, idx, vals, n_bad")
        port_src = port_src.replace("return stacked, diag, vals, idx, n_bad",
                                    "return stacked, diag, idx, vals, n_bad")
    ref, port = _both(tmp_path, [("rca_tpu/engine/runner.py", ref_src)],
                      [("rca_tpu_torch/engine/runner.py", port_src)],
                      "shape-contract")
    assert ref == port
    assert len(port) == (0 if case == "conforming" else 2)
    if case == "swapped":
        result = run_lint(root=str(tmp_path / "port"),
                          rules=["shape-contract"], use_baseline=False)
        assert all("ranked signature contract" in f.message
                   for f in result.findings)


def test_shape_contract_arity_break(tmp_path):
    ref_src = """\
def _propagate_ranked(features, edges, anomaly_w, hard_w, k):
    features, n_bad = finite_mask_rows(features)
    return features, n_bad
"""
    port_src = """\
def propagate_ranked(model, features, dep_dst, n_live, kk, plan):
    features, n_bad = finite_mask_rows(features)
    return features, n_bad
"""
    ref, port = _both(tmp_path, [("rca_tpu/engine/runner.py", ref_src)],
                      [("rca_tpu_torch/engine/runner.py", port_src)],
                      "shape-contract")
    assert ref == port == [("shape-contract", 1)]
    result = run_lint(root=str(tmp_path / "port"), rules=["shape-contract"],
                      use_baseline=False)
    assert "returns 2 values, contract declares 5" in \
        result.findings[0].message


def test_shape_contract_undeclared_fetch_role(tmp_path):
    """A seam call moving a leaf no FETCH_BUDGETS role declares is an
    undeclared transfer; declared roles (any order/subset, through a
    cast) are fine."""
    ref_src = """\
import jax

def timed_fetch(run):
    vals, idx = jax.device_get((vals_dev, topi))
    everything = jax.device_get((vals_dev, stacked_full))
    return vals, idx, everything
"""
    port_src = """\
from rca_tpu_torch.engine.fetch import device_get

def timed_fetch(run):
    vals, idx = device_get(vals_dev, topi.to(torch.int32))
    everything = device_get(vals_dev, stacked_full)
    return vals, idx, everything
"""
    ref, port = _both(tmp_path, [("rca_tpu/engine/runner.py", ref_src)],
                      [("rca_tpu_torch/engine/runner.py", port_src)],
                      "shape-contract")
    assert ref == port == [("shape-contract", 5)]


def test_shape_contract_reads_hostcopy_leaves_and_unpacked_names(tmp_path):
    """``HostCopy(...)`` is the seam too: its leaves and the names its
    ``.numpy()`` unpacks into are roles of the surface that starts it."""
    src = """\
def dispatch(self):
    result = HostCopy(vals, idx.to(torch.int32), n_bad)
    extra = HostCopy(vals, self._features)
    vals_h, scores = HostCopy(vals, idx).numpy()
    return result, extra, vals_h, scores
"""
    root = _fake_repo(tmp_path, ("rca_tpu_torch/engine/streaming.py", src))
    got = run_lint(root=root, rules=["shape-contract"], use_baseline=False)
    assert _hits(got) == [("shape-contract", 3), ("shape-contract", 4)]


_LOW_SPELLINGS = {
    "to": "return x.to(torch.bfloat16)",
    "to_kw": "return x.to(device=x.device, dtype=torch.half)",
    "method_bf16": "return x.bfloat16()",
    "method_half": "return x.half()",
    "type": "return x.type(torch.float16)",
    "constructor": "return torch.zeros(4, dtype=torch.bfloat16)",
    "new_zeros": "return x.new_zeros(4, dtype=torch.float16)",
}


@pytest.mark.parametrize("spelling", sorted(_LOW_SPELLINGS))
def test_dtype_low_precision_cast_fires_outside_quantized(tmp_path,
                                                          spelling):
    body = _LOW_SPELLINGS[spelling]
    ref_entries = [
        ("rca_tpu/engine/foo.py",
         "import jax.numpy as jnp\n\ndef f(x):\n"
         "    return x.astype(jnp.bfloat16)\n"),
        ("rca_tpu/engine/quantized.py",
         "import jax.numpy as jnp\n\ndef q(x):\n"
         "    return x.astype(jnp.bfloat16)\n"),
    ]
    port_entries = [
        ("rca_tpu_torch/engine/foo.py",
         f"import torch\n\ndef f(x):\n    {body}\n"),
        ("rca_tpu_torch/engine/quantized.py",
         f"import torch\n\ndef q(x):\n    {body}\n"),
    ]
    ref = ref_run_lint(root=_fake_repo(tmp_path / "ref", *ref_entries),
                       rules=["dtype-discipline"], use_baseline=False)
    port = run_lint(root=_fake_repo(tmp_path / "port", *port_entries),
                    rules=["dtype-discipline"], use_baseline=False)
    assert [(f.rule, f.line) for f in port.findings] == [
        (f.rule, f.line) for f in ref.findings] == [("dtype-discipline", 4)]
    assert [f.path for f in port.findings] == ["rca_tpu_torch/engine/foo.py"]


@pytest.mark.parametrize("spelling", ["as_tensor", "char", "to"])
def test_dtype_int8_device_vs_host_metadata(tmp_path, spelling):
    """torch-rooted int8 is kernel arithmetic (fires); np-rooted int8 in a
    host module is a compact metadata tag (legal — graph/build.py)."""
    ref_src = """\
import numpy as np
import jax.numpy as jnp

def tag(x):
    host = np.asarray(x, dtype=np.int8)
    dev = jnp.asarray(x, dtype=jnp.int8)
    return host, dev
"""
    dev = {"as_tensor": "torch.as_tensor(x, dtype=torch.int8)",
           "char": "torch.as_tensor(x).char()",
           "to": "torch.as_tensor(x).to(torch.int8)"}[spelling]
    port_src = ref_src.replace("import jax.numpy as jnp", "import torch")
    port_src = port_src.replace("jnp.asarray(x, dtype=jnp.int8)", dev)
    ref, port = _both(tmp_path, [("rca_tpu/graph/meta.py", ref_src)],
                      [("rca_tpu_torch/graph/meta.py", port_src)],
                      "dtype-discipline")
    assert ref == port == [("dtype-discipline", 6)]


def test_dtype_int8_host_tags_of_the_graph_stay_legal():
    """The graph's host int8 type tags (``graph/build.py``) are not a
    device cast."""
    result = run_lint(root=ROOT, rules=["dtype-discipline"],
                      paths=["rca_tpu_torch/graph/build.py"],
                      use_baseline=False)
    assert result.findings == []
    assert "np.int8" in open(os.path.join(
        ROOT, "rca_tpu_torch/graph/build.py")).read()


@pytest.mark.parametrize("spelling", ["numpy", "torch", "double"])
def test_dtype_float64_staging_in_dataplane(tmp_path, spelling):
    ref_entries = [
        ("rca_tpu/engine/streaming.py",
         "import numpy as np\nbuf = np.zeros((4, 4), np.float64)\n"),
        ("rca_tpu/tools_helper.py",
         "import numpy as np\nacc = np.zeros((4, 4), np.float64)\n"),
    ]
    line = {"numpy": "buf = np.zeros((4, 4), np.float64)",
            "torch": "buf = torch.zeros((4, 4), dtype=torch.float64)",
            "double": "buf = rows.double()"}[spelling]
    port_entries = [
        ("rca_tpu_torch/engine/streaming.py",
         f"import numpy as np\n{line}\n"),
        ("rca_tpu_torch/tools_helper.py",
         f"import numpy as np\n{line}\n"),
    ]
    ref = ref_run_lint(root=_fake_repo(tmp_path / "ref", *ref_entries),
                       rules=["dtype-discipline"], use_baseline=False)
    port = run_lint(root=_fake_repo(tmp_path / "port", *port_entries),
                    rules=["dtype-discipline"], use_baseline=False)
    assert _hits(ref) == _hits(port) == [("dtype-discipline", 2)]
    assert [f.path for f in port.findings] == [
        "rca_tpu_torch/engine/streaming.py"]
    assert "float64 staging" in port.findings[0].message


def test_dtype_implicit_promotion_in_a_device_body(tmp_path):
    """The reference finds it in a jit body; the port in a device body
    (a function of the device modules): the bf16 cast and the promotion,
    at the same lines."""
    ref_src = """\
import jax
import jax.numpy as jnp

@jax.jit
def mix(n):
    a = jnp.zeros((4,), jnp.bfloat16)
    b = jnp.ones((4,), jnp.float32)
    return a * b
"""
    port_src = """\
import torch
import numpy as np


def mix(n):
    a = torch.zeros((4,), dtype=torch.bfloat16)
    b = torch.ones((4,), dtype=torch.float32)
    return a * b
"""
    ref = ref_run_lint(
        root=_fake_repo(tmp_path / "ref", ("rca_tpu/engine/foo.py",
                                           ref_src)),
        rules=["dtype-discipline"], use_baseline=False)
    port = run_lint(
        root=_fake_repo(tmp_path / "port",
                        ("rca_tpu_torch/engine/propagate.py", port_src)),
        rules=["dtype-discipline"], use_baseline=False)
    assert _hits(ref) == _hits(port) == [("dtype-discipline", 6),
                                         ("dtype-discipline", 8)]
    assert any("implicit" in f.message and "promotion" in f.message
               for f in port.findings)
    # outside the device modules the body is host code: the cast fires,
    # the promotion is not judged
    host = run_lint(
        root=_fake_repo(tmp_path / "host", ("rca_tpu_torch/cluster/foo.py",
                                            port_src)),
        rules=["dtype-discipline"], use_baseline=False)
    assert _hits(host) == [("dtype-discipline", 6)]


def test_dtype_promotion_in_a_ranked_body_uses_its_declared_inputs(
        tmp_path):
    """A ranked body is interpreted with its signature's input facts: a
    bf16 cast of the features mixed with the float32 input fires."""
    src = """\
def flush_propagate_ranked(model, features, idx, rows, dep_dst, n_live,
                           kk, plan):
    low = rows.bfloat16()
    mixed = low * features[idx]
    return mixed, idx, n_live
"""
    root = _fake_repo(tmp_path, ("rca_tpu_torch/engine/streaming.py", src))
    got = run_lint(root=root, rules=["dtype-discipline"],
                   use_baseline=False)
    assert _hits(got) == [("dtype-discipline", 3), ("dtype-discipline", 4)]


def test_evidence_exact_rounding_trick_does_not_fire():
    """``engine/evidence.py``'s plain version computes ``x * w`` in
    float64 (both sides cast) and rounds once: no promotion (both sides
    float64), and the module stages nothing, so no float64-staging
    finding either."""
    rel = "rca_tpu_torch/engine/evidence.py"
    source = open(os.path.join(ROOT, rel)).read()
    assert "x.double() * weights.double()" in source
    assert rel in contracts.DEVICE_BODY_MODULES
    assert rel not in contracts.DATAPLANE_MODULES
    result = run_lint(root=ROOT, rules=["dtype-discipline"], paths=[rel],
                      use_baseline=False)
    assert result.findings == []
    tree = ast.parse(source)
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and "x.double() * weights.double()" in ast.get_source_segment(
                  source, n))
    interp = absint.interpret_function(fn, {})
    line = next(i for i, text in enumerate(source.splitlines(), start=1)
                if "x.double() * weights.double()" in text)
    assert (line, "float64") in interp.events.casts
    assert interp.events.promotions == []


# ---------------------------------------------------------------------------
# the port sweeps clean; the fixes the rules asked for
# ---------------------------------------------------------------------------

def test_port_sweeps_clean_on_both_graftspec_rules():
    """The port's whole tree passes shape-contract and dtype-discipline
    with an EMPTY baseline."""
    result = run_lint(root=ROOT, rules=list(RULES), use_baseline=False)
    assert result.findings == [], [
        (f.path, f.line, f.rule, f.message) for f in result.findings
    ]
    assert result.files_scanned > 100


def test_contract_tables_are_sound_and_covering():
    assert contracts.budget_violations() == []
    assert contracts.coverage() == []
    assert contracts.DTYPE_RULES["no_float64_staging"] == \
        contracts.DATAPLANE_MODULES
    assert contracts.DTYPE_RULES["low_precision_ok"] == frozenset(
        {"rca_tpu_torch/engine/quantized.py"})
    assert {p for p, _ in contracts.RANKED_SIGNATURES} <= \
        contracts.DATAPLANE_MODULES
    assert contracts.DATAPLANE_MODULES == frozenset(
        "rca_tpu_torch/" + p[len("rca_tpu/"):]
        for p in ref_contracts.DATAPLANE_MODULES)
    assert contracts.LOW_PRECISION_DTYPES >= \
        ref_contracts.LOW_PRECISION_DTYPES


_FETCH_FIXES = {
    # (path, old spelling, the line the fix wrote)
    "full_diagnostics": (
        "rca_tpu_torch/engine/runner.py",
        "def full_diagnostics(self):\n"
        "    stack = self._stacked_dev\n"
        "    self._stacked = device_get(stack)\n"
        "    return self._stacked\n",
        "device_get(stacked) if torch.is_tensor(stacked)"),
    "sharded_numpy": (
        "rca_tpu_torch/parallel/sharded.py",
        "def numpy(self):\n"
        "    return np.concatenate([device_get(b) for b in self.blocks],\n"
        "                          axis=-1)\n",
        "device_get(stacked) for stacked in self.blocks"),
}


@pytest.mark.parametrize("surface", sorted(_FETCH_FIXES))
def test_bulk_fetches_name_their_stacked_role(tmp_path, surface):
    """Regression: the two bulk seams fetched a leaf named ``stack`` /
    ``b``, no role of their budget (``stacked``); the code now names the
    role, and the old spelling fires."""
    rel, old, fixed = _FETCH_FIXES[surface]
    root = _fake_repo(tmp_path, (rel, old))
    got = run_lint(root=root, rules=["shape-contract"], use_baseline=False)
    assert len(got.findings) == 1 and "is not a declared FETCH_BUDGETS " \
        "role" in got.findings[0].message
    assert fixed in open(os.path.join(ROOT, rel)).read()
    clean = run_lint(root=ROOT, rules=["shape-contract"], paths=[rel],
                     use_baseline=False)
    assert clean.findings == []


def test_cli_lists_and_reports_both_rules(capsys):
    assert port_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rule in RULES:
        assert rule in listed
    assert port_main(["--rules", ",".join(RULES), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["clean"] and out["findings"] == []
    assert set(out["per_rule_ms"]) == set(RULES)


# ---------------------------------------------------------------------------
# absint
# ---------------------------------------------------------------------------

def test_absint_unknown_is_honest():
    """Unmodeled constructs evaluate to UNKNOWN and conform to any
    declared role — a gap in the op table costs coverage, never a false
    positive (the reference's case and torch's own unmodelled calls)."""
    for body in ("mystery(x)", "x.unknown_method(3)", "torch.fft.fft(x)",
                 "x[mask]"):
        fn = ast.parse(f"def f(x, mask):\n    return {body}\n").body[0]
        interp = absint.interpret_function(fn, {})
        assert interp.returns == [contracts.UNKNOWN], body
        role = contracts.Role("vals", ("k",), "float32")
        assert absint.fact_conforms(interp.returns[0], role) is None
    # a boolean mask keeps the dtype and drops the shape
    fn = ast.parse("def f(x, mask):\n    return x[mask]\n").body[0]
    got = absint.interpret_function(fn, {"x": F(("n",), "float32"),
                                         "mask": F(("n",), "bool")})
    assert got.returns == [F(None, "float32")]


def test_absint_promote_and_broadcast_against_the_reference():
    """``broadcast`` is the reference's; ``promote`` is the reference's
    wherever the ranks are equal.  The one stated difference: a 0-dim
    operand (or a Python number) does not promote a dimensioned tensor of
    its category in torch, so with ranks unknown the port stays silent."""
    for a, b in (((4, "k"), ("k",)), ((1, "k"), (8, 1)), ((4,), (5,)),
                 (None, (3,))):
        assert absint.broadcast(a, b) == ref_absint.broadcast(a, b)
    assert absint.broadcast((4, "k"), ("k",)) == (4, "k")
    assert absint.broadcast((1, "k"), (8, 1)) == (8, "k")
    assert absint.promote(None, "int32") == ref_absint.promote(None,
                                                               "int32")
    for a, b in itertools.combinations(
            ("bool", "int8", "int32", "int64", "float32", "float64"), 2):
        assert absint.promote(a, b, (4,), (4,)) == ref_absint.promote(a, b)
    assert ref_absint.promote("bfloat16", "float32") == "float32"
    assert absint.promote("bfloat16", "float32", (4,), (4,)) == "float32"
    # the 0-dim rule: bf16 [n] with an f32 [] stays bf16 in torch
    assert absint.promote("bfloat16", "float32", ("n",), ()) == "bfloat16"
    assert absint.promote("bfloat16", "float32") is None


_DTYPES = ("bool", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64")


@pytest.mark.parametrize("a", _DTYPES)
def test_absint_promote_is_torch_result_type(a):
    for b in _DTYPES:
        for ra, rb in itertools.product((0, 1), (0, 1)):
            ta = torch.zeros((3,) * ra, dtype=getattr(torch, a))
            tb = torch.zeros((3,) * rb, dtype=getattr(torch, b))
            want = str(torch.result_type(ta, tb))[len("torch."):]
            assert absint.promote(a, b, (3,) * ra, (3,) * rb) == want, (
                a, b, ra, rb)
        # a Python number: the binop of a tensor with a literal
        for number, literal in (("int", 2), ("float", 1.5)):
            ta = torch.zeros((3,), dtype=getattr(torch, a))
            want = str(torch.result_type(ta, literal))[len("torch."):]
            fn = ast.parse(f"def f(x):\n    return x * {literal!r}\n"
                           ).body[0]
            got = absint.interpret_function(fn, {"x": F((3,), a)})
            assert got.returns == [F((3,), want)], (a, literal)


def test_absint_names_torchs_dtype_aliases_and_casts():
    names = {
        "torch.float": "float32", "torch.double": "float64",
        "torch.half": "float16", "torch.long": "int64",
        "torch.int": "int32", "torch.bool": "bool",
        "torch.bfloat16": "bfloat16", "torch.int8": "int8",
        "np.float32": "float32", "np.int64": "int64", "np.bool_": "bool",
        "np.double": "float64", "'float32'": "float32",
        "x.float": None, "np.float": None, "jnp.long": None,
    }
    for spelled, want in names.items():
        node = ast.parse(spelled, mode="eval").body
        assert absint.dtype_of_node(node) == want, spelled
    casts = {
        "x.to(torch.float16)": "float16",
        "x.to(dtype=torch.float64)": "float64",
        "x.to(x.device, torch.long)": "int64",
        "x.type(torch.bfloat16)": "bfloat16",
        "x.float()": "float32", "x.half()": "float16",
        "x.bfloat16()": "bfloat16", "x.double()": "float64",
        "x.long()": "int64", "x.int()": "int32",
        "x.astype(np.float32)": "float32",
        "torch.zeros((n, 4), dtype=torch.int32)": "int32",
        "x.new_full((n,), 7, dtype=torch.long)": "int64",
        "torch.arange(n, dtype=torch.int32)": "int32",
    }
    for spelled, want in casts.items():
        fn = ast.parse(f"def f(x, n):\n    return {spelled}\n").body[0]
        interp = absint.interpret_function(fn, {"x": F(("n", 4),
                                                       "float32")})
        assert interp.returns[0].dtype == want, spelled
        assert (2, want) in interp.events.casts, spelled


def test_absint_shape_vocabulary_of_the_ranked_bodies():
    """The ops the ranked bodies spell, one at a time."""
    env = {"stacked": F((4, "n_pad"), "float32"),
           "lanes_stacked": F(("B", 4, "n_pad"), "float32"),
           "score": F(("B", "n_pad"), "float32"),
           "idx": F(("B", "k"), "int64"),
           "base": F(("n_pad", "C"), "float32"),
           "lanes": S("B"), "n_pad": S("n_pad"), "k": S("k"),
           "a": F(("n_pad",), "float32")}
    cases = {
        "torch.stack([a, a, a, a], dim=-2)": F((4, "n_pad"), "float32"),
        "torch.stack([score, score], dim=-2)": F(("B", 2, "n_pad"),
                                                 "float32"),
        "torch.sort(score, dim=-1, descending=True, stable=True)[1]":
            F(("B", "n_pad"), "int64"),
        "score[..., :k]": F(("B", "k"), "float32"),
        "stacked[:, a.long()]": F((4, "n_pad"), "float32"),
        "torch.gather(lanes_stacked, 2, idx[:, None, :].expand("
        "-1, lanes_stacked.shape[1], -1))": F(("B", 4, "k"), "float32"),
        "base.expand(lanes, *base.shape).clone()": F(("B", "n_pad", "C"),
                                                     "float32"),
        "base.view(-1, base.shape[1])": F((None, "C"), "float32"),
        "base.reshape(-1)": F((None,), "float32"),
        "torch.arange(lanes, device=base.device)[:, None] * n_pad":
            F(("B", 1), "int64"),
        "base.index_copy_(0, a.long(), base)": F(("n_pad", "C"), "float32"),
        "(~torch.isfinite(base)).sum(dtype=torch.int32)": F((), "int32"),
        "torch.isfinite(base).all(dim=1)": F(("n_pad",), "bool"),
        "base.shape[0]": S("n_pad"),
    }
    for spelled, want in cases.items():
        fn = ast.parse(f"def f():\n    return {spelled}\n").body[0]
        got = absint.interpret_function(fn, env).returns[0]
        assert got == want, (spelled, got)


def _runner_function(name):
    path = os.path.join(ROOT, "rca_tpu_torch/engine/runner.py")
    tree = ast.parse(open(path).read())
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


@pytest.mark.parametrize("lanes", [(), ("B",)])
def test_summaries_equal_what_the_bodies_prove(lanes):
    """``top_k``, ``topk_diag`` and ``propagate_auto`` have summaries in
    SEMANTICS; interpreting their real bodies proves the same facts, with
    the lane dim carried through."""
    score = F(lanes + ("n_pad",), "float32")
    idx = F(lanes + ("k",), "int64")
    stacked = F(lanes + (4, "n_pad"), "float32")
    features = F(lanes + ("n_pad", "C"), "float32")
    body = absint.interpret_function(_runner_function("top_k"),
                                     {"score": score, "k": S("k")})
    assert body.returns == [absint.SEMANTICS["top_k"]([score, S("k")])]
    body = absint.interpret_function(_runner_function("topk_diag"),
                                     {"stacked": stacked, "idx": idx})
    want = absint.SEMANTICS["topk_diag"]([stacked, idx])
    # the first return is the [4, S] branch, the second the lanes' gather
    assert body.returns[len(lanes)] == want == F(lanes + (4, "k"),
                                                 "float32")
    body = absint.interpret_function(_runner_function("propagate_auto"),
                                     {"features": features})
    assert body.returns == [absint.SEMANTICS["propagate_auto"](
        [contracts.UNKNOWN, features])]
    assert len(body.returns[0]) == 6  # (a, h, u, m, score, n_bad)


# ---------------------------------------------------------------------------
# the signatures are true; the reference mapping
# ---------------------------------------------------------------------------

def _static_outputs(key):
    path, name = key
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == name)
    spec = contracts.RANKED_SIGNATURES[key]
    returns = absint.interpret_function(fn, spec["inputs"]).returns
    assert len(returns) == 1, returns
    return returns[0]


def _bound(fact, binding):
    return tuple(binding[d] if isinstance(d, str) else d
                 for d in fact.shape)


@pytest.fixture(scope="module")
def ranked_outputs():
    """The three ranked bodies run for real on the CPU at 129 services,
    k = 7, B = 4 (u = 8 delta rows), with their symbol binding."""
    from rca_tpu_torch import GraphEngine
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.engine.runner import (
        check_batch_delta,
        propagate_ranked,
        propagate_ranked_batch_delta,
    )
    from rca_tpu_torch.engine.streaming import flush_propagate_ranked

    case = synthetic_cascade_arrays(129, n_roots=2, seed=3)
    engine = GraphEngine(device="cpu", resident=False)
    f, s, d = engine._pad(case.features, case.dep_src, case.dep_dst)
    n_pad, e_pad, n = f.shape[0], len(s), case.features.shape[0]
    kk = 7
    plan = engine.plan_for(n_pad, e_pad, case.dep_src, case.dep_dst)
    dd = torch.from_numpy(d.astype(np.int64))
    rng = np.random.default_rng(5)
    u, lanes = 8, 4
    idx_b = np.full((lanes, u), n_pad - 1, np.int64)
    rows_b = np.zeros((lanes, u, f.shape[1]), np.float32)
    for b in range(lanes):
        rows = rng.choice(n, u - 1, replace=False)
        idx_b[b, : u - 1] = rows
        rows_b[b, : u - 1] = rng.uniform(0, 1, (u - 1, f.shape[1]))
    idx_b, rows_b = check_batch_delta(idx_b, rows_b, n_pad)
    base = torch.from_numpy(f)
    out = {
        (contracts._RUNNER, "propagate_ranked"): propagate_ranked(
            engine.model, torch.from_numpy(f.copy()), dd, n, kk, plan),
        (contracts._RUNNER, "propagate_ranked_batch_delta"):
            propagate_ranked_batch_delta(
                engine.model, base, torch.from_numpy(idx_b),
                torch.from_numpy(rows_b), dd, n, kk, plan),
        (contracts._STREAMING, "flush_propagate_ranked"):
            flush_propagate_ranked(
                engine.model, torch.from_numpy(f.copy()),
                torch.from_numpy(idx_b[0]), torch.from_numpy(rows_b[0]),
                dd, n, kk, plan),
    }
    binding = {"n_pad": n_pad, "C": f.shape[1], "E": e_pad, "k": kk,
               "B": lanes, "u": u}
    return out, binding


@pytest.mark.parametrize("key", sorted(contracts.RANKED_SIGNATURES),
                         ids=lambda key: key[1])
def test_signature_facts_equal_the_real_outputs(ranked_outputs, key):
    outputs, binding = ranked_outputs
    real = outputs[key]
    static = _static_outputs(key)
    declared = contracts.RANKED_SIGNATURES[key]["outputs"]
    assert len(real) == len(static) == len(declared)
    for tensor, fact, role in zip(real, static, declared):
        assert torch.is_tensor(tensor), role.name
        assert _bound(fact, binding) == tuple(tensor.shape), role.name
        want = str(tensor.dtype)[len("torch."):]
        if fact.dtype is not None:
            assert fact.dtype == want, role.name
        assert role.dtype == want, role.name
        assert absint.fact_conforms(fact, role) is None, role.name
        assert _bound(role, binding) == tuple(tensor.shape), role.name


@pytest.mark.parametrize("key", sorted(contracts.RANKED_SIGNATURES),
                         ids=lambda key: key[1])
def test_ranked_signatures_agree_with_their_reference_twins(key):
    spec = contracts.RANKED_SIGNATURES[key]
    lanes = spec.get("lanes")
    port = {}
    for role in spec["outputs"]:
        shape = role.shape
        if lanes and shape:
            # every ranked array gains the lane dim; n_bad counts across
            assert shape[0] == lanes, role.name
            shape = shape[1:]
        port[role.name] = (shape, role.dtype)
    twins = contracts.REFERENCE_SIGNATURES[key]
    assert twins
    for twin in twins:
        ref = {r.name: (r.shape, r.dtype)
               for r in ref_contracts.JIT_SIGNATURES[twin]["outputs"]}
        for name, (shape, dtype) in ref.items():
            if name not in port:
                assert name in contracts.SIGNATURE_DEVIATIONS, (twin, name)
                continue
            assert port[name][0] == shape, (twin, name)
            if name in contracts.SIGNATURE_DEVIATIONS:
                assert port[name][1] != dtype, (twin, name)
            else:
                assert port[name][1] == dtype, (twin, name)
        assert set(port) <= set(ref), twin
