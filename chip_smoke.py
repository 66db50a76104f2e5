#!/usr/bin/env python3
"""Drive the PyTorch port (``rca_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py              # the check: exit 0 and a last-line verdict
    python3 chip_smoke.py --profile    # also profile the analysis per tier
    python3 chip_smoke.py --out DIR    # also write the full record to DIR
    python3 chip_smoke.py --sweep      # also time the seg steps per bin cut

Phases, each printing one line; any failure exits non-zero before the
verdict line:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``rca_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together, then one link);
3. each kernel against its plain PyTorch version, on the card, at the
   shapes the main path gives it at both tiers (2047 services: ``n_pad``
   2048, ``e_pad`` 4096; 49,999 services: ``n_pad`` 53,248, ``e_pad``
   106,496): the evidence pair allclose at rtol 1e-6 / atol 1e-7, the
   evidence front (``evidence_front`` row pass, ``seg_contrast_step``,
   and the two as the engine calls them) bitwise on raw features with
   NaN/Inf rows and on an all-NaN input, the segmented max and the
   up-step bitwise, the segmented sum and the down-step allclose at rtol
   1e-5 / atol 1e-6, and every kernel bitwise-equal to itself over two
   runs.  The steps run over the tier's real layouts and over a star
   layout (all 4096 edges in one segment, longer than a block);
4. the main path: ``GraphEngine()`` on the card runs ``analyze_case`` at
   both tiers with the launch counters set to 0 just before; each
   analysis must launch ``evidence_front`` and ``seg_contrast_step`` once,
   ``seg_up_step`` and ``seg_down_step`` 8 times each, and
   ``noisy_or_pair`` and the flagged scans never.  Each result
   is held against the port's own CPU run (plain versions) of the same
   case — top-k and ``sanitized_rows`` identical, ``u`` bitwise, scores
   allclose at rtol 1e-5 / atol 1e-6 — and against itself (two card runs
   give a bitwise-equal ``[4, n_pad]`` stack); a poisoned copy of the
   2047 case checks the NaN/Inf sanitize the same way, and the flagship
   ``entry()`` step must reproduce the engine's scores;
5. times from CUDA events (median of 20 samples after warm-up): each
   kernel's device time (``ms``, launches queued behind a sleep kernel so
   the host's per-call cost is hidden) and its per-call cost to a caller
   (``call_ms``) beside its bound, its plain version and, where one
   PyTorch call computes the same reduction, that call (``library_ms``;
   the port never calls it); for each seg-step kernel also the step as
   composed around the flagged-scan kernel (gather, scan, ``s[ends]``,
   ``where``, epilogue: ``scan_step_ms`` / ``scan_step_call_ms``, timed
   the same way); the whole front (both launches: ``front_ms`` /
   ``front_call_ms`` and its bound) beside the front it replaces, the
   sanitize's torch ops, the ``noisy_or_pair`` kernel, the error-source
   scatter and the fold (``plain_front_ms`` / ``plain_front_call_ms``);
   the end-to-end ``analyze_arrays`` wall time at both tiers.

The line before the last is the ``{"kernels": [...]}`` JSON; the last line
is ``{"ok": true, "device": {...}}``.  With ``--out DIR`` the full record
goes to ``DIR/chip_smoke.json`` and each profile table to
``DIR/profile_<services>.txt``.  Imports nothing of JAX or ``rca_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# published peaks of one H100 SXM (data sheet, dense): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TIERS = ((2047, 3, 0), (49999, 3, 0))   # (services, roots, seed)
C = 13


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}, default=float), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, inner: int = 10, queued: bool = True):
    """Median over ``reps`` CUDA-event samples of ``inner`` calls each, in
    ms per call.  ``queued``: the card first spins on a sleep kernel long
    enough for the host to enqueue all ``inner`` calls, so the events time
    the device work alone, back to back, without the host's per-call cost
    (Python, the wrapper's checks, the launch); unqueued, a sample is the
    per-call cost as a caller pays it."""
    import numpy as np
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # 2 GHz is above the card's clock, so the sleep lasts at least this long
    spin_cycles = int(max(4 * enqueue_s, 1e-3) * 2e9)
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return float(np.median(samples))


def host_ms(fn, reps: int = 20) -> float:
    """Median host wall of ``fn`` (which must end in a device sync)."""
    import numpy as np

    for _ in range(3):
        fn()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main(argv) -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile the analysis at each tier")
    parser.add_argument("--out", default=None,
                        help="directory for the full record and profiles")
    parser.add_argument("--sweep", action="store_true",
                        help="time the seg-step kernels at each tier for "
                             "several short/long bin cuts")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's kernels run "
              "only on the card", file=sys.stderr)
        return 1
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.engine import GraphEngine
    from rca_tpu_torch.engine.evidence import (
        error_rate,
        error_source_excess,
        evidence_front,
        evidence_front_plain,
        evidence_front_rows,
        evidence_front_rows_plain,
        finite_mask_rows,
        fold_error_contrast,
        noisy_or_pair,
        noisy_or_pair_plain,
        seg_contrast_step,
        seg_contrast_step_plain,
    )
    from rca_tpu_torch.engine.segscan import (
        build_seg_layout,
        build_seg_layouts,
        down_seg_step,
        down_seg_step_plain,
        segscan_max,
        segscan_plain,
        segscan_sum,
        up_seg_step,
        up_seg_step_plain,
    )
    from rca_tpu_torch.entry import entry
    from rca_tpu_torch.features.schema import SvcF
    from rca_tpu_torch.kernels import LAUNCHES, build, reset_launches

    record = {"argv": list(argv)}
    dev = torch.device("cuda")
    smi = smi_line()
    record["nvidia_smi"] = smi
    print(smi, flush=True)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.library(verbose=True)
    record["build_s"] = time.perf_counter() - t0
    phase("build", seconds=record["build_s"],
          nvcc_seconds=build.BUILD_SECONDS)

    # -- inputs: both tiers, generated once --------------------------------
    cases, shapes, padded = {}, {}, {}
    for n, roots, seed in TIERS:
        t0 = time.perf_counter()
        cases[n] = synthetic_cascade_arrays(n, n_roots=roots, seed=seed)
        eng = GraphEngine(device="cpu")
        f, s, d = eng._pad(cases[n].features, cases[n].dep_src,
                           cases[n].dep_dst)
        shapes[n] = (f.shape[0], len(s))
        padded[n] = (s, d)
        phase("generate", services=n, edges=len(cases[n].dep_src),
              n_pad=f.shape[0], e_pad=len(s),
              seconds=time.perf_counter() - t0)

    # -- 3. each kernel against its plain version, on the card -------------
    rng = np.random.default_rng(20260)
    params = GraphEngine(device="cpu").params
    aw = torch.tensor(params.anomaly_weights, dtype=torch.float32, device=dev)
    hw = torch.tensor(params.hard_weights, dtype=torch.float32, device=dev)
    kin = {}   # per tier: kernel inputs on the card, for timing
    errs = {"noisy_or_pair": 0.0, "segscan_sum": 0.0, "segscan_max": 0.0,
            "seg_up_step": 0.0, "seg_down_step": 0.0, "evidence_front": 0.0,
            "seg_contrast_step": 0.0}
    decay = params.decay
    contrast = params.error_contrast

    def check_front(label, ft, up_d):
        """The front's kernels against their plain versions on raw
        features ``ft`` over the up layout ``up_d``: each launch and the
        pair of them, at the packaged contrast weight and at 0, bitwise
        and bitwise over two runs.  Returns the bad-row count."""
        def same(got, again, want, what):
            for g, a, w in zip(got, again, want):
                if not torch.equal(g, a):
                    fail(f"{what} not deterministic ({label})")
                if not torch.equal(g, w):
                    fail(f"{what} not bitwise equal to plain ({label})")

        rows = evidence_front_rows(ft, aw, hw)
        same(rows, evidence_front_rows(ft, aw, hw),
             evidence_front_rows_plain(ft, aw, hw), "evidence_front")
        a_raw, _, e, n_bad = rows
        same([seg_contrast_step(a_raw, e, contrast, up_d)],
             [seg_contrast_step(a_raw, e, contrast, up_d)],
             [seg_contrast_step_plain(a_raw, e, contrast, up_d)],
             "seg_contrast_step")
        for weight in (contrast, 0.0):
            same(evidence_front(ft, aw, hw, weight, up_d),
                 evidence_front(ft, aw, hw, weight, up_d),
                 evidence_front_plain(ft, aw, hw, weight, up_d),
                 f"evidence_front + seg_contrast_step at weight {weight}")
        torch.cuda.synchronize()
        phase("check", kernel="evidence_front + seg_contrast_step",
              input=label, n_pad=int(ft.shape[0]), bad_rows=int(n_bad),
              max_abs_err=0.0, bitwise=True)
        return int(n_bad)

    def check_steps(label, seg, inv_deg, names):
        """The step kernels ``names`` against their plain versions over
        ``seg`` (on the card), on random nonnegative vectors; returns the
        inputs."""
        n_pad = seg.offsets.shape[0] - 1

        def vec():
            return torch.from_numpy(
                rng.uniform(0.0, 1.0, n_pad).astype(np.float32)).to(dev)

        u, h, m, a_ex = vec(), vec(), vec(), vec()
        runs = {
            "seg_up_step": (lambda: up_seg_step(u, h, decay, seg),
                            lambda: up_seg_step_plain(u, h, decay, seg)),
            "seg_down_step": (
                lambda: down_seg_step(m, a_ex, decay, seg, inv_deg),
                lambda: down_seg_step_plain(m, a_ex, decay, seg, inv_deg)),
        }
        for name in names:
            kernel, plain = runs[name]
            k1, k2, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            if not torch.equal(k1, k2):
                fail(f"{name} not deterministic ({label})")
            if name == "seg_up_step" and not torch.equal(k1, want):
                fail(f"seg_up_step not bitwise equal to plain ({label})")
            if not torch.allclose(k1, want, rtol=1e-5, atol=1e-6):
                fail(f"{name} disagrees with plain ({label})")
            err = float((k1 - want).abs().max())
            errs[name] = max(errs[name], err)
            phase("check", kernel=name, layout=label, n_pad=n_pad,
                  longest_segment=int(
                      (seg.offsets[1:] - seg.offsets[:-1]).max()),
                  long_segments=int(seg.long_ids.shape[0]),
                  max_abs_err=err, bitwise=bool(torch.equal(k1, want)))
        return {"u": u, "h": h, "m": m, "a_ex": a_ex, "inv_deg": inv_deg,
                "seg": seg}

    for n in cases:
        n_pad, e_pad = shapes[n]
        feats = np.zeros((n_pad, C), np.float32)
        feats[:n] = cases[n].features
        # half the rows from the cascade, half uniform past [0, 1] so the
        # clip is exercised
        feats[::2] = rng.uniform(-0.2, 1.2, feats[::2].shape)
        ft = torch.from_numpy(feats).to(dev)
        a_k, h_k = noisy_or_pair(ft, aw, hw)
        a_k2, h_k2 = noisy_or_pair(ft, aw, hw)
        a_p, h_p = noisy_or_pair_plain(ft, aw, hw)
        torch.cuda.synchronize()
        if not (torch.equal(a_k, a_k2) and torch.equal(h_k, h_k2)):
            fail(f"noisy_or_pair not deterministic at n_pad {n_pad}")
        for got, want in ((a_k, a_p), (h_k, h_p)):
            if not torch.allclose(got, want, rtol=1e-6, atol=1e-7):
                fail(f"noisy_or_pair disagrees with plain at n_pad {n_pad}")
        err = max(float((a_k - a_p).abs().max()), float((h_k - h_p).abs().max()))
        errs["noisy_or_pair"] = max(errs["noisy_or_pair"], err)
        phase("check", kernel="noisy_or_pair", n_pad=n_pad,
              max_abs_err=err, h_bitwise=bool(torch.equal(h_k, h_p)))

        down, up = build_seg_layouts(n_pad, e_pad, cases[n].dep_src,
                                     cases[n].dep_dst)
        kin[n] = {"features": ft, "seg": {}}
        src_pad, dst_pad = padded[n]
        for op, layout, seg_of_edge, fn in (
                ("sum", down, dst_pad, segscan_sum),
                ("max", up, src_pad, segscan_max)):
            x = torch.from_numpy(
                rng.uniform(0.0, 1.0, e_pad).astype(np.float32)).to(dev)
            flags = torch.from_numpy(layout.flags).to(dev)
            # edges per segment, in sorted-segment order: the lengths the
            # library's segment reduce takes
            counts = np.bincount(seg_of_edge, minlength=n_pad)
            lengths = torch.from_numpy(counts.astype(np.int64)).to(dev)
            k1 = fn(x, flags)
            k2 = fn(x, flags)
            plain = segscan_plain(x, flags, op)
            torch.cuda.synchronize()
            name = f"segscan_{op}"
            if not torch.equal(k1, k2):
                fail(f"{name} not deterministic at e_pad {e_pad}")
            if op == "max" and not torch.equal(k1, plain):
                fail(f"segscan_max not bitwise equal to plain at {e_pad}")
            if not torch.allclose(k1, plain, rtol=1e-5, atol=1e-6):
                fail(f"{name} disagrees with plain at e_pad {e_pad}")
            err = float((k1 - plain).abs().max())
            errs[name] = max(errs[name], err)
            kin[n]["seg"][op] = (x, flags, lengths)
            phase("check", kernel=name, e_pad=e_pad, max_abs_err=err,
                  longest_segment=int(counts.max()))

        # the seg steps over the tier's layouts as the engine uploads them,
        # with the engine's inverse in-degree (padded edges included)
        down_d, up_d = build_seg_layouts(n_pad, e_pad, cases[n].dep_src,
                                         cases[n].dep_dst, device=dev)
        inv_deg = torch.from_numpy((1.0 / np.maximum(np.bincount(
            dst_pad, minlength=n_pad), 1)).astype(np.float32)).to(dev)
        kin[n]["step"] = {
            "seg_up_step": check_steps(f"up, {n} services", up_d, inv_deg,
                                       ["seg_up_step"]),
            "seg_down_step": check_steps(f"down, {n} services", down_d,
                                         inv_deg, ["seg_down_step"]),
        }

        # the front on raw features: a row whose only non-finite value is
        # its error rate, a NaN beside a finite error rate (its e must
        # come out 0), +Inf and -Inf
        err_col = SvcF.ERROR_RATE
        poisoned = feats.copy()
        poisoned[3, err_col] = np.nan
        poisoned[11, [err_col, 4]] = (0.9, np.nan)
        poisoned[[20, 2001], [7, 12]] = (np.inf, -np.inf)
        pt = torch.from_numpy(poisoned).to(dev)
        if check_front(f"{n} services, 4 poisoned rows", pt, up_d) != 4:
            fail(f"the front counted the wrong bad rows at {n}")
        if evidence_front_rows(pt, aw, hw)[2][11] != 0.0:
            fail(f"a poisoned row kept its error rate at {n}")
        kin[n]["front"] = {"features": pt, "up": up_d,
                           "src": torch.from_numpy(padded[n][0].astype(
                               np.int64)).to(dev),
                           "dst": torch.from_numpy(padded[n][1].astype(
                               np.int64)).to(dev)}
        if n == TIERS[0][0]:
            nan_all = torch.full_like(pt, float("nan"))
            if check_front("every row NaN", nan_all, up_d) != n_pad:
                fail("the front did not count every row of an all-NaN input")
            a_all, h_all, _ = evidence_front(nan_all, aw, hw, contrast, up_d)
            if a_all.any() or h_all.any():
                fail("an all-NaN input left evidence")

    # a star: every edge in one segment (id 7, past empty ones), so the
    # block path reduces a run 16 times its width
    star = build_seg_layout(2048, 4096, np.full(4096, 7, np.int32),
                            rng.integers(0, 2047, 4096).astype(np.int32))
    check_steps("star, 4096 edges in one segment", star.to(dev),
                torch.full((2048,), 1.0 / 4096, dtype=torch.float32,
                           device=dev), ["seg_up_step", "seg_down_step"])

    # -- 4. the main path, through the kernels -----------------------------
    engine = GraphEngine()
    if engine.plan != "kernels":
        fail(f"engine plan {engine.plan!r} on the card")
    reset_launches()
    results = {}
    for i, n in enumerate(cases, start=1):
        results[n] = engine.analyze_case(cases[n])
        want = {"noisy_or_pair": 0, "segscan_sum": 0, "segscan_max": 0,
                "seg_up_step": 8 * i, "seg_down_step": 8 * i,
                "evidence_front": i, "seg_contrast_step": i}
        if LAUNCHES != want:
            fail(f"launch counts {LAUNCHES} after {i} analyses, want {want}")
    main_launches = dict(LAUNCHES)
    phase("main_path", launches=main_launches,
          per_analysis={"evidence_front": 1, "seg_contrast_step": 1,
                        "seg_up_step": 8, "seg_down_step": 8,
                        "noisy_or_pair": 0, "segscan_sum": 0,
                        "segscan_max": 0})

    cpu = GraphEngine(device="cpu")
    checks = []
    for n in cases:
        case = cases[n]
        variants = [("clean", case.features)]
        if n == 2047:
            bad = case.features.copy()
            bad[[5, 77, 901], [1, 4, 12]] = (np.nan, np.inf, -np.inf)
            variants.append(("nan_inf", bad))
        for label, feats in variants:
            got = (results[n] if label == "clean" else
                   engine.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                         case.names))
            again = engine.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                          case.names)
            ref = cpu.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                     case.names)
            gs, rs = got.full_diagnostics(), ref.full_diagnostics()
            if not np.array_equal(gs, again.full_diagnostics()):
                fail(f"two card runs differ at {n} ({label})")
            if got.top_components() != ref.top_components():
                fail(f"top-k differs from the CPU run at {n} ({label}): "
                     f"{got.top_components()} vs {ref.top_components()}")
            if got.sanitized_rows != ref.sanitized_rows:
                fail(f"sanitized_rows {got.sanitized_rows} vs "
                     f"{ref.sanitized_rows} at {n} ({label})")
            if not np.array_equal(gs[1], rs[1]):
                fail(f"u not bitwise equal to the CPU run at {n} ({label})")
            if not np.allclose(gs[3], rs[3], rtol=1e-5, atol=1e-6):
                fail(f"scores disagree with the CPU run at {n} ({label})")
            if not np.isfinite(gs).all():
                fail(f"non-finite diagnostics at {n} ({label})")
            roots = set(case.roots.tolist())
            names = list(case.names) if case.names else None
            top = [names.index(c) if names else int(c.split("-")[1])
                   for c in got.top_components()]
            checks.append({
                "services": n, "input": label,
                "top": got.top_components(),
                "sanitized_rows": got.sanitized_rows,
                "score_max_abs_err": float(np.abs(gs[3] - rs[3]).max()),
                "hit_at_1": top[0] in roots,
                "roots_in_top_k": len(roots & set(top)),
            })
            phase("compare", **checks[-1])
            if label == "clean" and top[0] not in roots:
                fail(f"top-1 {got.top_components()[0]} is not a fault root "
                     f"at {n}")

    fn, example = entry()
    score = fn(*example)[: 2047].cpu().numpy()
    if not np.allclose(score, results[2047].score, rtol=1e-5, atol=1e-6):
        fail("entry() scores disagree with the engine's")
    phase("entry", n_pad=int(example[0].shape[0]),
          e_pad=int(example[1].shape[0]))

    # -- 5. times ----------------------------------------------------------
    times = {}
    for n in cases:
        n_pad, e_pad = shapes[n]
        ft = kin[n]["features"]
        t = {"noisy_or_pair": {
            "ms": cuda_ms(lambda: noisy_or_pair(ft, aw, hw)),
            "call_ms": cuda_ms(lambda: noisy_or_pair(ft, aw, hw),
                               queued=False),
            "plain_ms": cuda_ms(lambda: noisy_or_pair_plain(ft, aw, hw)),
            "library_ms": None,
            "bound": bound_ms(n_pad * C * 4 + 2 * C * 4 + 2 * n_pad * 4,
                              n_pad * (C * 2 * 3 + 2 * 2 + 2)),
        }}
        for op, fn_k in (("sum", segscan_sum), ("max", segscan_max)):
            x, flags, lengths = kin[n]["seg"][op]
            t[f"segscan_{op}"] = {
                "ms": cuda_ms(lambda: fn_k(x, flags)),
                "call_ms": cuda_ms(lambda: fn_k(x, flags), queued=False),
                "plain_ms": cuda_ms(lambda: segscan_plain(x, flags, op)),
                "library_ms": cuda_ms(
                    lambda: torch.segment_reduce(x, op, lengths=lengths)),
                "bound": bound_ms(3 * e_pad * 4, e_pad),
            }
        st = kin[n]["step"]
        up, down = st["seg_up_step"], st["seg_down_step"]
        out = torch.empty(n_pad, dtype=torch.float32, device=dev)
        # bytes: other (int32 per edge) + offsets + the node vectors read
        # once + the output; operations: 3 per edge, 1 per node
        csr_bytes = e_pad * 4 + (n_pad + 1) * 4
        steps = {
            "seg_up_step": (
                lambda: up_seg_step(up["u"], up["h"], decay, up["seg"],
                                    out=out),
                lambda: up_seg_step_plain(up["u"], up["h"], decay,
                                          up["seg"]),
                lambda: up_seg_step_plain(up["u"], up["h"], decay,
                                          up["seg"], scan=segscan_max),
                csr_bytes + 3 * n_pad * 4),
            "seg_down_step": (
                lambda: down_seg_step(down["m"], down["a_ex"], decay,
                                      down["seg"], down["inv_deg"], out=out),
                lambda: down_seg_step_plain(down["m"], down["a_ex"], decay,
                                            down["seg"], down["inv_deg"]),
                lambda: down_seg_step_plain(down["m"], down["a_ex"], decay,
                                            down["seg"], down["inv_deg"],
                                            scan=segscan_sum),
                csr_bytes + 4 * n_pad * 4),
        }
        for name, (kernel, plain, scan_step, n_bytes) in steps.items():
            t[name] = {
                "ms": cuda_ms(kernel),
                "call_ms": cuda_ms(kernel, queued=False),
                "plain_ms": cuda_ms(plain),
                "scan_step_ms": cuda_ms(scan_step),
                "scan_step_call_ms": cuda_ms(scan_step, queued=False),
                "library_ms": None,
                "bound": bound_ms(n_bytes, 3 * e_pad + n_pad),
            }

        # the front: features read once, the weights, the up layout's CSR,
        # the [n_pad] vectors between and out of the two launches
        fr = kin[n]["front"]
        pt, up_d = fr["features"], fr["up"]
        a_raw, _, e, _ = evidence_front_rows(pt, aw, hw)
        feat_bytes = n_pad * C * 4 + 2 * C * 4
        noisy_ops = n_pad * (C * (1 + 2 + 2 * 2) + 2 * 2 + 2 + 2)
        t["evidence_front"] = {
            "ms": cuda_ms(lambda: evidence_front_rows(pt, aw, hw)),
            "call_ms": cuda_ms(lambda: evidence_front_rows(pt, aw, hw),
                               queued=False),
            "plain_ms": cuda_ms(lambda: evidence_front_rows_plain(pt, aw,
                                                                  hw)),
            "library_ms": None,
            "bound": bound_ms(feat_bytes + 3 * n_pad * 4 + 4, noisy_ops),
        }
        t["seg_contrast_step"] = {
            "ms": cuda_ms(lambda: seg_contrast_step(a_raw, e, contrast,
                                                    up_d)),
            "call_ms": cuda_ms(lambda: seg_contrast_step(a_raw, e, contrast,
                                                         up_d), queued=False),
            "plain_ms": cuda_ms(lambda: seg_contrast_step_plain(
                a_raw, e, contrast, up_d)),
            "library_ms": None,
            "bound": bound_ms(csr_bytes + 3 * n_pad * 4, e_pad + 6 * n_pad),
        }

        def replaced_front():
            # the front as the main path ran it before the fused pass: the
            # sanitize's torch ops, the noisy_or_pair kernel, the
            # error-source gather and scatter-max over the edge lists, the
            # fold
            clean, n_bad = finite_mask_rows(pt)
            a, h = noisy_or_pair(clean, aw, hw)
            a = fold_error_contrast(a, error_source_excess(
                error_rate(clean), fr["src"], fr["dst"]), contrast)
            return a, h, n_bad

        def front():
            return evidence_front(pt, aw, hw, contrast, up_d)

        t["front"] = {
            "ms": cuda_ms(front),
            "call_ms": cuda_ms(front, queued=False),
            "plain_front_ms": cuda_ms(replaced_front),
            "plain_front_call_ms": cuda_ms(replaced_front, queued=False),
            "plain_ms": cuda_ms(lambda: evidence_front_plain(
                pt, aw, hw, contrast, up_d)),
            "bound": bound_ms(feat_bytes + csr_bytes + 2 * n_pad * 4 + 4,
                              noisy_ops + e_pad + 6 * n_pad),
        }
        case = cases[n]

        def analyze():
            engine.analyze_arrays(case.features, case.dep_src,
                                  case.dep_dst, case.names)

        t["analyze_arrays_ms"] = host_ms(analyze)
        t["analyze_timed_latency_ms"] = engine.analyze_case(
            case, timed=True).latency_ms
        times[n] = t
        phase("times", services=n, **t)

    if args.sweep:
        record["sweep"] = sweep(cases, shapes, kin, decay)

    if args.profile:
        for n in cases:
            profile(engine, cases[n], times[n]["analyze_arrays_ms"], args.out)

    big = TIERS[-1][0]
    sources = {
        "evidence_front": ("rca_tpu_torch/csrc/evidence.cu",
                           "rca_tpu/engine/pallas_kernels.py:52 (with the "
                           "sanitize, rca_tpu/engine/propagate.py:132)"),
        "seg_contrast_step": ("rca_tpu_torch/csrc/segstep.cu",
                              "rca_tpu/engine/pallas_kernels.py:52 (the "
                              "front's contrast, rca_tpu/engine/"
                              "propagate.py:174, :186)"),
        "noisy_or_pair": ("rca_tpu_torch/csrc/evidence.cu",
                          "rca_tpu/engine/pallas_kernels.py:52"),
        "segscan_sum": ("rca_tpu_torch/csrc/segscan.cu",
                        "rca_tpu/engine/segscan.py:136"),
        "segscan_max": ("rca_tpu_torch/csrc/segscan.cu",
                        "rca_tpu/engine/segscan.py:141"),
        "seg_up_step": ("rca_tpu_torch/csrc/segstep.cu",
                        "rca_tpu/engine/segscan.py:141 "
                        "(step up_seg_step :206)"),
        "seg_down_step": ("rca_tpu_torch/csrc/segstep.cu",
                          "rca_tpu/engine/segscan.py:136 "
                          "(step down_seg_step :197)"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        t = times[big][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": errs[name], "ms": t["ms"], "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "tier_services": big, "at_2047": times[2047][name],
            **{key: t[key] for key in ("scan_step_ms", "scan_step_call_ms")
               if key in t},
        })
        if name == "evidence_front":
            front = times[big]["front"]
            kernels[-1].update(
                front_ms=front["ms"], front_call_ms=front["call_ms"],
                front_bound_ms=front["bound"][0],
                plain_front_ms=front["plain_front_ms"],
                plain_front_call_ms=front["plain_front_call_ms"])

    for mod in list(sys.modules):
        if mod == "jax" or mod.startswith("jax.") or mod == "rca_tpu" \
                or mod.startswith("rca_tpu."):
            fail(f"{mod} was imported")

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    record.update(kernels=kernels, checks=checks, times={
        str(n): t for n, t in times.items()}, device=device,
        torch=torch.__version__, cuda=torch.version.cuda)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1, default=float)
    print(json.dumps({"kernels": kernels}, default=float))
    print(json.dumps({"ok": True, "device": device}))
    return 0


def sweep(cases, shapes, kin, decay, cuts=(8, 16, 32, 64, 128, 256)):
    """Device time of each seg-step kernel per tier over layouts binned at
    each cut (the longest segment one thread reduces), on the check
    phase's inputs."""
    import torch
    from rca_tpu_torch.engine.segscan import (
        build_down_seg,
        build_up_seg,
        down_seg_step,
        up_seg_step,
    )

    rows = []
    for n in cases:
        n_pad, e_pad = shapes[n]
        up, down = kin[n]["step"]["seg_up_step"], kin[n]["step"]["seg_down_step"]
        out = torch.empty(n_pad, dtype=torch.float32, device=up["u"].device)
        for cut in cuts:
            args = (n_pad, e_pad, cases[n].dep_src, cases[n].dep_dst)
            up_seg = build_up_seg(*args, short_max=cut).to(out.device)
            down_seg = build_down_seg(*args, short_max=cut).to(out.device)
            row = {"services": n, "cut": cut,
                   "up_long": int(up_seg.long_ids.shape[0]),
                   "down_long": int(down_seg.long_ids.shape[0]),
                   "seg_up_step_ms": cuda_ms(lambda: up_seg_step(
                       up["u"], up["h"], decay, up_seg, out=out)),
                   "seg_down_step_ms": cuda_ms(lambda: down_seg_step(
                       down["m"], down["a_ex"], decay, down_seg,
                       down["inv_deg"], out=out))}
            rows.append(row)
            phase("sweep", **row)
    return rows


def profile(engine, case, host_ms_per_analysis: float, out=None) -> None:
    """Device time by kernel over 5 analyses (torch.profiler), the table
    written to ``out/profile_<n>.txt`` when ``out`` is given.  The busy
    share divides the device time of one analysis by its unprofiled host
    wall time (the profiler's own start-up would swamp a profiled wall
    clock)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    for _ in range(3):
        engine.analyze_case(case)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            engine.analyze_case(case)
        torch.cuda.synchronize()
    events = prof.key_averages()
    table = events.table(sort_by="self_cuda_time_total", row_limit=40)
    # device-side events: kernels, copies and memsets; the profiler's own
    # buffer request shows up there too and is left out
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and e.key != "Activity Buffer Request"]
    device_us = sum(
        getattr(e, "self_device_time_total", 0) or
        getattr(e, "self_cuda_time_total", 0) for e in on_device) / 5
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel")) / 5
    kernels = sum(e.count for e in on_device
                  if not e.key.startswith(("Memcpy", "Memset"))) / 5
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"profile_{case.n}.txt"), "w") as f:
            f.write(table)
    phase("profile", services=case.n, device_us_per_analysis=device_us,
          launches_per_analysis=launches,
          device_kernels_per_analysis=kernels,
          host_ms_per_analysis=host_ms_per_analysis,
          device_busy_share=device_us / 1e3 / host_ms_per_analysis)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
