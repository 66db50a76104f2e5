#!/usr/bin/env python3
"""Drive the PyTorch port (``rca_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py              # the check: exit 0 and a last-line verdict
    python3 chip_smoke.py --profile    # also profile the analysis per tier,
                                       # the attribution at 49,999 and a
                                       # streaming tick per size
    python3 chip_smoke.py --out DIR    # also write the full record to DIR
    python3 chip_smoke.py --sweep      # also time the seg steps per bin cut
    python3 chip_smoke.py --multi-card # two cards or more: the build, then
                                       # the sharded engine over distinct
                                       # cards alone (the peer form)
    python3 chip_smoke.py --federation-only  # the build, then the
                                       # federation phase alone
    python3 chip_smoke.py --autoscale-only   # the build, then the
                                       # autoscale phase alone
    python3 chip_smoke.py --lint-only  # the build, then the lint
                                       # phase alone
    python3 chip_smoke.py --snapshot-only  # the build, then the
                                       # snapshot phase alone (with its
                                       # OOM-chain and Stream-tab legs)
    python3 chip_smoke.py --recursions-only  # the build, then the
                                       # recursions phase alone (the grid
                                       # kernels' checks and times)
    python3 chip_smoke.py --sharded-only  # the build, then the sharded
                                       # phase alone (the shard
                                       # recursions' checks and times)

Phases, each printing one line; any failure exits non-zero before the
verdict line.  "The main path's counts" below are a dense analysis's
launches on the ``kernels`` row: ``evidence_front_fused`` once (the whole
front, ``csrc/front.cu``), then the two recursions once each in the form
the plan names (``KernelPlan.steps_form``): ``seg_up_steps`` /
``seg_down_steps`` up to 2047 services (``cta``: both layouts fit one
CTA's shared memory) and ``seg_up_steps_grid`` / ``seg_down_steps_grid``
above (``grid``: one cooperative launch over the card, at 10,000 and
49,999), 1 / 1 / 1 either way; the per-step ``seg_up_step`` /
``seg_down_step`` only in the node-sharded engine's ``step`` form (mixed
placements, cards without peer access), the front's two halves
``evidence_front`` / ``seg_contrast_step`` there and in its ``peer`` form
(one shard a card), ``noisy_or_pair`` and the flagged scans never
(:func:`main_launches`).

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``rca_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together, then one link);
3. each kernel against its plain PyTorch version, on the card, at the
   shapes the main path gives it at both tiers (2047 services: ``n_pad``
   2048, ``e_pad`` 4096; 49,999 services: ``n_pad`` 53,248, ``e_pad``
   106,496): the evidence pair allclose at rtol 1e-6 / atol 1e-7, the
   evidence front (``evidence_front`` row pass, ``seg_contrast_step``,
   and the two in a row) bitwise on raw features with NaN/Inf rows and
   on an all-NaN input, and the fused front ``evidence_front_fused``
   bitwise those two launches and the plain version over 1, 2, 4 and 16
   lanes, at the packaged contrast weight and at 0, reading and
   persisting (the persisted rows bitwise too), also over the star and
   the degenerate layouts below; the segmented max and the
   up-step bitwise, the segmented sum and the down-step allclose at rtol
   1e-5 / atol 1e-6, and every kernel bitwise-equal to itself over two
   runs.  The steps run over the tier's real layouts and over a star
   layout (all 4096 edges in one segment, longer than a block).  The
   fused recursions ``seg_up_steps`` / ``seg_down_steps`` run over the
   same layouts, the star and two degenerate ones (no edges; self-loops
   and duplicate edges) at 0, 1, 8 and 13 steps flat and at 8 over 2, 4,
   8 and 16 lanes: bitwise the same number of per-step launches, bitwise
   over two runs, each lane bitwise its flat launch, ``u`` bitwise its
   plain version and ``m`` at rtol 1e-5 / atol 1e-6 (at 2047 only: the
   49,999 layouts do not fit one CTA).  Then the recursions phase
   (:func:`recursions_phase`, alone with ``--recursions-only``): the grid
   recursions ``seg_up_steps_grid`` / ``seg_down_steps_grid`` under the
   same checks at 2047, 10,000 and 49,999 services, on the star and the
   degenerate layouts (their even lanes with the dummy slot at 0, as the
   engine gives it, so the padding run's shortcut runs beside the walk),
   and timed at 10,000 and 49,999 beside the 8 per-step launches they
   replace (at 2047 too, for the record, beside the times phase's
   one-CTA kernels);
4. the kernel registry at both tiers, with a fresh cache file: the
   ``kernels`` row is elected by timing with ``torch`` timed beside it, a
   second engine reads the cache (``source == "cache"``), and under
   ``RCA_KERNEL=torch`` an analysis launches no kernel of the port and
   ranks the same top-k;
5. the main path: ``GraphEngine()`` on the card runs ``analyze_case`` at
   both tiers (the registry engaging ``kernels``) with the launch
   counters set to 0 just before; the plan's ``steps_form`` must be
   ``cta`` at 2047 and ``grid`` at 49,999, and each analysis must launch
   the main path's counts.  Each result
   is held against the port's own CPU run (plain versions) of the same
   case — top-k and ``sanitized_rows`` identical, ``u`` bitwise, scores
   allclose at rtol 1e-5 / atol 1e-6 — and against itself (two card runs
   give a bitwise-equal ``[4, n_pad]`` stack); a poisoned copy of the
   2047 case checks the NaN/Inf sanitize the same way, and the flagship
   ``entry()`` step must reproduce the engine's scores;
6. the hypothesis batch, 8 lanes per tier (each of the top candidates
   made healthy in its lane, NaN/Inf rows in two lanes): one
   ``analyze_batch`` launches the main path's counts for the whole
   batch, every lane is bitwise equal to a solo card analysis of its
   features, each batched launch agrees with its batched plain version
   (the front, the contrast and ``u`` bitwise, the down-steps at rtol
   1e-5 / atol 1e-6; the one-launch recursions, one CTA a lane at 2047
   and the grid at 49,999, also bitwise their per-step launches), the
   batch delta is bitwise equal to full staging, and each batched launch
   is timed beside its bound and plain version (the one-launch
   recursions beside their 8 per-step launches too);
7. the capture layer: the native log scanner and the C sanitize
   extension are built with g++ from ``rca_tpu_torch/native/`` into the
   port's own cache (the scanner must load; the sanitize extension must
   load where ``Python.h`` exists, and a line ``native_sanitize: ...``
   says whether it did): the scanner counts what the regex scanner counts
   on every log of the 2047-service world, the sanitize returns what the
   Python walk returns on fuzzed objects.  Then
   ``synthetic_cascade_world(n, n_roots=3, seed=0)`` at 2047, 10,000 and
   49,999 services is captured columnar (the default; a capture that
   falls back to the dict sweep fails) and with ``columnar=False``:
   snapshot values and feature matrices bitwise equal, dependency edges
   equal, and each path's ``capture_ms``, ``features_ms`` and
   ``graph_ms`` beside each other with the card's name and power limit
   (the columnar path's first capture, which builds the master tables,
   and its diff capture through a persisted mirror apart).  Host work
   alone, it runs in a process of its own (``--side-phase capture``)
   beside phases 8-21 and is joined before phase 22.  Then
   ``python -m rca_tpu_torch analyze --compact`` with no fixture, no
   ``kubectl`` on the PATH and ``KUBECONFIG`` naming a missing file must
   exit 0 with the reference's report for an empty, unreachable cluster;
8. the snapshot path: the port's ``RCACoordinator(backend="torch")`` runs
   a comprehensive analysis (capture, features, graph, the six agents, the
   engine, the findings JSON) on the card over the 5-service fixture, the
   50-service fixture and a 2047-service cascade, each with the launch
   counters set to 0 just before: each analysis must launch the main
   path's counts (fused: 1 / 1 / 1) and nothing else, finish with
   the torch backend and no fallback, rank a fault root first (the
   database and the api-gateway first and second at 5 services), match
   the port's own CPU run (agents' findings and groups byte-identical,
   root causes in the same order, floats within rel 1e-5 / abs 1e-6,
   scores within 1e-4), a second card run bit for bit and a card run on
   the dict capture (``RCA_COLUMNAR=0``) bit for bit; the analyses take
   the columnar default.  At 2047 the
   topology agent's betweenness takes the device path: it is held to the
   float64 loop at rtol 1e-5 / atol 1e-7 and timed, and the stage profile
   and the whole ``run_analysis`` are timed on the columnar and on the
   dict capture, in turns (median of 5 each after a warm-up;
   ``--profile`` adds the device time and busy share of both).
   ``python -m rca_tpu_torch analyze --fixture 50svc --seed 7 --compact``
   (the same 50-service fixture) must exit 0 with a torch-engine ranking
   whose first root cause is the fixture's fault root.  Then BASELINE.md
   row 3: ``measure_analyze`` over ``oom_chain_world(200)`` (the 200-pod
   OOMKill chain, 67 services; the shape's registry row elected first)
   on the card must complete on the torch backend with no fallback, put
   the OOMKilled root first, give the CPU run's ``top5`` and launch the
   main path's counts twice over its two analyses (2 / 2 / 2), with its
   first and warm latencies and its engine latency printed; and the
   app's Stream tab (``rca_tpu_torch/ui/app.py::_render_stream_tab``,
   driven by a scripted stand-in for ``st``) over the phase's 5-service
   and 2047-service worlds, started then polled 3 times on the card and
   on the CPU: each poll the main path's counts (1 / 1 / 1), the history
   ticking 1..3, the ranked table's components in the CPU run's order
   with scores within rtol 1e-5 / atol 1e-6, ``database`` first at 5
   services; ``python -m rca_tpu_torch ui``, started with the phase (the
   card's host has no streamlit), must exit 1 with its message;
9. attribution: ``RCA_EXPLAIN=1`` comprehensive analyses over the
   50-service fixture and the 2047-service cascade, and
   ``analyze_arrays(...).attribution()`` at 49,999 services, the sweep on
   the registry's ``dense`` row (``kernels``: the base run and the
   counterfactual lanes launch the main path's counts twice, the grid
   recursions at 49,999: 2 / 2 / 2, counted from 0 just before) and the
   saliency
   on its ``attribution`` row
   (``torch``): the provenance block is there with saliency, every
   candidate's reconstruction error is at most 1e-5, it equals the port's
   CPU block (blame paths and counterfactual order outside drops within
   1e-6, values within the CPU tests' tolerances) and a second card run
   bit for bit; the attribution is timed.
   ``python -m rca_tpu_torch hypotheses --fixture 50svc --seed 7
   --compact`` must put the fixture's fault root first over a batch of 8.
   The commands of items 7, 8, 9, 12 and 17 (``analyze`` with no
   cluster, ``analyze --fixture 50svc``, ``hypotheses``, ``stream``,
   ``train``) start together as subprocesses at phase 7, beside the
   phases between, and are each held to their gate here
   (:func:`commands_start`, :func:`commands_finish`): their start-ups
   overlap;
10. resident sessions at both tiers: a seeded request sequence (first,
   identical, deltas of 1 / 8 / 64 rows with NaN and Inf rows, a delete,
   a delta wider than ``n_pad / 2``, the heal, identical again) through
   ``GraphEngine()`` (``RCA_RESIDENT`` on): every request launches the
   main path's counts, is bitwise ``GraphEngine(resident=False)`` of the same
   features (the ``[4, n_pad]`` stack, the top-k with its tie order,
   ``sanitized_rows``) and the session's upload and fetch bytes are what
   the reference's formula predicts; the host walls of a delta request,
   an identical one and a restaged one;
11. streaming ticks at 2047, 10,000 (BASELINE.md row 4's size) and 49,999
   services: 30 ticks of a ``StreamingSession`` (deltas of 1 / 8 / 64
   rows with NaN/Inf, deletes, a delta wider than ``n_pad / 2``, quiet
   ticks, one ``set_all`` carrying NaN rows): each tick launches the
   main path's counts, the ``evidence_front`` launch persisting (counted
   apart in ``PERSIST_LAUNCHES``) on delta ticks only, the buffer is
   bitwise its plain version's (a twin session on the ``torch`` row,
   whose ranking it matches within rtol 1e-5 / atol 1e-6), a manual
   depth-2 pipeline is the serial run shifted by one, bitwise, every
   ``dispatch`` runs under ``torch.cuda.set_sync_debug_mode("error")``,
   and ``memory_allocated`` passes kernelscope's leak gate; then the
   tick's wall, ``dispatch_ms`` and ``fetch_ms`` per size;
12. the live session: the 50-service fixture, 60 polls of the live tests'
   mutation mix at depths 1 and 2, and a 10,000-service cascade world,
   20 polls at depth 2, each against the port's CPU run of a twin world
   (components and order exact, scores within rtol 1e-5 / atol 1e-6):
   depth 2 is depth 1 shifted by one, bitwise; no tick degraded, took a
   rung or recorded a fault; a dispatch made to fail on every rung takes
   ``single-device`` and then raises ``KernelPathFailed`` (the card never
   takes the ``interpret`` rung); then ``python -m rca_tpu_torch stream
   --fixture 50svc --ticks 10 --pipeline-depth 2 --interval 0``, whose
   top-1 must be the fixture's root; the quiet, busy and sweep capture
   times and the tick at 10,000.  Every session takes the columnar
   default and must keep it to its end; the 10,000-service run is
   repeated on the dict capture for its capture times, and over the live
   columnar feed (``LiveColumnarFeed``, what ``K8sApiClient`` serves over
   a connected cluster, here over the mock), which must rank every tick
   as the session over the mock's own columnar feed, with the same
   changed rows and a fault root first;
13. the node-sharded engine (``ShardedGraphEngine`` over a mesh whose
   device list repeats ``cuda:0``: logical shards, where the plan's
   ``steps_form`` is ``shard_grid`` and each recursion one cooperative
   launch over every shard of the card, ``seg_up_steps_shard`` /
   ``seg_down_steps_shard`` (``csrc/segshard.cu``), and the front one
   cooperative launch over every shard's rows, ``evidence_front_shard``
   (``csrc/frontshard.cu``); with two cards or more also the ``peer``
   form over distinct cards (:func:`multi_card_phase`), else a line
   saying the collectives were device-local and the peer recursions'
   rehearsal, started beside the capture phase in a process of its own:
   ``seg_up_steps_peer`` / ``seg_down_steps_peer`` (``csrc/segpeer.cu``)
   as two ranks of ``cuda:0``, one launch a rank on a stream of its own,
   each grid at half the card's co-resident CTAs, bitwise the per-step
   composition and the plain version at 2047 and 49,999 over 1 / 8 / 16
   lanes, timed beside the composition (a sleep on every card, the
   slowest card's span), launched back to back at different widths over
   both graphs, then rank 0 alone, which must trap at its bounded wait):
   the per-shard entries
   of ``seg_up_step`` / ``seg_contrast_step`` (bitwise) and
   ``seg_down_step`` (rtol 1e-5 / atol 1e-6) against their plain versions
   over the tiers' layouts, a star split across the shards and a hub cut
   by a shard boundary; the two shard recursions bitwise the per-step
   composition they replace (the per-shard kernels between the
   collectives) and through it the plain version (``u`` bitwise, ``m`` at
   rtol 1e-5 / atol 1e-6), twice each, at 2047 and 49,999 services on 4
   shards, at 49,999 on 8, on a dp = 2 row of 2 shards (4 and 8 lanes),
   on the star and the hub, at 0, 1, 8 and 13 steps over 1, 8 and 16
   lanes (NaN and Inf in the last lane); the sharded front
   ``evidence_front_shard`` bitwise the per-shard composition it replaces
   (the row pass a shard, the ``e`` gather, the contrast a shard: the
   kernels, run on the card) and the plain version, twice each, over the
   same layouts at 1, 8 and 16 lanes (2 rows of 4 and 8 on the dp = 2
   row; NaN / Inf rows in the last lane; a flat front over resident
   buffers' views, half of them at an unaligned base), at a contrast
   weight of 0 and the packaged one; the engine at 2047 and 49,999
   services with ``sp = 4`` and at 49,999 with ``sp = 8``, restaged and
   resident, each analysis counted from 0: ``evidence_front_shard`` /
   ``seg_up_steps_shard`` / ``seg_down_steps_shard`` one each, the
   per-shard front and steps none, the collectives the degree's
   reduce-scatter alone (``(sp - 1) * block * 4`` bytes through every
   shard); then the same analysis in the ``step`` form in the same run
   (``evidence_front`` / ``seg_contrast_step`` sp, sp x 8 / 8 per-shard
   steps, 19 gathers and 9 reduce-scatters, the reference's round-5
   formula) bitwise the ``shard_grid`` one; ``a`` / ``h`` / ``u`` bitwise the dense engine on the card, ``m``
   and scores within rtol 1e-5 / atol 1e-6, top-3 identical,
   ``sanitized_rows`` identical on NaN/Inf rows, a second run and every
   resident request bitwise restaging; ``analyze_batch`` on ``dp = 2, sp
   = 2`` (B = 8, one launch per recursion a row) lane by lane against the
   dense batch and bitwise the step form; ``ShardedStreamingSession`` at
   10,000 services, 30 ticks (the sharded analysis's launches a tick)
   ranking as the dense session, its blocks bitwise a ``torch``-row
   twin's, every ``dispatch`` sync-free and one behind a sleep kernel
   pending; a live session over the 50-service fixture on a sharded
   engine (20 polls, the root first), whose failing dispatch steps the
   ladder to ``single-device``; then the sharded and dense
   ``analyze_arrays`` walls, device times, busy shares and launches, the
   tick walls, each per-shard kernel's card, call and plain time beside
   its bound (the row pass too), the sharded front's and the shard
   recursions' card, call and plain time beside their bound and the
   per-shard composition's in the same call (at sp 4 and, at 49,999, sp
   8; the front beside the dense fused front over the same rows), the sp = 4 walls of the two forms and the dense
   engine in turns, and the allocator's peak over a 16-lane batch at
   49,999 on 8 shards in each form (alone with ``--sharded-only``);
14. the serving scheduler (``rca_tpu_torch.serve``): ``serve_selftest``
   on the card without chaos (every request ok or shed, nothing degraded)
   and with seeded dispatch/fetch faults (every request resolved, every
   ok answer bitwise its solo run); then per tier a ``BatchDispatcher``
   driven at widths 1, 2, 3, 4, 8 and 16, full staging and delta staging
   (a NaN row in one lane), each batch the main path's counts, its
   ``dispatch`` under ``torch.cuda.set_sync_debug_mode("error")`` and
   every lane bitwise its solo card analysis; each main-path kernel's
   launch over 1, 2, 4 and 16 lanes against its batched plain version and
   timed (the fused recursions beside their 8 per-step launches); 64
   requests (dense and sparse perturbations, 4 tenants, 4
   submitter threads) through a ``ServeLoop`` (max batch 16) and through
   a ``max_batch = 1`` loop, in turns, twice, after one warm load: every
   response ok and bitwise its solo run, every device batch the main
   path's counts and sync-free, with analyses per second, device batches, mean
   width and per-tenant queue wait and submit → completion p50 / p99;
   then the same requests through a pool of two dense replicas on the
   card with replica 0 killed mid-wave and through a ``dense,sharded@4``
   pool: every response ok, no double completion, every answer bitwise
   its own kind's solo engine, every dispatch sync-free and counted on
   its own (one lock over the replicas' device calls), each dense batch
   the main path's counts and each sharded batch 1 / 1 / 1 launches of
   the sharded front ``evidence_front_shard`` and the shard recursions
   ``seg_up_steps_shard`` / ``seg_down_steps_shard``, none of the
   per-shard front and steps;
15. flight recording and replay (``rca_tpu_torch.replay``): 20 polls
   of the live mix over a 10,000-service cascade world at depth 2 on the
   columnar capture, recorded and unrecorded in turns (the record
   overhead per poll, the bytes per tick); the tape holds ``coldiff``
   frames and ``replay_stream`` on the card is bitwise (``parity_ok``, no
   unconsumed call, the ``kernels`` row on every tick, each tick's
   launches those of the recorded poll; replayed ticks per second); a
   200-tick ``run_chaos_soak`` over the 50-service fixture world with its
   record leg (no uncaught exception, the five fault classes, fault-free
   ticks bitwise the baseline, its replay in parity on ``kernels``, no
   post-warm recompile, the memory gate); the serve phase's 64 requests
   at 2047 through ``ServeLoop(recorder=...)``, replayed bitwise by
   ``replay_serve``; the committed CPU tape
   (``tests/corpus_torch/``) replayed on the card under rank parity.  No
   recording leaves a ``serve.record`` or ``live.*`` fault; tapes go to a
   temporary directory, removed after;
16. the ``quantized`` and ``doubling`` registry rows at both tiers beside
   ``kernels`` and ``torch`` (``RCA_KERNEL`` names each; the card's race
   leaves them out): one restaged ``analyze_case`` per row counted from
   0 (``kernels`` the main path's counts; ``doubling`` the front's one
   launch and no seg step
   where it engages, or a plan that says ``kernels`` and the main path's
   counts where the frontier cap declines the graph, and it must engage at
   2047;
   ``quantized`` and ``torch`` none), doubling's ``u`` bitwise the
   ``kernels`` row's with scores at rtol 1e-5 / atol 1e-6 and the same
   top-k, ``quantized`` in rank parity with ``kernels``, every row
   bitwise itself over two runs; each row's ``analyze_arrays`` wall
   (restaged, median of 20); at 2047 an 8-lane ``analyze_batch`` and a
   streaming session under ``RCA_KERNEL=doubling``, bitwise their solo
   analyses.  Then the ``layouts`` leg at both tiers: one restaged
   ``analyze_case`` per ``RCA_EDGE_LAYOUT`` counted from 0 (``hybrid``
   and ``coo`` the main path's counts; ``ell`` the front's one launch
   and 8 ``segscan_sum``, then the gather tables with the
   overflow's flagged sum), each result and the registry row stamped
   with the ``kernels`` row and the layout, ``coo``'s ``u`` bitwise
   ``hybrid``'s and its scores at rtol 1e-5 / atol 1e-6, ``ell``'s ``u``
   bitwise and its scores within 1e-6, top-k identical, each layout
   bitwise itself over two runs, an 8-lane ``ell`` batch bitwise its
   solo runs, ``segscan_sum`` over the ``ell`` down overflow against its
   plain version (rtol 1e-5 / atol 1e-6), each layout's
   ``analyze_arrays`` wall (restaged, median of 20) and the full-ELL
   tables' widths, overflow and bytes;
17. training at the ``train`` command's defaults: the first 5 Adam
   iterations on the card against the CPU run of the same config (losses
   at rtol 1e-4, raw values at rtol 1e-4 / atol 1e-6), the 150-iteration
   fit on the card (ms per iteration, the wall, the first and last loss),
   ``shippability_report`` of its weights on the card equal as a dict to
   the same report on the CPU, and ``python -m rca_tpu_torch train
   --iters 20 --out <tmp>.json --allow-unshippable`` (exit 0, its
   checkpoint loaded by ``GraphEngine()`` under ``RCA_WEIGHTS``);
18. the investigation layer over ``synthetic_cascade_world(2047,
   n_roots=3, seed=0)``: a coordinator on the card (offline provider, an
   evidence logger and a prompt logger in a temporary directory) runs a
   comprehensive analysis, the guided hypothesis workflow (hypotheses,
   plan, every step, the report) on the top root cause and on the first
   pod-level finding, a chat turn, the five suggestion types and the
   chat turn's suggested actions, each followed by
   ``update_suggestions_after_action``, then the analysis with
   ``use_llm_agents=True``: every output equals the port's CPU run of the
   same sequence without the volatile keys (ids, clocks, ``latency_ms``,
   ``profile``), the evidence files too, the top cause is an injected
   root and the ``run_agent`` suggestion launches 1 / 1 / 1; each
   stage's host wall (median of 5).  Then ``python -m rca_tpu_torch chat
   --investigation new``, ``suggest`` and ``report --out`` over
   ``--fixture 50svc`` in subprocesses, one explained request naming the
   investigation through ``ServeLoop(store=...)``, whose provenance and
   serve note must land in the store, and ``investigations`` and ``why``
   (which must print the stored blame tree), every command exiting 0;
19. the gateway (``rca_tpu_torch.gateway``) in front of a ``ServeLoop``
   on the card, every wire request served in a device batch of the
   kernels: at 2047 services a concurrency-16 load over 4 tenants, then
   the serve phase's 64-request mix over the wire and in process, in
   turns (every wire ranking equal to its in-process answer and its solo
   card analysis, every device batch the main path's counts and
   sync-free, nothing degraded, the registry row ``kernels`` and named by
   ``/metrics``, ``/v1/subscribe`` receiving every wire response; the
   wire and in-process submit → response p50 / p99, device batches, mean
   width, and the host ms of ``encode_analyze``, ``json.dumps``,
   ``json.loads`` and ``decode_analyze`` per request); at 49,999 a
   gateway with ``max_body`` 32 MiB serves 4 requests, each bitwise its
   solo analysis at the main path's counts per device batch, with the
   codec's ms on the 15 MB body, and the same request declared to a
   default-cap gateway gets 413 before its body is read, with no device
   batch, launch or queue entry; the front door: 429 and 503 with
   ``Retry-After`` and its jittered ms header (a saturated queue of cap
   1, a deadline already past), 400, 404, ``/healthz`` 200 and 503 once
   the plane stops, ``?explain=1`` with its provenance read back from
   ``/v1/explain/<trace_id>``, one TLS request with a bearer token
   (``tests/fixtures/gateway_*.pem``) bitwise the plain answer; then
   ``python -m rca_tpu_torch serve --listen 127.0.0.1:0 --max-batch 8``
   in a subprocess (its banner, 16 requests bitwise their in-process
   answers, exit 0 on SIGTERM) and the ``canary`` command over
   ``--fixture 20svc --rounds 1``: ``--mode both`` and ``--mode
   multicluster`` exit 0, ``--candidate-decay 0.5`` exits 1 naming the
   bisected tick, and ``--listen-url`` against the subprocess's gateway
   mints a recording that replays bitwise;
20. times from CUDA events (median of 20 samples after warm-up): each
   kernel's device time (``ms``, launches queued behind a sleep kernel so
   the host's per-call cost is hidden) and its per-call cost to a caller
   (``call_ms``) beside its bound, its plain version and, where one
   PyTorch call computes the same reduction, that call (``library_ms``;
   the port never calls it); for each seg-step kernel also the step as
   composed around the flagged-scan kernel (gather, scan, ``s[ends]``,
   ``where``, epilogue: ``scan_step_ms`` / ``scan_step_call_ms``, timed
   the same way); the fused front ``evidence_front_fused`` (one launch;
   its persisting launch ``persist_*``) in turns with the two-launch
   front it replaced (``two_launch_ms`` / ``two_launch_call_ms``, also
   the ``front`` row, ``front_ms`` / ``front_call_ms``, with its bound),
   and that beside the first port's front, the sanitize's torch
   ops, the ``noisy_or_pair`` kernel, the error-source scatter and the
   fold (``plain_front_ms`` / ``plain_front_call_ms``); the persisting
   ``evidence_front`` row pass (``persist_*``); at 2047 each
   fused recursion beside the 8 per-step launches it replaces
   (``per_step_ms`` / ``per_step_call_ms``); the end-to-end
   ``analyze_arrays`` wall time at both tiers, restaged, and again with
   the recursions in one launch each (one CTA a lane at 2047, the grid
   at 49,999) and per step in turns (``analyze_arrays_fused_ms`` /
   ``analyze_arrays_per_step_ms``; with ``--profile`` also each tier's
   device profile run per step);
21. the instruments (``observe``): ``python -m rca_tpu_torch profile
   --services 10000 --ticks 20`` in a subprocess, whose Chrome trace must
   hold 20 ``rca_tick`` ranges, 20 ``tick.dispatch`` and 20
   ``tick.fetch`` annotations and the main path's device kernels of 20
   ticks at 10,000 services by symbol (``evidence_front_fused``,
   ``seg_up_steps_grid`` / ``seg_down_steps_grid`` 20 each, no other
   kernel of the port), its ``ms_per_tick`` beside the same 20 polls
   unprofiled;
   ``python -m rca_tpu_torch kernels --services 2047,49999 --edges ...
   --cost-max-pad 65536 --json`` in a subprocess, every dense row with
   the model's ``flops`` / ``bytes_accessed`` (``basis`` ``"model"``)
   and the allocator's ``peak_temp_bytes``, the 2047 row's front and
   recursions moving the bytes behind phase 20's bounds (the recursions'
   long segments apart), and the modelled bytes over 3.35 TB/s beside
   the row's ``t_win_ms``; a ``/metrics`` scrape of a ``ServeLoop`` after
   the dense rows' capture in this process sampling the three
   ``rca_kernel_cost_*`` families without capturing anything, the loop's
   recompile window closed once it stops; ``run_tracecheck()`` on the
   card ``ok`` on all four entries;
22. the cross-process plane (``federation``): at 2047 services the serve
   cell's 64-request mix and at 49,999 4 requests (15 MB bodies) through
   a ``FederationPlane`` of 3 worker processes on the card
   (``RCA_KERNEL=kernels``, ``RCA_SHARD=0``; each its own CUDA context),
   in turns with the same load on an in-process 3-replica ``ServePool``
   (federation, pool, pool, federation): every answer ok and bitwise its
   solo analysis in this process, submit → completion p50 / p99 beside
   the pool's, worker start-up to ready, each worker's hello and drain
   report (its launches, counted from 0 in a fresh process: the main
   path's per device batch, nothing else; its registry rows, all
   ``kernels``), no double completion, stale response or reroute; beside
   the 2047 load an ingest worker that ticks two clusters and never makes
   a CUDA context (its hello reports no device, ``nvidia-smi`` lists no
   context of its pid); the kill wave, ``federation_selftest(workers=3,
   kill_worker=True)`` at 2047, whose workers read the row this process
   elected from ``RCA_KERNEL_CACHE`` (``source == "cache"``), every
   request terminal, ``recovery_ms``; ``serve --federation 3
   --kill-worker``, ``ingest`` and ``serve --listen --federation 2`` (4
   requests over the wire bitwise solo, ``fleet URL``'s worker table)
   as subprocesses at once, then (under ``--federation-only``; the full
   run leaves it to phase 23's ``chaos --ticks 200``, the same legs and
   the storm) ``chaos --ticks 200 --no-autoscale``, which must observe
   ``process_kill``, ``worker_hang``, ``coordinator_partition`` and
   ``ingest_death``; and
   ``initialize_distributed`` with a named coordinator, world size 1, on
   NCCL, one all-reduce, the group destroyed.  Every line carries the
   card's name and power limit.  Phase 2's build runs as two processes
   started at once on the cold build directory; both must load the same
   library;
23. the elastic fleet (``autoscale``), every line with the card's name
   and power limit: ``run_scale_ramp_soak(seed=0, min_workers=2,
   max_workers=8)`` at 2047 services on the card (``RCA_KERNEL=kernels``,
   ``RCA_SHARD=0``; the thread fleet on one engine): the reference's
   gates, every ok answer bitwise its solo analysis in this process, no
   double completion, and the launches over the soak exactly the main
   path's per device batch (1 / 1 / 1), with ``ramp_up_s``,
   ``ramp_down_s``, request p50 / p99, ``scale_decision_ms_p50`` and
   ``placement_hit_rate``; a ``FederationPlane(workers=2)`` of worker
   processes at 2047 on the default lease under an
   ``AutoscaleController`` on the plane's ``spawn_worker`` with the
   soak's table inside 2..4, walked 2→4→2 by a closed-loop load: every
   request terminal and every ok answer bitwise solo, no double
   completion, reroute or ``worker_down``, every worker reading the row
   this process elected from ``RCA_KERNEL_CACHE`` (``source ==
   "cache"``), ``nvidia-smi``'s contexts two more at the peak and back at
   the end (its ``pid, used_memory`` listing at the peak), spawn → lease
   per worker, each worker's heartbeat gaps, and the launches summed over
   the four drain reports the main path's per device batch;
   ``run_scaling_storm(seed=7)`` in thread mode and over worker
   processes, each ``ok`` with ``scaling_storm`` observed, no double
   completion, stale drops within their bound and no worker down but the
   three its races cause, over processes the contexts back to their count
   once it ends; then ``serve --autoscale 2:4`` and ``serve
   --listen 127.0.0.1:0 --federation 2 --autoscale 2:4`` (4 wire requests
   bitwise solo, ``fleet URL`` showing the bounds and a running
   controller) as subprocesses at once, and ``chaos --ticks 200``, which
   must observe ``process_kill``, ``worker_hang``,
   ``coordinator_partition``, ``ingest_death`` and ``scaling_storm`` (it
   counts no context: started at the phase's end, it runs beside phase 24
   and is held to its gates after it).
24. ``lint``: the analysis plane on the card (:func:`lint_phase`).
   ``python -m rca_tpu_torch lint --all --json`` starts as one
   subprocess (the rules, tracecheck, rsan and specsan in one
   interpreter, one CUDA context and one parse of the tree): exit 0, no
   finding, an empty baseline, tracecheck, specsan and rsan ok, 15
   rules run with ``dtype-discipline`` and ``shape-contract`` among them
   (its files scanned, the rules' wall, those two rules' walls and rsan's
   acquires and locks printed).
   Meanwhile specsan (``run_specsan(seed=0, device="cuda")``) runs its
   session leg at 2047 and 49,999 services and its serve leg once:
   ``ok``, no violation, every budgeted surface of the dense path
   confirmed (the sharded engine's three named as unexercised), per
   surface the calls and the largest transfer beside its budget, the
   legs' rankings bitwise those of the same legs run uncaptured first,
   and the launches of the main path's kernels: ``evidence_front_fused``,
   ``seg_down_steps`` and ``seg_up_steps`` at 2047 and in the serve leg,
   one ``seg_down_steps_grid`` / ``seg_up_steps_grid`` a front launch at
   49,999, no per-step launch.
   Then, specsan done (the sanitizer is process-global), the rsan leg:
   ``run_rsan_crosscheck(seed=7, soak_ticks=40, device="cuda")`` on the
   ``kernels`` row (``ok``, no contradiction, no observed race, at least
   2 locks taken from at least 2 threads, 40 ticks with no uncaught
   exception, every poll of the soak the main path's launches, the
   sanitizer off after), and a sanitized two-replica ``ServePool`` at
   2047: 8 submitter threads x 8 requests over 4 tenants, replica 0
   killed after its first device batch, every ok answer bitwise its solo
   analysis, no double completion, no observed race, no contradiction
   against the port's static order graph, the pool's, the queue's, the
   replicas' and the sink's locks taken from at least 2 threads, each
   device batch the main path's launches.

Every phase's wall lands in ``phase_seconds`` (the kernel checks, the
main path, the comparison and the times included), each phase's record
carries its ``seconds``, and a ``walls`` line prints their sum beside
the run's wall.

The line before the last is the ``{"kernels": [...]}`` JSON (the one-CTA
recursions' rows with their 2047-service numbers and the grid
recursions' with their 49,999-service numbers (and ``at_10000``), where
the plan runs them, each with its per-step composition; the
node-sharded engine's kernels as rows of their own (the shard recursions
with the per-step composition's time beside theirs), with their launches
over one sharded analysis at 49,999 services on 4 logical shards; every dense kernel with
its launches per sharded analysis beside its dense count; every kernel
with ``serve_launches``, its launches per serve device batch by lane
count and over each tier's coalesced load and pool runs, the per-shard
entries per sharded device batch and over the dense + sharded pool's
sharded batches; each main-path kernel also with its launches
per batch and its batched times (``serve_batch``: at 1, 2, 4 and 16
lanes),
and the launches counted on a delta tick, a quiet tick and an 8-row
resident delta request at 49,999 services, ``evidence_front_fused`` and
``evidence_front`` also their persisting launches there; the tick kernels with
``replay_launches``, over the 20 replayed ticks of the 10,000-service
tape, and ``variant_launches``, per analysis on the ``doubling`` and
``quantized`` rows at each tier; every main-path kernel with
``layout_launches``, per analysis under each ``RCA_EDGE_LAYOUT`` at each
tier, ``investigate_launches``, over the investigation's
``run_agent`` suggestion, ``oomchain_launches``, over the OOM chain's two
analyses, and ``ui_launches``, over the Stream tab's 3 polls per world,
and ``gateway_launches``, per device batch
behind the gateway at each tier and over the gateway's loads, and
``profile_events``, its device events in the ``observe`` phase's trace
of 20 ticks at 10,000 services, and ``federation_launches``, summed over
the worker processes of each federation load leg with their device
batches, and over the kill wave's survivors, and ``autoscale_launches``,
over the thread soak's fleet and the process fleet's four workers at
2047, with their device batches, and ``rsan_launches``, over the rsan
cross-check's 40 soak ticks and the sanitized pool's device batches);
the last line
is ``{"ok": true, "device": {...}}``.  With ``--out DIR`` the full record
goes to ``DIR/chip_smoke.json``, every phase line as it prints to
``DIR/phases.jsonl`` and each profile table to
``DIR/profile_<services>.txt``.  Imports nothing of JAX or ``rca_tpu``.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

TIERS = ((2047, 3, 0), (49999, 3, 0))   # (services, roots, seed)
C = 13


#: seeded inputs generated once per argument set (pickled), see _world
_GENERATED: dict = {}


def _generated(kind: str, n: int, n_roots: int, seed: int):
    """``synthetic_cascade_world`` (``kind="world"``) or
    ``synthetic_cascade_arrays`` (``"arrays"``) of ``n`` services,
    generated once per argument set and handed out as fresh copies: a
    session mutates its world, and a pickle round trip copies one bit for
    bit in a tenth of a generation's time at 10,000 services.  A world
    is built over the arrays of the same arguments (the generator's first
    step), which are generated once too."""
    import pickle

    key = (kind, n, n_roots, seed)
    if key not in _GENERATED:
        from rca_tpu_torch.cluster import generator

        if kind == "world":
            _generated("arrays", n, n_roots, seed)
            arrays = generator.synthetic_cascade_arrays

            def reuse(n_, n_roots_, seed_, **kwargs):
                if (n_, n_roots_, seed_) == (n, n_roots, seed) and not any(
                        kwargs.get(k, v) != v for k, v in
                        (("mode", "standard"), ("fault_mix", "crash"))):
                    return pickle.loads(_GENERATED["arrays", n, n_roots,
                                                   seed])
                return arrays(n_, n_roots_, seed_, **kwargs)

            with mock.patch.object(generator, "synthetic_cascade_arrays",
                                   reuse):
                made = generator.synthetic_cascade_world(
                    n, n_roots=n_roots, seed=seed)
            # derived lookup state keyed by list identity: each copy
            # rebuilds its own on first use
            made._pos_index.clear()
        else:
            made = generator.synthetic_cascade_arrays(
                n, n_roots=n_roots, seed=seed)
        _GENERATED[key] = pickle.dumps(made,
                                       protocol=pickle.HIGHEST_PROTOCOL)
    return pickle.loads(_GENERATED[key])


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


#: with ``--out``: the file every phase line is also appended to as it
#: prints, with the seconds since the run began, so a run cut short still
#: leaves the record of the phases it passed; and the run's start
PHASE_LOG = None
RUN_T0 = time.perf_counter()


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}, default=float), flush=True)
    if PHASE_LOG is not None:
        with open(PHASE_LOG, "a") as f:
            f.write(json.dumps({"phase": name, **fields,
                                "t_s": time.perf_counter() - RUN_T0},
                               default=float) + "\n")


def _timed(walls: dict, name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall kept in ``walls[name]`` and, where
    the phase returns a record without one, as its ``seconds``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    walls[name] = time.perf_counter() - t0
    if isinstance(out, dict):
        out.setdefault("seconds", walls[name])
    return out


def _phase_walls(walls: dict, t_run: float, record: dict) -> None:
    """Print every phase's wall, their sum and the run's wall beside it
    (the rest is set-up between phases: imports, inputs, the verdict)."""
    wall = time.perf_counter() - t_run
    record["wall_s"] = wall
    phase("walls", phase_seconds={k: round(v, 3) for k, v in walls.items()},
          phase_sum=sum(walls.values()), wall=wall)


def _side_start(*argv, env=None, script: bool = True, tmp=None) -> dict:
    """Start ``python chip_smoke.py *argv`` (``script``; else ``python
    *argv``) in a process of its own, its output to files in ``tmp`` (a
    new temporary directory by default), so that it runs beside the
    phases that follow; a run that fails before the join stops it too."""
    import tempfile

    tmp = tmp or tempfile.mkdtemp(prefix="chip_smoke_side_")
    files = [open(os.path.join(tmp, name), "w")
             for name in ("stdout.txt", "stderr.txt")]
    head = [os.path.abspath(__file__)] if script else []
    proc = subprocess.Popen([sys.executable, *head, *argv], env=env,
                            stdout=files[0], stderr=files[1])
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "tmp": tmp, "files": files,
            "t0": time.perf_counter()}


def _side_wait(handle, timeout: float) -> tuple:
    """``(exit code, stdout, stderr)`` of a started process (killed past
    ``timeout`` seconds from now, its code then saying so), its files
    removed; ``handle["seconds"]``: its wall from its start."""
    import shutil

    try:
        code = handle["proc"].wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        handle["proc"].kill()
        handle["proc"].wait()
        code = f"killed after {timeout} s"
    handle["seconds"] = time.perf_counter() - handle["t0"]
    for f in handle["files"]:
        f.close()
    with open(os.path.join(handle["tmp"], "stdout.txt")) as f:
        stdout = f.read()
    with open(os.path.join(handle["tmp"], "stderr.txt")) as f:
        stderr = f.read()
    shutil.rmtree(handle["tmp"], ignore_errors=True)
    return code, stdout, stderr


def _side_join(handle, key: str, timeout: float = 900) -> dict:
    """The record under ``key`` in the last line of a started
    ``chip_smoke.py`` process, its phase lines printed here as they
    printed there; it must exit 0."""
    code, stdout, stderr = _side_wait(handle, timeout)
    lines = stdout.strip().splitlines()
    if code != 0 or not lines:
        fail(f"{' '.join(map(str, handle['proc'].args[2:4]))} exited {code}: "
             f"{stderr[-3000:]}")
    for line in lines[:-1]:
        if line.startswith('{"phase"'):
            fields = json.loads(line)
            phase(fields.pop("phase"), **fields)
    return json.loads(lines[-1])[key]


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


def cards_ms(fn, devices, reps: int = 20, inner: int = 10) -> tuple:
    """:func:`cuda_ms` (queued) over every card of ``devices``: each
    sample puts a sleep kernel on every card's current stream, then
    events on each card around the ``inner`` calls, and keeps the slowest
    card's span, so the launch skew between the cards is in it.  Returns
    the median of the slowest spans and the median of ``cuda:0``'s (or
    the first card's), in ms per call."""
    import numpy as np
    import torch

    cards = list(dict.fromkeys(devices))
    for _ in range(3):
        fn()
    for d in cards:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    enqueue_s = time.perf_counter() - t0
    for d in cards:
        torch.cuda.synchronize(d)
    spin_cycles = int(max(4 * enqueue_s, 1e-3) * 2e9)
    slowest, first = [], []
    for _ in range(reps):
        events = []
        for d in cards:
            with torch.cuda.device(d):
                torch.cuda._sleep(spin_cycles)
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                events.append([start])
        for _ in range(inner):
            fn()
        for d, pair in zip(cards, events):
            with torch.cuda.device(d):
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                pair.append(end)
        spans = []
        for start, end in events:
            end.synchronize()
            spans.append(start.elapsed_time(end) / inner)
        slowest.append(max(spans))
        first.append(spans[0])
    return float(np.median(slowest)), float(np.median(first))


def host_samples(fn, reps: int = 20) -> list:
    """Host walls in ms of ``reps`` calls of ``fn`` (which must end in a
    device sync) after 3 warm calls."""
    for _ in range(3):
        fn()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return samples


def host_ms(fn, reps: int = 20) -> float:
    """Median host wall of ``fn`` (which must end in a device sync)."""
    import numpy as np

    return float(np.median(host_samples(fn, reps)))


def bound(work) -> tuple:
    """``(ms, bound_by, bytes)``: the bound of ``work``, a ``(bytes,
    operations)`` pair of ``rca_tpu_torch/kernels/cost.py``, at the card's
    published peaks (``cost.bound_ms``), and the bytes behind it."""
    from rca_tpu_torch.kernels.cost import bound_ms

    return (*bound_ms(*work), work[0])


#: the two recursions' one-CTA kernels (csrc/segsteps.cu), their grid
#: kernels (csrc/seggrid.cu) and the per-step kernels both replace on the
#: dense path (csrc/segstep.cu)
FUSED_KERNELS = ("seg_up_steps", "seg_down_steps")
GRID_KERNELS = ("seg_up_steps_grid", "seg_down_steps_grid")
STEP_KERNELS = ("seg_up_step", "seg_down_step")
#: the node-sharded engine's kernels over every shard of one card, which
#: replace the per-shard launches there: the recursions (csrc/segshard.cu)
#: and the front (csrc/frontshard.cu)
SHARD_KERNELS = ("seg_up_steps_shard", "seg_down_steps_shard",
                 "evidence_front_shard")
#: its recursions over distinct cards, one cooperative launch a card
#: (csrc/segpeer.cu)
PEER_KERNELS = ("seg_up_steps_peer", "seg_down_steps_peer")
#: the tiers the grid recursions are checked at, and timed at (the last
#: two) beside the per-step launches
GRID_TIERS = (2047, 10000, 49999)
#: the depths the fused recursions are checked at: none (no launch), one,
#: the engine's 8 and 13 (config.propagation_steps sets the depth)
CHECK_STEPS = (0, 1, 8, 13)
#: the lanes they are checked and timed over: the serve widths
RECURSION_LANES = (1, 2, 4, 8, 16)


def fused(services: int) -> bool:
    """Whether the engine's plan runs each recursion with one CTA a lane
    at this many services (``steps_form`` ``cta``): where both layouts
    fit one CTA's shared memory, every graph up to the 2047-service tier.
    The 10,000 and 49,999 tiers do not fit and take the card's grid
    (``grid``)."""
    return services <= 2047


def whole_kernels(services: int) -> tuple:
    """The two one-launch recursions the plan runs at this many
    services, (up, down)."""
    return FUSED_KERNELS if fused(services) else GRID_KERNELS


def main_launches(services: int, times: int = 1) -> dict:
    """Every kernel's launches over ``times`` dense analyses (requests,
    ticks, device batches) of a graph of ``services`` on the ``kernels``
    row: ``evidence_front_fused`` once (the whole front; the row pass
    ``evidence_front`` and ``seg_contrast_step`` run only in the sharded
    engine's ``step`` form), then the two recursions once each, ``seg_up_steps`` and
    ``seg_down_steps`` where the plan fuses them into one CTA a lane,
    else ``seg_up_steps_grid`` and ``seg_down_steps_grid``; the per-step
    ``seg_up_step`` and ``seg_down_step`` never."""
    out = {"noisy_or_pair": 0, "segscan_sum": 0, "segscan_max": 0,
           "evidence_front": 0, "seg_contrast_step": 0,
           "evidence_front_fused": times, "seg_up_step": 0,
           "seg_down_step": 0, **dict.fromkeys(FUSED_KERNELS, 0),
           **dict.fromkeys(GRID_KERNELS, 0),
           **dict.fromkeys(SHARD_KERNELS, 0),
           **dict.fromkeys(PEER_KERNELS, 0)}
    out.update(dict.fromkeys(whole_kernels(services), times))
    return out


def recursion_runs(up, down, h, a_ex, inv_deg, decay: float, steps: int,
                   grid: bool = False):
    """The one-CTA recursions (``grid``: the grid recursions) over the
    layouts ``up`` / ``down`` on the card, each with the ``steps``
    per-step launches it replaces and its plain version: ``{name:
    (kernel, per_step, plain)}``."""
    import torch
    from rca_tpu_torch.engine.segscan import (
        down_seg_step,
        down_seg_steps,
        down_seg_steps_grid,
        down_seg_steps_plain,
        up_seg_step,
        up_seg_steps,
        up_seg_steps_grid,
        up_seg_steps_plain,
    )

    up_steps, down_steps = ((up_seg_steps_grid, down_seg_steps_grid) if grid
                            else (up_seg_steps, down_seg_steps))
    up_name, down_name = GRID_KERNELS if grid else FUSED_KERNELS

    def up_per_step():
        u = torch.zeros_like(h)
        for _ in range(steps):
            u = up_seg_step(u, h, decay, up)
        return u

    def down_per_step():
        m = torch.zeros_like(a_ex)
        for _ in range(steps):
            m = down_seg_step(m, a_ex, decay, down, inv_deg)
        return m

    return {
        up_name: (
            lambda: up_steps(h, decay, steps, up), up_per_step,
            lambda: up_seg_steps_plain(h, decay, steps, up)),
        down_name: (
            lambda: down_steps(a_ex, decay, steps, down, inv_deg),
            down_per_step,
            lambda: down_seg_steps_plain(a_ex, decay, steps, down, inv_deg)),
    }


def per_step_plans():
    """A context in which every plan runs the two recursions per step,
    whatever form it would name: the walls' and the profile's
    comparison."""
    return mock.patch("rca_tpu_torch.engine.runner.steps_form",
                      return_value="step")


def plain_recursion_ms(plain) -> float:
    """``cuda_ms`` of a recursion's plain version over 5 samples of 2
    calls: it enqueues some thousand torch ops a call (10-20 ms of host
    time), and the queued samples spin the card for 4x that each."""
    return cuda_ms(plain, reps=5, inner=2)


def recursion_bounds(up, down, lanes: int, steps: int = 8,
                     grid: bool = False) -> dict:
    """Each one-launch recursion's bound over its layout (``cost.up_steps``
    / ``cost.down_steps``, whichever form runs it: one pass over the CSR
    and the long ids, the vectors read and written; 3 operations an edge
    and 1 a node a step)."""
    from rca_tpu_torch.kernels import cost

    names = GRID_KERNELS if grid else FUSED_KERNELS
    return {name: bound(work(seg.offsets.shape[0] - 1, seg.other32.shape[0],
                             seg.long_ids.shape[0], lanes, steps))
            for name, seg, work in ((names[0], up, cost.up_steps),
                                    (names[1], down, cost.down_steps))}


def check_recursions(label, up, down, inv_deg, rng, decay: float,
                     grid: bool = False) -> dict:
    """The one-CTA recursions (``grid``: the grid recursions) over the
    layouts ``up`` / ``down`` (on the card) at every depth of
    ``CHECK_STEPS`` on a flat vector, and at the engine's 8 over every
    lane count of ``RECURSION_LANES``: bitwise ``steps`` per-step
    launches, bitwise over two runs, each lane bitwise its own flat
    launch, the up recursion bitwise its plain version and the down
    recursion within rtol 1e-5 / atol 1e-6 of it.  The even lanes carry
    the dummy slot (the last) at 0, as the engine's inputs do, the rest
    random.  Returns each kernel's largest error against plain."""
    import numpy as np
    import torch

    n_pad = up.offsets.shape[0] - 1
    dev = up.offsets.device
    names = GRID_KERNELS if grid else FUSED_KERNELS
    errs = dict.fromkeys(names, 0.0)
    cases = [(None, s) for s in CHECK_STEPS] + [
        (b, 8) for b in RECURSION_LANES[1:]]
    for lanes, steps in cases:
        shape = (n_pad,) if lanes is None else (lanes, n_pad)
        x = torch.from_numpy(rng.uniform(0.0, 1.0, shape).astype(
            np.float32)).to(dev)
        if lanes is not None:
            x[::2, -1] = 0.0
        runs = recursion_runs(up, down, x, x, inv_deg, decay, steps, grid)
        for name, (kernel, per_step, plain) in runs.items():
            got, again, want, ref = kernel(), kernel(), per_step(), plain()
            torch.cuda.synchronize()
            where = f"{name}, {label}, {steps} steps, lanes {lanes}"
            if not torch.equal(got, again):
                fail(f"{where}: not deterministic")
            if not torch.equal(got, want):
                fail(f"{where}: not bitwise {steps} per-step launches")
            if name == names[0] and not torch.equal(got, ref):
                fail(f"{where}: not bitwise equal to plain")
            if not torch.allclose(got, ref, rtol=1e-5, atol=1e-6):
                fail(f"{where}: disagrees with plain")
            if lanes is not None:
                for b in range(lanes):
                    solo = recursion_runs(up, down, x[b], x[b], inv_deg,
                                          decay, steps, grid)[name][0]()
                    if not torch.equal(got[b], solo):
                        fail(f"{where}: lane {b} differs from its flat "
                             f"launch")
            errs[name] = max(errs[name], float((got - ref).abs().max()))
    phase("check", kernel=" + ".join(names), layout=label,
          n_pad=n_pad, steps=list(CHECK_STEPS),
          lanes=list(RECURSION_LANES), bitwise_per_step=True,
          bitwise_lanes=True, max_abs_err=errs)
    return errs


def time_recursions(up, down, inv_deg, rng, decay: float,
                    lanes: int = 1, grid: bool = False,
                    plain: bool = True) -> dict:
    """Each one-CTA recursion (``grid``: each grid recursion) at the
    engine's 8 steps over ``lanes`` lanes (a flat vector for 1), its
    inputs' dummy slot at 0 as the engine gives it: its device time
    (``ms``; ``one_step_ms`` for one step) and cost to a caller
    (``call_ms``) beside the 8 per-step launches it replaces
    (``per_step_ms`` / ``per_step_call_ms``), its plain version (``plain``
    False: None) and its bound, all in this run."""
    import numpy as np
    import torch

    n_pad = up.offsets.shape[0] - 1
    shape = (n_pad,) if lanes == 1 else (lanes, n_pad)
    x = torch.from_numpy(rng.uniform(0.0, 1.0, shape).astype(
        np.float32)).to(up.offsets.device)
    x[..., -1] = 0.0
    bounds = recursion_bounds(up, down, lanes, grid=grid)
    one = recursion_runs(up, down, x, x, inv_deg, decay, 1, grid)
    out = {}
    for name, (kernel, per_step, plain_fn) in recursion_runs(
            up, down, x, x, inv_deg, decay, 8, grid).items():
        out[name] = {
            "ms": cuda_ms(kernel), "call_ms": cuda_ms(kernel, queued=False),
            # one step: the launch, its ramp and one step's work
            "one_step_ms": cuda_ms(one[name][0]),
            "per_step_ms": cuda_ms(per_step),
            "per_step_call_ms": cuda_ms(per_step, queued=False),
            "plain_ms": plain_recursion_ms(plain_fn) if plain else None,
            "library_ms": None, "bound": bounds[name]}
    return out


def tier_layouts(n: int, device):
    """The engine's padded layouts of ``synthetic_cascade_arrays(n,
    n_roots=3, seed=0)`` on ``device`` and its inverse in-degree (padded
    edges included): ``(up, down, inv_deg)``."""
    import numpy as np
    import torch
    from rca_tpu_torch.engine import GraphEngine
    from rca_tpu_torch.engine.segscan import build_seg_layouts

    case = _generated("arrays", n, 3, 0)
    f, src, dst = GraphEngine(device="cpu")._pad(
        case.features, case.dep_src, case.dep_dst)
    n_pad, e_pad = f.shape[0], len(src)
    down, up = build_seg_layouts(n_pad, e_pad, case.dep_src, case.dep_dst,
                                 device=device)
    inv_deg = torch.from_numpy((1.0 / np.maximum(np.bincount(
        dst, minlength=n_pad), 1)).astype(np.float32)).to(device)
    return up, down, inv_deg


def recursions_phase(smi: str, decay: float) -> dict:
    """The grid recursions on the card: at each tier of ``GRID_TIERS``
    (``check_recursions(grid=True)``: every depth, every lane count,
    bitwise the per-step launches, over two runs and lane by lane), on a
    star whose one segment holds 4096 edges and on the degenerate
    layouts; then their times beside the 8 per-step launches at 10,000
    and 49,999, and at 2047 for the record (the times phase times the
    one-CTA kernels there).
    Returns the errors against plain and the times by tier."""
    import numpy as np
    import torch
    from rca_tpu_torch.engine.segscan import build_seg_layout, steps_form

    dev = torch.device("cuda")
    rng = np.random.default_rng(2323)
    out = {"errs": dict.fromkeys(GRID_KERNELS, 0.0), "times": {},
           "forms": {}, "smi": smi}

    def note(errs):
        for name, err in errs.items():
            out["errs"][name] = max(out["errs"][name], err)

    layouts = {n: tier_layouts(n, dev) for n in GRID_TIERS}
    for n, (up, down, inv_deg) in layouts.items():
        out["forms"][str(n)] = steps_form(down, up, dev)
        if out["forms"][str(n)] != ("cta" if fused(n) else "grid"):
            fail(f"recursions: the form at {n} is {out['forms'][str(n)]}")
        note(check_recursions(f"{n} services", up, down, inv_deg, rng,
                              decay, grid=True))
    star = build_seg_layout(2048, 4096, np.full(4096, 7, np.int32),
                            rng.integers(0, 2047, 4096).astype(
                                np.int32)).to(dev)
    note(check_recursions("star, 4096 edges in one segment", star, star,
                          torch.full((2048,), 1.0 / 4096, device=dev), rng,
                          decay, grid=True))
    for label, layout in degenerate_layouts(rng).items():
        seg_d = layout.to(dev)
        note(check_recursions(label, seg_d, seg_d, torch.full(
            (64,), 0.25, dtype=torch.float32, device=dev), rng, decay,
            grid=True))
    for n, (up, down, inv_deg) in layouts.items():
        # at 2047 the one-CTA kernels the plan runs there, and their plain
        # versions (the same functions), are timed in the times phase
        t = time_recursions(up, down, inv_deg, rng, decay, grid=True,
                            plain=not fused(n))
        for name in GRID_KERNELS:
            t[name]["long_segments"] = int(
                (up if name == GRID_KERNELS[0] else down).long_ids.shape[0])
        out["times"][str(n)] = t
        phase("recursions", services=n, smi=smi, **t)
    phase("recursions", max_abs_err=out["errs"], forms=out["forms"])
    return out


#: the lane counts the fused front is checked at: the serve widths
FRONT_LANES = (1, 2, 4, 16)


def two_launch_front(ft, aw, hw, weight: float, up, persist: bool = False):
    """The front as two launches, the row pass (``evidence_front``) then
    the contrast (``seg_contrast_step``, none at weight 0): what the fused
    front replaced on the dense path, and its bitwise yardstick."""
    from rca_tpu_torch.engine.evidence import (
        evidence_front_rows,
        seg_contrast_step,
    )

    a, h, e, n_bad = evidence_front_rows(ft, aw, hw, persist)
    if weight:
        a = seg_contrast_step(a, e, weight, up)
    return a, h, n_bad


def lanes_of(ft, lanes: int, rng):
    """``[lanes, n_pad, C]`` copies of the raw features ``ft`` (a flat
    ``[n_pad, C]`` copy for 1), every lane past the first scaled by its
    own factor, so the lanes differ and keep the NaN/Inf rows."""
    import numpy as np
    import torch

    if lanes == 1:
        return ft.clone()
    scale = torch.from_numpy(rng.uniform(0.5, 1.0, (lanes, 1, 1)).astype(
        np.float32)).to(ft.device)
    scale[0] = 1.0
    return ft.expand(lanes, *ft.shape) * scale


def check_fused_front(label, ft, up, aw, hw, contrast: float, rng,
                      lanes_list=FRONT_LANES) -> int:
    """The fused front (one launch) over the raw features ``ft`` on the
    up layout ``up``, at each lane count of ``lanes_list``, at the
    packaged contrast weight and at 0, reading and persisting: ``a``,
    ``h``, ``n_bad`` and the persisted rows bitwise the two-launch front's
    and the plain version's, and bitwise over two runs (reading: the same
    input; persisting: a second copy).  Returns the bad-row count of one
    lane."""
    import torch
    from rca_tpu_torch.engine.evidence import (
        evidence_front,
        evidence_front_plain,
    )

    for lanes in lanes_list:
        x = lanes_of(ft, lanes, rng)
        for weight in (contrast, 0.0):
            for persist in (False, True):
                runs = [x.clone() for _ in range(4)]
                got = evidence_front(runs[0], aw, hw, weight, up, persist)
                again = evidence_front(runs[1], aw, hw, weight, up, persist)
                want = two_launch_front(runs[2], aw, hw, weight, up, persist)
                plain = evidence_front_plain(runs[3], aw, hw, weight, up,
                                             persist)
                torch.cuda.synchronize()
                where = (f"evidence_front_fused ({label}, {lanes} lanes, "
                         f"weight {weight}, persist {persist})")
                for g, a, w, p in zip(got, again, want, plain):
                    if not torch.equal(g, a):
                        fail(f"{where} not deterministic")
                    if not torch.equal(g, w):
                        fail(f"{where} not bitwise the two-launch front")
                    if not torch.equal(g, p):
                        fail(f"{where} not bitwise equal to plain")
                # bit patterns: the inputs hold NaN
                if not all(torch.equal(_bits(runs[0]), _bits(r))
                           for r in runs[1:]):
                    fail(f"{where}: the persisted rows differ")
                if not persist and not torch.equal(_bits(runs[0]),
                                                   _bits(x)):
                    fail(f"{where} wrote its input")
    n_bad = int(evidence_front(ft, aw, hw, contrast, up)[2])
    phase("check", kernel="evidence_front_fused", input=label,
          n_pad=int(up.offsets.shape[0] - 1), lanes=list(lanes_list),
          bad_rows=n_bad, max_abs_err=0.0, bitwise_two_launch=True,
          bitwise_plain=True)
    return n_bad


def degenerate_layouts(rng) -> dict:
    """Small layouts the fused recursions must get right: no edges at all
    (every slot a padding self-loop on the dummy), and self-loops with
    duplicate edges."""
    import numpy as np
    from rca_tpu_torch.engine.segscan import build_seg_layout

    loops = np.arange(50, dtype=np.int32)
    seg = np.concatenate([loops, np.full(20, 3), np.full(40, 9)])
    other = np.concatenate([loops, np.full(20, 5), rng.integers(0, 63, 40)])
    return {
        "no edges": build_seg_layout(64, 128, np.zeros(0, np.int32),
                                     np.zeros(0, np.int32)),
        "self-loops and duplicates": build_seg_layout(
            64, 128, seg.astype(np.int32), other.astype(np.int32)),
    }


_COLD_LOAD = """
import json, os, sys
from rca_tpu_torch.kernels import build
lib = build.library(verbose=sys.argv[1] == "1")
print(json.dumps({"pid": os.getpid(), "library": build._library_path().name,
                  "nvcc_seconds": build.BUILD_SECONDS,
                  "loaded": lib is not None}))
"""


def cold_loads() -> list:
    """Two processes that load the kernel library at once (the first
    prints ``nvcc``'s output, ``-Xptxas -v``): each must exit 0 having
    loaded the same library."""
    procs = [subprocess.Popen([sys.executable, "-c", _COLD_LOAD, verbose],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for verbose in ("1", "0")]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=900)
        if p.returncode != 0:
            fail(f"a concurrent kernel build exited {p.returncode}: "
                 f"{stderr[-3000:]}")
        lines = stdout.strip().splitlines()
        if lines[:-1]:
            print("\n".join(lines[:-1]), flush=True)
        out.append(json.loads(lines[-1]))
    if len({b["library"] for b in out}) != 1 or not all(
            b["loaded"] for b in out):
        fail(f"the concurrent kernel builds disagree: {out}")
    return out


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
    parser.add_argument("--multi-card", action="store_true",
                        help="with two cards or more: build, then run the "
                             "sharded engine over distinct cards alone "
                             "(bitwise logical shards, the walls of "
                             "make_engine() beside the dense engine)")
    parser.add_argument("--peer-rehearsal", metavar="EDGES", default=None,
                        help="the peer recursions' rehearsal on one card "
                             "over the tiers' edges in EDGES (.npz), "
                             "printing its record; the sharded phase runs "
                             "it in a process of its own (it ends in a "
                             "trap that loses the context)")
    parser.add_argument("--side-phase", choices=("capture",), default=None,
                        help="one phase that needs no card, alone, printing "
                             "its record last (the full run runs the "
                             "capture phase so, beside the others)")
    parser.add_argument("--federation-only", action="store_true",
                        help="build, then run the federation phase alone")
    parser.add_argument("--autoscale-only", action="store_true",
                        help="build, then run the autoscale phase alone")
    parser.add_argument("--lint-only", action="store_true",
                        help="build, then run the lint phase alone")
    parser.add_argument("--snapshot-only", action="store_true",
                        help="build, then run the snapshot phase alone "
                             "(the OOM chain and the Stream tab included)")
    parser.add_argument("--recursions-only", action="store_true",
                        help="build, then run the recursions phase alone "
                             "(the grid recursions' checks and times)")
    parser.add_argument("--sharded-only", action="store_true",
                        help="build, then run the sharded phase alone (the "
                             "shard recursions' checks and times, the "
                             "sharded engine in both forms)")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's kernels run "
              "only on the card", file=sys.stderr)
        return 1
    if args.peer_rehearsal:
        print(json.dumps({"peer_rehearsal": peer_rehearsal(
            args.peer_rehearsal)}, default=float), flush=True)
        # the trap lost the context: leave without tearing it down
        os._exit(0)
    if args.side_phase:
        print(json.dumps({"side": _timed({}, args.side_phase, capture_phase,
                                          smi_line())}, default=float),
              flush=True)
        return 0
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
        front_cap,
        front_grid,
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
    from rca_tpu_torch.engine.registry import get_registry
    from rca_tpu_torch.entry import entry
    from rca_tpu_torch.features.schema import SvcF
    from rca_tpu_torch.kernels import LAUNCHES, build, cost, reset_launches

    t_run = time.perf_counter()
    if args.out:
        global PHASE_LOG, RUN_T0
        RUN_T0 = t_run
        os.makedirs(args.out, exist_ok=True)
        PHASE_LOG = os.path.join(args.out, "phases.jsonl")
        open(PHASE_LOG, "w").close()
    record = {"argv": list(argv)}
    # every phase's wall, the kernel checks and the times included
    phase_s = record["phase_seconds"] = {}
    dev = torch.device("cuda")
    smi = smi_line()
    record["nvidia_smi"] = smi
    print(smi, flush=True)

    # -- 2. build ---------------------------------------------------------
    # two processes start at once on a cold build directory, as two
    # federation workers would: each builds in a private directory and
    # renames, and both must load the library
    t0 = time.perf_counter()
    loads = cold_loads()
    build.library()
    record["build_s"] = phase_s["build"] = time.perf_counter() - t0
    phase("build", seconds=record["build_s"], cold_loads=loads,
          nvcc_seconds=max(b["nvcc_seconds"] for b in loads))

    # -- inputs: both tiers, generated once --------------------------------
    t_generate = time.perf_counter()
    cases, shapes, padded = {}, {}, {}
    for n, roots, seed in TIERS:
        t0 = time.perf_counter()
        cases[n] = _generated("arrays", n, roots, seed)
        eng = GraphEngine(device="cpu")
        f, s, d = eng._pad(cases[n].features, cases[n].dep_src,
                           cases[n].dep_dst)
        shapes[n] = (f.shape[0], len(s))
        padded[n] = (s, d)
        phase("generate", services=n, edges=len(cases[n].dep_src),
              n_pad=f.shape[0], e_pad=len(s),
              seconds=time.perf_counter() - t0)

    phase_s["generate"] = time.perf_counter() - t_generate

    if (args.multi_card or args.federation_only or args.autoscale_only
            or args.lint_only or args.snapshot_only or args.recursions_only
            or args.sharded_only):
        if args.multi_card:
            record["multi_card"] = multi_card_phase(
                cases, synthetic_cascade_arrays(10000, n_roots=3, seed=0))
        else:
            # the full run's registry phase points the election here
            cache = build.BUILD_DIR / "chip_smoke_kernel_cache.json"
            cache.unlink(missing_ok=True)
            os.environ["RCA_KERNEL_CACHE"] = str(cache)
            if args.federation_only:
                record["federation"] = _timed(phase_s, "federation",
                                              federation_phase, cases, smi)
            elif args.lint_only:
                record["lint"] = _timed(phase_s, "lint", lint_phase, cases,
                                        smi)
            elif args.snapshot_only:
                record["snapshot"] = _timed(phase_s, "snapshot",
                                            snapshot_phase, smi, args.profile,
                                            args.out)
            elif args.sharded_only:
                record["sharded"] = _timed(phase_s, "sharded", sharded_phase,
                                           cases, shapes, args.profile,
                                           args.out)
            elif args.recursions_only:
                record["recursions"] = _timed(
                    phase_s, "recursions", recursions_phase, smi,
                    GraphEngine(device="cpu").params.decay)
            else:
                record["autoscale"] = _timed(phase_s, "autoscale",
                                             autoscale_phase, cases, smi)
            _phase_walls(phase_s, t_run, record)
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count()}
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
                json.dump(record, f, indent=1, default=float)
        print(json.dumps({"ok": True, "device": device}))
        return 0

    # -- 3. each kernel against its plain version, on the card -------------
    t_check = time.perf_counter()
    rng = np.random.default_rng(20260)
    params = GraphEngine(device="cpu").params
    aw = torch.tensor(params.anomaly_weights, dtype=torch.float32, device=dev)
    hw = torch.tensor(params.hard_weights, dtype=torch.float32, device=dev)
    kin = {}   # per tier: kernel inputs on the card, for timing
    errs = {"noisy_or_pair": 0.0, "segscan_sum": 0.0, "segscan_max": 0.0,
            "seg_up_step": 0.0, "seg_down_step": 0.0, "evidence_front": 0.0,
            "seg_contrast_step": 0.0, "seg_up_steps": 0.0,
            "seg_down_steps": 0.0, "evidence_front_fused": 0.0,
            **dict.fromkeys(GRID_KERNELS, 0.0)}
    decay = params.decay
    contrast = params.error_contrast

    def check_front(label, ft, up_d, lanes_list=FRONT_LANES):
        """The front's kernels against their plain versions on raw
        features ``ft`` over the up layout ``up_d``: the row pass, the
        contrast and the pair of them, at the packaged contrast weight and
        at 0, bitwise and bitwise over two runs; then the fused front
        bitwise the pair and the plain version over ``lanes_list``
        (:func:`check_fused_front`).  Returns the bad-row count."""
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
            same(two_launch_front(ft, aw, hw, weight, up_d),
                 two_launch_front(ft, aw, hw, weight, up_d),
                 evidence_front_plain(ft, aw, hw, weight, up_d),
                 f"evidence_front + seg_contrast_step at weight {weight}")
        torch.cuda.synchronize()
        phase("check", kernel="evidence_front + seg_contrast_step",
              input=label, n_pad=int(ft.shape[0]), bad_rows=int(n_bad),
              max_abs_err=0.0, bitwise=True)
        if check_fused_front(label, ft, up_d, aw, hw, contrast, rng,
                             lanes_list) != int(n_bad):
            fail(f"the fused front counted other bad rows ({label})")
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
        # the fused recursions over the same layouts, where the plan runs
        # them, against the per-step launches they replace
        if fused(n):
            for name, err in check_recursions(f"{n} services", up_d, down_d,
                                              inv_deg, rng, decay).items():
                errs[name] = max(errs[name], err)
            kin[n]["recursion"] = (up_d, down_d, inv_deg)

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
            if check_front("every row NaN", nan_all, up_d, (1, 2)) != n_pad:
                fail("the front did not count every row of an all-NaN input")
            a_all, h_all, _ = evidence_front(nan_all, aw, hw, contrast, up_d)
            if a_all.any() or h_all.any():
                fail("an all-NaN input left evidence")

    # a star: every edge in one segment (id 7, past empty ones), so the
    # block path reduces a run 16 times its width
    star = build_seg_layout(2048, 4096, np.full(4096, 7, np.int32),
                            rng.integers(0, 2047, 4096).astype(np.int32))
    star_d = star.to(dev)
    star_inv = torch.full((2048,), 1.0 / 4096, dtype=torch.float32,
                          device=dev)
    check_steps("star, 4096 edges in one segment", star_d, star_inv,
                ["seg_up_step", "seg_down_step"])
    check_recursions("star, 4096 edges in one segment", star_d, star_d,
                     star_inv, rng, decay)
    # the fused front where one up segment outgrows a CTA's stride, and
    # over ragged tiles (64 rows)
    star_f = torch.from_numpy(rng.uniform(-0.2, 1.2, (2048, C)).astype(
        np.float32)).to(dev)
    star_f[[5, 7], [3, SvcF.ERROR_RATE]] = float("nan")
    check_front("star, 4096 edges in one segment", star_f, star_d, (1, 3))
    for label, layout in degenerate_layouts(rng).items():
        seg_d = layout.to(dev)
        check_recursions(label, seg_d, seg_d, torch.full(
            (64,), 0.25, dtype=torch.float32, device=dev), rng, decay)
        small = torch.from_numpy(rng.uniform(-0.2, 1.2, (64, C)).astype(
            np.float32)).to(dev)
        small[3, 4] = float("inf")
        small[9, SvcF.ERROR_RATE] = float("nan")
        check_front(label, small, seg_d, (1, 3))

    phase_s["check"] = time.perf_counter() - t_check
    # the grid recursions at every tier, checked and timed
    record["recursions"] = _timed(phase_s, "recursions", recursions_phase,
                                  smi, decay)
    for name, err in record["recursions"]["errs"].items():
        errs[name] = err

    # -- 4. the registry elects the kernels row by timing ------------------
    engine = GraphEngine()
    record["registry"] = _timed(phase_s, "registry", registry_phase, engine,
                                cases, shapes)

    # -- 5. the main path, through the kernels -----------------------------
    t_main = time.perf_counter()
    for n in cases:
        row = get_registry().resolve(*shapes[n], device=dev)
        if row.winner != "kernels":
            fail(f"the registry engages {row.winner!r} ({row.source}) at "
                 f"{n} services")
    for n in cases:
        plan = engine.plan_for(*shapes[n], cases[n].dep_src,
                               cases[n].dep_dst)
        want_form = "cta" if fused(n) else "grid"
        if plan.steps_form != want_form:
            fail(f"the plan at {n} services says steps_form="
                 f"{plan.steps_form!r}, want {want_form!r}")
    reset_launches()
    results = {}
    for i, n in enumerate(cases, start=1):
        results[n] = engine.analyze_case(cases[n])
        want = {k: sum(main_launches(m)[k] for m in list(cases)[:i])
                for k in LAUNCHES}
        if LAUNCHES != want:
            fail(f"launch counts {LAUNCHES} after {i} analyses, want {want}")
    path_launches = dict(LAUNCHES)
    phase("main_path", launches=path_launches,
          per_analysis={str(n): main_launches(n) for n in cases})
    phase_s["main_path"] = time.perf_counter() - t_main

    # -- 6. the hypothesis batch, one launch per kernel and step ----------
    record["batch"] = _timed(phase_s, "batch", batch_phase, engine, cases,
                             shapes, aw, hw, params)

    t_compare = time.perf_counter()
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
    phase_s["compare"] = time.perf_counter() - t_compare

    # -- 7. the capture layer: native scanners, columnar against dict -----
    # (host work alone, in a process of its own beside phases 8-21, joined
    # before the phases that count the card's contexts; on one card the
    # peer recursions' rehearsal runs beside them too, in a process of its
    # own on the card, and phase 13 joins it)
    capture = _side_start("--side-phase", "capture")
    rehearsal = (_peer_rehearsal_start(cases)
                 if torch.cuda.device_count() < 2 else None)
    # (phase 9's commands, subprocesses that need nothing of the phases
    # between, start here too and are held to their gates there)
    commands = commands_start()

    # -- 8. the snapshot path, through the kernels -------------------------
    record["snapshot"] = _timed(phase_s, "snapshot", snapshot_phase, smi,
                                args.profile, args.out)

    # -- 9. attribution (sweep on the kernels) and the hypotheses command -
    record["attribution"] = _timed(
        phase_s, "attribution", attribution_phase, engine,
        cases[TIERS[-1][0]], args.profile, args.out)
    record["commands"] = _timed(phase_s, "commands", commands_finish,
                                commands, smi)

    # -- 10-12. resident sessions, streaming ticks, the live session ------
    record["resident"] = _timed(phase_s, "resident", resident_phase, cases,
                                shapes)
    record["stream"] = _timed(phase_s, "stream", stream_phase, engine, cases,
                              args.profile, args.out)
    record["live"] = _timed(phase_s, "live", live_phase)

    # -- 13. the node-sharded engine ---------------------------------------
    record["sharded"] = _timed(phase_s, "sharded", sharded_phase, cases,
                               shapes, args.profile, args.out, rehearsal)

    # -- 14. the serving scheduler -----------------------------------------
    record["serve"] = _timed(phase_s, "serve", serve_phase, engine, cases,
                             shapes, aw, hw, params, smi)

    # -- 15. flight recording, replay and the chaos soak ------------------
    record["replay"] = _timed(phase_s, "replay", replay_phase, cases, smi)

    # -- 16-17. the quantized and doubling rows; training ------------------
    record["variants"] = _timed(phase_s, "variants", variants_phase, cases,
                                shapes, smi)
    record["train"] = _timed(phase_s, "train", train_phase, smi)

    # -- 18. the investigation layer ---------------------------------------
    record["investigate"] = _timed(phase_s, "investigate", investigate_phase,
                                   smi)

    # -- 19. the gateway -----------------------------------------------------
    record["gateway"] = _timed(phase_s, "gateway", gateway_phase, engine,
                               cases, shapes, smi)

    # -- 20. times ---------------------------------------------------------
    t_times = time.perf_counter()
    # the analysis phase_s restage every call, as they did before resident
    # sessions (the resident phase times its requests)
    restaged = GraphEngine(resident=False)
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
            "bound": bound(cost.noisy_or_pair(n_pad)),
        }}
        for op, fn_k in (("sum", segscan_sum), ("max", segscan_max)):
            x, flags, lengths = kin[n]["seg"][op]
            t[f"segscan_{op}"] = {
                "ms": cuda_ms(lambda: fn_k(x, flags)),
                "call_ms": cuda_ms(lambda: fn_k(x, flags), queued=False),
                "plain_ms": cuda_ms(lambda: segscan_plain(x, flags, op)),
                "library_ms": cuda_ms(
                    lambda: torch.segment_reduce(x, op, lengths=lengths)),
                "bound": bound(cost.segscan(e_pad)),
            }
        st = kin[n]["step"]
        up, down = st["seg_up_step"], st["seg_down_step"]
        out = torch.empty(n_pad, dtype=torch.float32, device=dev)
        steps = {
            "seg_up_step": (
                lambda: up_seg_step(up["u"], up["h"], decay, up["seg"],
                                    out=out),
                lambda: up_seg_step_plain(up["u"], up["h"], decay,
                                          up["seg"]),
                lambda: up_seg_step_plain(up["u"], up["h"], decay,
                                          up["seg"], scan=segscan_max),
                cost.up_step(n_pad, e_pad)),
            "seg_down_step": (
                lambda: down_seg_step(down["m"], down["a_ex"], decay,
                                      down["seg"], down["inv_deg"], out=out),
                lambda: down_seg_step_plain(down["m"], down["a_ex"], decay,
                                            down["seg"], down["inv_deg"]),
                lambda: down_seg_step_plain(down["m"], down["a_ex"], decay,
                                            down["seg"], down["inv_deg"],
                                            scan=segscan_sum),
                cost.down_step(n_pad, e_pad)),
        }
        for name, (kernel, plain, scan_step, work) in steps.items():
            t[name] = {
                "ms": cuda_ms(kernel),
                "call_ms": cuda_ms(kernel, queued=False),
                "plain_ms": cuda_ms(plain),
                "scan_step_ms": cuda_ms(scan_step),
                "scan_step_call_ms": cuda_ms(scan_step, queued=False),
                "library_ms": None,
                "bound": bound(work),
            }
        # the fused recursions beside the 8 per-step launches they replace
        if fused(n):
            t.update(time_recursions(*kin[n]["recursion"], rng, decay))

        # the front: features read once, the weights, the up layout's CSR,
        # the [n_pad] vectors between and out of the two launches
        fr = kin[n]["front"]
        pt, up_d = fr["features"], fr["up"]
        a_raw, _, e, _ = evidence_front_rows(pt, aw, hw)
        t["evidence_front"] = {
            "ms": cuda_ms(lambda: evidence_front_rows(pt, aw, hw)),
            "call_ms": cuda_ms(lambda: evidence_front_rows(pt, aw, hw),
                               queued=False),
            "plain_ms": cuda_ms(lambda: evidence_front_rows_plain(pt, aw,
                                                                  hw)),
            "library_ms": None,
            "bound": bound(cost.front_rows(n_pad)),
        }
        # the flush's persisting launch, over a buffer whose bad rows the
        # warm-up calls already zeroed: each timed call writes no row, so
        # its bytes are the reading launch's
        buf = pt.clone()
        plain_buf = pt.clone()
        t["evidence_front_persist"] = {
            "ms": cuda_ms(lambda: evidence_front_rows(buf, aw, hw,
                                                      persist=True)),
            "call_ms": cuda_ms(lambda: evidence_front_rows(
                buf, aw, hw, persist=True), queued=False),
            "plain_ms": cuda_ms(lambda: evidence_front_rows_plain(
                plain_buf, aw, hw, persist=True)),
            "library_ms": None,
            "bound": bound(cost.front_rows(n_pad)),
        }
        t["seg_contrast_step"] = {
            "ms": cuda_ms(lambda: seg_contrast_step(a_raw, e, contrast,
                                                    up_d)),
            "call_ms": cuda_ms(lambda: seg_contrast_step(a_raw, e, contrast,
                                                         up_d), queued=False),
            "plain_ms": cuda_ms(lambda: seg_contrast_step_plain(
                a_raw, e, contrast, up_d)),
            "library_ms": None,
            "bound": bound(cost.contrast(n_pad, e_pad)),
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
            return two_launch_front(pt, aw, hw, contrast, up_d)

        def fused_front():
            return evidence_front(pt, aw, hw, contrast, up_d)

        front_bound = bound(cost.front(n_pad, e_pad))
        t["front"] = {
            "ms": cuda_ms(front),
            "call_ms": cuda_ms(front, queued=False),
            "plain_front_ms": cuda_ms(replaced_front),
            "plain_front_call_ms": cuda_ms(replaced_front, queued=False),
            "plain_ms": cuda_ms(lambda: evidence_front_plain(
                pt, aw, hw, contrast, up_d)),
            "bound": front_bound,
        }
        # the fused front, in turns with the two-launch front above
        fused_buf = pt.clone()
        cap = front_cap(torch.cuda.current_device(), C, "fused")
        t["evidence_front_fused"] = {
            "ms": cuda_ms(fused_front),
            "call_ms": cuda_ms(fused_front, queued=False),
            "plain_ms": t["front"]["plain_ms"],
            "library_ms": None,
            "bound": front_bound,
            "two_launch_ms": cuda_ms(front),
            "two_launch_call_ms": cuda_ms(front, queued=False),
            "ms_again": cuda_ms(fused_front),
            # the flush's persisting launch over a buffer its warm-up
            # calls already sanitized (no row written when timed)
            "persist_ms": cuda_ms(lambda: evidence_front(
                fused_buf, aw, hw, contrast, up_d, persist=True)),
            "persist_call_ms": cuda_ms(lambda: evidence_front(
                fused_buf, aw, hw, contrast, up_d, persist=True),
                queued=False),
            # the cooperative grid these launches took, and its bound
            "grid": front_grid(n_pad, 1, up_d.long_ids.shape[0],
                               up_d.short_ids.shape[0], True, cap),
            "co_resident_ctas": cap,
        }
        case = cases[n]

        def analyze():
            restaged.analyze_arrays(case.features, case.dep_src,
                                    case.dep_dst, case.names)

        t["analyze_arrays_ms"] = host_ms(analyze)
        # the same analysis with its recursions in one launch each (as
        # planned: one CTA a lane at 2047, the grid above) and per step,
        # in turns
        walls = {True: [], False: []}
        for on in (True, False, False, True):
            with contextlib.nullcontext() if on else per_step_plans():
                walls[on] += host_samples(analyze, reps=10)
        t["analyze_arrays_fused_ms"] = float(np.median(walls[True]))
        t["analyze_arrays_per_step_ms"] = float(np.median(walls[False]))
        t["analyze_timed_latency_ms"] = engine.analyze_case(
            case, timed=True).latency_ms
        times[n] = t
        phase("times", services=n, **t)

    phase_s["times"] = time.perf_counter() - t_times

    # -- 21. the instruments: profile, cost, /metrics, tracecheck --------
    record["observe"] = _timed(phase_s, "observe", observe_phase, engine,
                               cases, shapes, times, kin, smi)

    # -- 7, joined: the capture phase's record; the wait for it here -----
    t0 = time.perf_counter()
    record["capture"] = _side_join(capture, "side")
    phase_s["capture"] = time.perf_counter() - t0

    # -- 22. the cross-process plane: worker processes on the card -------
    # (its ``chaos --ticks 200 --no-autoscale`` is left to phase 23's
    # ``chaos --ticks 200``: the same legs and the storm)
    record["federation"] = _timed(phase_s, "federation", federation_phase,
                                  cases, smi, chaos=False)

    # -- 23. the elastic fleet: the autoscaler's controller on the card ---
    # (its closing ``chaos --ticks 200``, which counts no context, runs
    # beside phase 24 and is held to its gates after it)
    record["autoscale"] = _timed(phase_s, "autoscale", autoscale_phase, cases,
                                 smi, chaos_beside=True)

    # -- 24. the analysis plane: lint --all, specsan, rsan ----------------
    record["lint"] = _timed(phase_s, "lint", lint_phase, cases, smi)
    t0 = time.perf_counter()
    record["autoscale"]["commands"]["chaos"] = _chaos_finish(
        record["autoscale"].pop("chaos"), smi, "autoscale")
    phase_s["autoscale_chaos"] = time.perf_counter() - t0

    if args.sweep:
        record["sweep"] = sweep(cases, shapes, kin, decay)

    if args.profile:
        record["profile"] = {
            str(n): profile(restaged, cases[n], times[n]["analyze_arrays_ms"],
                            args.out,
                            times[n]["analyze_arrays_per_step_ms"])
            for n in cases}

    big = TIERS[-1][0]
    sources = {
        "evidence_front": ("rca_tpu_torch/csrc/evidence.cu",
                           "rca_tpu/engine/pallas_kernels.py:52 (with the "
                           "sanitize, rca_tpu/engine/propagate.py:132)"),
        "seg_contrast_step": ("rca_tpu_torch/csrc/segstep.cu",
                              "rca_tpu/engine/pallas_kernels.py:52 (the "
                              "front's contrast, rca_tpu/engine/"
                              "propagate.py:174, :186)"),
        "evidence_front_fused": ("rca_tpu_torch/csrc/front.cu",
                                 "rca_tpu/engine/pallas_kernels.py:63 "
                                 "(noisy_or_pair_pallas :52, with "
                                 "rca_tpu/engine/propagate.py:132, :174, "
                                 ":186)"),
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
        "seg_up_steps": ("rca_tpu_torch/csrc/segsteps.cu",
                         "rca_tpu/engine/segscan.py:141 (step up_seg_step "
                         ":206, 8 steps under lax.scan, rca_tpu/engine/"
                         "propagate.py:319)"),
        "seg_down_steps": ("rca_tpu_torch/csrc/segsteps.cu",
                           "rca_tpu/engine/segscan.py:136 (step "
                           "down_seg_step :197, 8 steps under lax.scan, "
                           "rca_tpu/engine/propagate.py:349)"),
        "seg_up_steps_grid": ("rca_tpu_torch/csrc/seggrid.cu",
                              "rca_tpu/engine/segscan.py:141 (step "
                              "up_seg_step :206, 8 steps under lax.scan, "
                              "rca_tpu/engine/propagate.py:319)"),
        "seg_down_steps_grid": ("rca_tpu_torch/csrc/seggrid.cu",
                                "rca_tpu/engine/segscan.py:136 (step "
                                "down_seg_step :197, 8 steps under "
                                "lax.scan, rca_tpu/engine/propagate.py:"
                                "349)"),
    }
    stream_counts = record["stream"][str(big)]["tick_launches"]
    resident_counts = next(
        r for r in record["resident"][str(big)]["requests"]
        if r["request"] == "delta_8_nan_inf")
    kernels = []
    grid_times = record["recursions"]["times"]
    for name, (src, replaces) in sources.items():
        # the one-CTA recursions run on the plan at 2047 services, the
        # grid recursions at 49,999 (timed in the recursions phase, beside
        # the 8 per-step launches)
        tier = 2047 if name in FUSED_KERNELS else big
        t = (grid_times[str(big)] if name in GRID_KERNELS
             else times[tier])[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": path_launches[name],
            "max_abs_err": errs[name], "ms": t["ms"], "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "tier_services": tier,
            "at_2047": (grid_times["2047"] if name in GRID_KERNELS
                        else times[2047])[name],
            "at_49999": (grid_times[str(big)] if name in GRID_KERNELS
                         else times[big]).get(name),
            "at_10000": grid_times["10000"].get(name),
            "snapshot_launches": record["snapshot"]["launches"][name],
            # counted in the stream and resident phases of this run
            "tick_launches": {
                "delta_tick": stream_counts["delta"][name],
                "quiet_tick": stream_counts["quiet"][name],
                "resident_delta_request": resident_counts["launches"][name]},
            **{key: t[key] for key in ("scan_step_ms", "scan_step_call_ms",
                                       "per_step_ms", "per_step_call_ms")
               if key in t},
        })
        serve = record["serve"]
        # launches per device batch of the serve path, by padded width,
        # and over each tier's coalesced load
        kernels[-1]["serve_launches"] = {
            "per_batch_by_lanes": {str(lanes): counts[name] for lanes, counts
                                   in sorted(serve["by_width"].items())},
            "load": {tier: runs["coalesced"]["launches"].get(name, 0)
                     for tier, runs in serve["load"].items()},
            "load_batches": {tier: runs["coalesced"]["device_batches"]
                             for tier, runs in serve["load"].items()},
            # over each tier's two pool runs (a sharded batch counts its
            # per-shard launches here too)
            "pool": {tier: {label: row["launches"][name]
                            for label, row in runs.items()}
                     for tier, runs in serve["pool"].items()}}
        # launches per analysis under each edge layout at each tier, and
        # of the investigation's run_agent suggestion at 2047
        kernels[-1]["layout_launches"] = {
            f"{layout}_{tier}": record["variants"]["layouts"][tier][
                "launches"][layout][name]
            for tier in map(str, cases) for layout in LAYOUTS}
        kernels[-1]["investigate_launches"] = record["investigate"]["2047"][
            "run_agent_launches"][name]
        # over the OOM chain's two analyses, and over the app's Stream tab
        # polls per world (snapshot phase)
        snap = record["snapshot"]
        kernels[-1]["oomchain_launches"] = snap["oomchain"]["launches"][name]
        kernels[-1]["ui_launches"] = {
            label: sum(counts[name] for counts in row["launches_per_poll"])
            for label, row in snap["ui"].items()}
        # device events in the profile of 20 live ticks at 10,000 services
        kernels[-1]["profile_events"] = record["observe"]["profile"][
            "device_kernels"][name]
        # launches in the federation's worker processes, summed over the
        # workers of each load leg (fresh processes: counted from 0, read
        # from each worker's drain report), and their device batches
        fed = record["federation"]
        kernels[-1]["federation_launches"] = {
            "load": {tier: fed[tier]["launches"][name]
                     for tier in ("2047", "49999")},
            "load_batches": {tier: fed[tier]["device_batches"]
                             for tier in ("2047", "49999")},
            "kill_wave": sum(w.get(name, 0) for w in fed["kill_wave"][
                "worker_launches"].values())}
        # launches under the lock sanitizer: over the rsan cross-check's
        # 40 soak ticks at 20 services, and over the sanitized pool's
        # device batches at 2047, with their counts
        rsan_legs = record["lint"]["rsan"]
        kernels[-1]["rsan_launches"] = {
            "soak": rsan_legs["soak"]["launches"][name],
            "soak_ticks": rsan_legs["soak"]["soak_ticks"],
            "pool": rsan_legs["pool"]["launches"][name],
            "pool_batches": rsan_legs["pool"]["device_batches"]}
        # launches of the elastic fleet at 2047, with their device
        # batches: the thread soak's (one engine in this process) and the
        # process fleet's, summed over its four drain reports
        scale = record["autoscale"]
        kernels[-1]["autoscale_launches"] = {
            leg: scale[leg]["launches"].get(name, 0)
            for leg in ("thread", "process")}
        kernels[-1]["autoscale_launches"].update({
            f"{leg}_batches": scale[leg]["device_batches"]
            for leg in ("thread", "process")})
        # per device batch behind the gateway at each tier, and over the
        # 2047-service mix (wire and in process) and the 49,999 requests
        gateway = record["gateway"]
        kernels[-1]["gateway_launches"] = {
            "per_batch": {tier: counts[name] for tier, counts
                          in gateway["per_batch"].items()},
            "load": {tier: gateway[tier]["launches"][name]
                     for tier in ("2047", "49999")},
            "load_batches": {tier: gateway[tier]["device_batches"]
                             for tier in ("2047", "49999")}}
        if name == "segscan_sum":
            # the ell layout's overflow sum at each tier's overflow shape
            kernels[-1]["ell_overflow_scan"] = {
                tier: record["variants"]["layouts"][tier]["ell_overflow_scan"]
                for tier in map(str, cases)}
        if name in TICK_KERNELS:
            # launches over the 20 replayed ticks of the 10,000-service
            # tape, each tick equal to the recorded session's
            kernels[-1]["replay_launches"] = {
                "ticks": 20, "total": record["replay"]["live_10k"][
                    "launches_per_tick"]["total"][name]}
            # launches per analysis on the doubling and quantized rows
            kernels[-1]["variant_launches"] = {
                f"{row}_{tier}": record["variants"][tier]["launches"][row][
                    name] for tier in map(str, cases)
                for row in ("doubling", "quantized")}
        if name in TICK_KERNELS:
            batch = record["batch"]
            kernels[-1].update(
                batch_lanes=BATCH, batch_launches={
                    tier: counts[name]
                    for tier, counts in batch["launches"].items()},
                batch=batch["times"][str(big)].get(name),
                batch_at_2047=batch["times"]["2047"].get(name),
                serve_batch={lanes: t.get(name) for lanes, t
                             in serve["batched"][str(big)].items()},
                serve_batch_at_2047={lanes: t.get(name) for lanes, t
                                     in serve["batched"]["2047"].items()})
        if name == "evidence_front_fused":
            kernels[-1]["persist_launches"] = {
                "delta_tick": stream_counts["delta"][f"{name}_persist"],
                "quiet_tick": stream_counts["quiet"][f"{name}_persist"],
                "resident_delta_request": resident_counts["persist_launches"]}
            kernels[-1].update({key: t[key] for key in (
                "two_launch_ms", "two_launch_call_ms", "ms_again",
                "persist_ms", "persist_call_ms")})
        if name == "evidence_front":
            front = times[big]["front"]
            persist = times[big]["evidence_front_persist"]
            kernels[-1]["persist_launches"] = {
                "delta_tick": stream_counts["delta"]["evidence_front_persist"],
                "quiet_tick": stream_counts["quiet"]["evidence_front_persist"],
                "resident_delta_request": resident_counts["persist_launches"]}
            kernels[-1].update(
                persist_ms=persist["ms"], persist_call_ms=persist["call_ms"],
                persist_plain_ms=persist["plain_ms"],
                persist_bound_ms=persist["bound"][0],
                persist_at_2047=times[2047]["evidence_front_persist"])
            kernels[-1].update(
                front_ms=front["ms"], front_call_ms=front["call_ms"],
                front_bound_ms=front["bound"][0],
                plain_front_ms=front["plain_front_ms"],
                plain_front_call_ms=front["plain_front_call_ms"])

    # the node-sharded engine's kernels, their launches counted over one
    # sharded analysis at 49,999 services on 4 logical shards (the plan's
    # shard_grid form: the recursions over every shard of the card; the
    # per-step entries run in the step form, the peer recursions one a
    # card over distinct cards)
    sharded = record["sharded"]
    for name, (src, replaces) in SHARD_SOURCES.items():
        if name in PEER_KERNELS:
            # over distinct cards, or two ranks of one card: the launches
            # of the 4-shard analysis (none on one card), the checks' and
            # times' launches apart
            peer = sharded["peer"]
            t = peer["times"][str(big)][name]
            kernels.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces,
                "launches": sharded["launches"][f"{big}x{SHARD_SP}"][name],
                "max_abs_err": peer["errs"][name], "ms": t["ms"],
                "ms_cuda0": t["ms_cuda0"],
                "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": None, "tier_services": big,
                "ranks": t["ranks"], "composition_ms": t["composition_ms"],
                "composition_call_ms": t["composition_call_ms"],
                "at_2047": peer["times"]["2047"][name],
                "check_launches": peer.get("launches", {}).get(name),
                "sharded_launches": sharded["launches"]})
            continue
        t = sharded["times"][str(big)][name]
        kernels.append({
            "name": name if name in SHARD_KERNELS else f"{name} (per shard)",
            "route": "cuda", "source": src, "replaces": replaces,
            "launches": sharded["launches"][f"{big}x{SHARD_SP}"][name],
            "max_abs_err": sharded["errs"][name], "ms": t["ms"],
            "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": None, "tier_services": big, "sp": SHARD_SP,
            "at_2047": sharded["times"]["2047"][name],
            # the recursions: beside the per-step composition they replace
            # (timed in the same call), at sp 8 too
            **{key: t[key] for key in ("composition_ms",
                                       "composition_call_ms", "at_sp8",
                                       "dense_fused_ms",
                                       "dense_fused_call_ms")
               if key in t},
            "sharded_launches": sharded["launches"],
            # per device batch of the dense + sharded pool's sharded
            # replica (sp = 4), and over its batches at each tier
            "serve_launches": {
                "per_sharded_batch": record["serve"]["per_sharded_batch"][
                    name],
                "sharded_pool": {
                    tier: runs["dense_sharded"]["shard_launches"][name]
                    for tier, runs in record["serve"]["pool"].items()},
                "sharded_batches": {
                    tier: runs["dense_sharded"]["sharded_batches"]
                    for tier, runs in record["serve"]["pool"].items()}}})
    for entry in kernels[: len(sources)]:
        entry["sharded_launches"] = {
            key: counts[entry["name"]]
            for key, counts in sharded["all_launches"].items()}
        if entry["name"] == "evidence_front":
            # the row pass over the fullest of 4 logical shards, the step
            # form's launch
            entry["per_shard"] = {tier: sharded["times"][tier]["evidence_front"]
                                  for tier in ("2047", str(big))}

    for mod in list(sys.modules):
        if mod == "jax" or mod.startswith("jax.") or mod == "rca_tpu" \
                or mod.startswith("rca_tpu."):
            fail(f"{mod} was imported")
    _phase_walls(phase_s, t_run, record)

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


BATCH = 8


def registry_phase(engine, cases, shapes) -> dict:
    """The registry on the card at both tiers: with a fresh cache file the
    ``kernels`` row is elected by timing, ``torch`` timed beside it; after
    the rows are dropped, an analysis reads the cache; under
    ``RCA_KERNEL=torch`` an analysis launches no kernel of the port and
    ranks the same top-k as the kernels row."""
    import numpy as np
    from rca_tpu_torch.engine import registry
    from rca_tpu_torch.kernels import LAUNCHES, build, reset_launches

    cache = build.BUILD_DIR / "chip_smoke_kernel_cache.json"
    cache.unlink(missing_ok=True)
    os.environ["RCA_KERNEL_CACHE"] = str(cache)
    os.environ.pop("RCA_KERNEL", None)
    registry.reset_registry()
    out = {}
    for n, case in cases.items():
        n_pad, e_pad = shapes[n]
        t0 = time.perf_counter()
        row = registry.get_registry().resolve(n_pad, e_pad,
                                              device=engine.device)
        race_s = time.perf_counter() - t0
        if (row.source, row.winner) != ("timed", "kernels") or \
                sorted(row.timings_ms) != ["kernels", "torch"]:
            fail(f"registry at {n}: {row.to_dict()}")
        registry.reset_registry()
        kernels = engine.analyze_case(case)
        cached = registry.get_registry().resolve(n_pad, e_pad,
                                                 device=engine.device)
        if (cached.source, cached.winner) != ("cache", "kernels") or \
                cached.timings_ms != row.timings_ms:
            fail(f"a second engine did not read the cache at {n}: "
                 f"{cached.to_dict()}")
        os.environ["RCA_KERNEL"] = "torch"
        reset_launches()
        plain = engine.analyze_case(case)
        launched = sum(LAUNCHES.values())
        del os.environ["RCA_KERNEL"]
        if launched:
            fail(f"RCA_KERNEL=torch launched {dict(LAUNCHES)} at {n}")
        if plain.top_components() != kernels.top_components():
            fail(f"the torch row ranks {plain.top_components()} and the "
                 f"kernels row {kernels.top_components()} at {n}")
        if not np.array_equal(plain.upstream, kernels.upstream):
            fail(f"u differs between the rows at {n}")
        out[str(n)] = {"n_pad": n_pad, "e_pad": e_pad, "winner": row.winner,
                       "timings_ms": row.timings_ms, "race_s": race_s,
                       "cache_source": cached.source,
                       "torch_row_launches": launched,
                       "top": kernels.top_components()}
        phase("registry", services=n, **out[str(n)])
    return out


def _hypothesis_batch(engine, case):
    """``BATCH`` what-if feature sets over the case's graph, as the
    ``hypotheses`` command builds them (each of the top candidates made
    healthy in its lane), with a NaN row in lane 1 and +-Inf in lane 5."""
    import numpy as np

    base = engine.analyze_case(case, k=BATCH)
    names = list(case.names) if case.names else None
    batch = np.repeat(case.features[None], BATCH, axis=0)
    for b, comp in enumerate(base.top_components(BATCH)):
        batch[b, names.index(comp) if names else int(comp.split("-")[1])] = 0
    batch[1, 11, 2] = np.nan
    batch[5, [40, 41], [0, 6]] = (np.inf, -np.inf)
    return batch


def _batched_kernels(ft, case, n_pad, e_pad, aw, hw, params, rng,
                     plain_recursions: bool = True):
    """Each main-path kernel's launch over the ``[B, n_pad, C]`` lanes
    ``ft`` of ``case``'s graph against its batched plain version (the
    front, the contrast and ``u`` bitwise, the down-step within rtol 1e-5
    / atol 1e-6; each bitwise over two runs), then timed beside its bound
    and plain version; the recursions in the form the plan runs at this
    size (one CTA a lane, or the grid) also bitwise their 8 per-step
    launches and timed beside them.  ``plain_recursions`` False leaves
    the recursions' plain versions untimed (``plain_ms`` None; still
    checked): the serve widths', whose loop of some thousand torch ops
    the batch, times and recursions phases time already.  Returns
    ``(checks, times)``."""
    import numpy as np
    import torch
    from rca_tpu_torch.engine.evidence import (
        evidence_front,
        evidence_front_plain,
        evidence_front_rows,
        evidence_front_rows_plain,
        seg_contrast_step,
        seg_contrast_step_plain,
    )
    from rca_tpu_torch.engine.segscan import (
        build_seg_layouts,
        down_seg_step,
        down_seg_step_plain,
        up_seg_step,
        up_seg_step_plain,
    )
    from rca_tpu_torch.kernels import cost

    dev, lanes, n = ft.device, ft.shape[0], case.n
    down, up = build_seg_layouts(n_pad, e_pad, case.dep_src,
                                 case.dep_dst, device=dev)
    d_pad = np.full(e_pad, n_pad - 1, np.int64)
    d_pad[: len(case.dep_dst)] = case.dep_dst
    inv_deg = torch.from_numpy((1.0 / np.maximum(np.bincount(
        d_pad, minlength=n_pad), 1)).astype(np.float32)).to(dev)
    contrast, decay = params.error_contrast, params.decay
    rows = evidence_front_rows(ft, aw, hw)
    a_raw, h, e, _ = rows
    u, m = (torch.from_numpy(rng.uniform(0.0, 1.0, (lanes, n_pad))
                             .astype(np.float32)).to(dev)
            for _ in range(2))
    runs = {
        "evidence_front_fused": (
            lambda: evidence_front(ft, aw, hw, contrast, up),
            lambda: evidence_front_plain(ft, aw, hw, contrast, up)),
        "evidence_front": (lambda: evidence_front_rows(ft, aw, hw),
                           lambda: evidence_front_rows_plain(ft, aw, hw)),
        "seg_contrast_step": (
            lambda: seg_contrast_step(a_raw, e, contrast, up),
            lambda: seg_contrast_step_plain(a_raw, e, contrast, up)),
        "seg_up_step": (lambda: up_seg_step(u, h, decay, up),
                        lambda: up_seg_step_plain(u, h, decay, up)),
        "seg_down_step": (
            lambda: down_seg_step(m, a_raw, decay, down, inv_deg),
            lambda: down_seg_step_plain(m, a_raw, decay, down, inv_deg)),
    }
    bounds = {
        "evidence_front_fused": bound(cost.front(n_pad, e_pad, lanes)),
        "evidence_front": bound(cost.front_rows(n_pad, lanes)),
        "seg_contrast_step": bound(cost.contrast(n_pad, e_pad, lanes)),
        "seg_up_step": bound(cost.up_step(n_pad, e_pad, lanes)),
        "seg_down_step": bound(cost.down_step(n_pad, e_pad, lanes)),
    }
    # what each fused kernel replaced: (its composition, the key its
    # times go under)
    replaced = {"evidence_front_fused": (
        lambda: two_launch_front(ft, aw, hw, contrast, up), "two_launch")}
    # the recursions in the form the plan runs at this size
    grid = not fused(n)
    bounds.update(recursion_bounds(up, down, lanes, grid=grid))
    for name, (kernel, steps, plain) in recursion_runs(
            up, down, h, a_raw, inv_deg, decay, 8, grid).items():
        runs[name] = (kernel, plain)
        replaced[name] = (steps, "per_step")
    checks, times = [], {}
    for name, (kernel, plain) in runs.items():
        got, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        got, again, ref = (x if isinstance(x, tuple) else (x,)
                           for x in (got, again, ref))
        for g, a, r in zip(got, again, ref):
            if not torch.equal(g, a):
                fail(f"batched {name} not deterministic at {n} x {lanes}")
            if name in ("seg_down_step", "seg_down_steps",
                        "seg_down_steps_grid"):
                ok = torch.allclose(g, r, rtol=1e-5, atol=1e-6)
            else:
                ok = torch.equal(g, r)
            if not ok:
                fail(f"batched {name} disagrees with its batched plain "
                     f"version at {n} x {lanes}")
        if name in replaced:
            composed = replaced[name][0]()
            composed = (composed if isinstance(composed, tuple)
                        else (composed,))
            if not all(torch.equal(g, c) for g, c in zip(got, composed)):
                fail(f"batched {name} is not bitwise the launches it "
                     f"replaced at {n} x {lanes}")
        err = max(float((g.float() - r.float()).abs().max())
                  for g, r in zip(got, ref))
        check = {"kernel": name, "services": n, "lanes": lanes,
                 "max_abs_err": err,
                 "bitwise": all(torch.equal(g, r)
                                for g, r in zip(got, ref))}
        checks.append(check)
        phase("batch_check", **check)
        recursion = name in FUSED_KERNELS + GRID_KERNELS
        times[name] = {"ms": cuda_ms(kernel),
                       "call_ms": cuda_ms(kernel, queued=False),
                       "plain_ms": (cuda_ms(plain) if not recursion
                                    else plain_recursion_ms(plain)
                                    if plain_recursions else None),
                       "bound": bounds[name], "max_abs_err": err}
        if name in replaced:
            composed, key = replaced[name]
            times[name].update({
                f"{key}_ms": cuda_ms(composed),
                f"{key}_call_ms": cuda_ms(composed, queued=False)})
    return checks, times


def batch_phase(engine, cases, shapes, aw, hw, params) -> dict:
    """The hypothesis batch on the card (``BATCH`` lanes per tier): one
    launch of each main-path kernel for the whole batch,
    every lane bitwise equal to a solo card analysis of its features; each
    batched kernel against its batched plain version (``u`` and the front
    bitwise, the down-step within rtol 1e-5 / atol 1e-6), the batch delta
    bitwise equal to full staging, and the batched kernels' times."""
    import numpy as np
    import torch
    from rca_tpu_torch.engine.runner import (
        check_batch_delta,
        propagate_ranked,
        propagate_ranked_batch_delta,
    )
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches

    dev = engine.device
    rng = np.random.default_rng(61)
    out = {"times": {}, "checks": [], "launches": {}}
    for n, case in cases.items():
        n_pad, e_pad = shapes[n]
        want = main_launches(n)
        batch = _hypothesis_batch(engine, case)
        reset_launches()
        t0 = time.perf_counter()
        lanes = engine.analyze_batch(batch, case.dep_src, case.dep_dst,
                                     case.names)
        batch_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(LAUNCHES)
        if launches != want:
            fail(f"launch counts {launches} for one batch of {BATCH} at {n},"
                 f" want {want}")
        out["launches"][str(n)] = launches
        if lanes[0].sanitized_rows != 3:
            fail(f"the batch counted {lanes[0].sanitized_rows} bad rows")
        for b, lane in enumerate(lanes):
            solo = engine.analyze_arrays(batch[b], case.dep_src,
                                         case.dep_dst, case.names)
            if not np.array_equal(lane.full_diagnostics(),
                                  solo.full_diagnostics()) or \
                    lane.ranked != solo.ranked:
                fail(f"lane {b} differs from its solo card run at {n}")

        # each batched kernel against its batched plain version
        fb = np.zeros((BATCH, n_pad, C), np.float32)
        fb[:, :n] = batch
        checks, times = _batched_kernels(
            torch.from_numpy(fb).to(dev), case, n_pad, e_pad, aw, hw,
            params, rng)
        out["checks"].extend(checks)
        d_pad = np.full(e_pad, n_pad - 1, np.int64)
        d_pad[: len(case.dep_dst)] = case.dep_dst

        # the batch delta against full staging
        plan = engine.plan_for(n_pad, e_pad, case.dep_src, case.dep_dst)
        f0 = np.zeros((n_pad, C), np.float32)
        f0[:n] = case.features
        idx_b = np.full((BATCH, 6), n_pad - 1, np.int64)
        rows_b = np.zeros((BATCH, 6, C), np.float32)
        for b in range(BATCH):
            ids = rng.choice(n, size=4, replace=False)
            idx_b[b, :4] = ids
            rows_b[b, :4] = rng.uniform(0.0, 1.0, (4, C))
        idx_c, rows_c = check_batch_delta(idx_b, rows_b, n_pad)
        dd = torch.from_numpy(d_pad).to(dev)
        delta = propagate_ranked_batch_delta(
            engine.model, torch.from_numpy(f0).to(dev),
            torch.from_numpy(idx_c).to(dev), torch.from_numpy(rows_c).to(dev),
            dd, n, 13, plan)
        full_b = np.repeat(f0[None], BATCH, axis=0)
        for b in range(BATCH):
            full_b[b, idx_b[b]] = rows_b[b]
        full = propagate_ranked(engine.model, torch.from_numpy(full_b).to(
            dev), dd, n, 13, plan)
        if not all(torch.equal(g, w) for g, w in zip(delta, full)):
            fail(f"the batch delta differs from full staging at {n}")
        out["times"][str(n)] = times
        phase("batch", services=n, lanes=BATCH, launches=launches,
              analyze_batch_ms=batch_ms, delta_bitwise=True, times=times)
    return out


#: the serve phase: requests per load, the direct sweep's batch widths
#: (3 pads to 4 lanes) and the batched kernels' timed lane counts (8 is
#: the batch phase's)
SERVE_REQUESTS = 64
SERVE_WIDTHS = (1, 2, 3, 4, 8, 16)
SERVE_LANES = (1, 2, 4, 16)
SERVE_K = 5


def _serve_features(case, rng, count: int = SERVE_REQUESTS) -> list:
    """``count`` seeded feature sets over ``case``'s graph, alternating a
    dense perturbation (every row within 0.05) and a sparse one (4 rows
    moved up to 0.2, which rides the resident delta path)."""
    import numpy as np

    out = []
    for i in range(count):
        f = case.features.copy()
        if i % 2:
            rows = rng.choice(case.n, 4, replace=False)
            f[rows] = np.clip(f[rows] + rng.uniform(0, 0.2, (4, C)), 0, 1)
        else:
            f = np.clip(f + rng.uniform(0, 0.05, f.shape), 0, 1)
        out.append(f.astype(np.float32))
    return out


def _counting_dispatch(dispatcher, log: list, lock=None, replica=None):
    """Wrap ``dispatcher.dispatch`` so each call runs with any host sync
    raising and logs one row for that device batch (dispatch is where a
    batch launches): its width, its ``b_pad`` lanes, its launches (every
    counter, and the per-shard entries apart), whether it took the delta
    staging, and ``replica``.  A loop has one dispatching thread; a pool's
    replicas share ``lock``, which holds their fetches too, so no other
    replica's launch or sync falls inside a counted dispatch (routing,
    batching and stealing still run on the replicas' threads)."""
    import contextlib

    from rca_tpu_torch.kernels import LAUNCHES, SHARD_LAUNCHES

    inner, inner_fetch = dispatcher.dispatch, dispatcher.fetch
    held = lock if lock is not None else contextlib.nullcontext()

    def dispatch(batch, now=None):
        with held:
            before, shard = dict(LAUNCHES), dict(SHARD_LAUNCHES)
            handle = _no_sync(lambda: inner(batch, now=now))
            log.append({
                "width": len(batch), "b_pad": dispatcher._b_pad(len(batch)),
                "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES},
                "shard": {k: SHARD_LAUNCHES[k] - shard[k]
                          for k in SHARD_LAUNCHES},
                "delta": handle.resident_delta, "replica": replica})
        return handle

    def fetch(handle):
        with held:
            return inner_fetch(handle)

    dispatcher.dispatch = dispatch
    if lock is not None:
        dispatcher.fetch = fetch


def _tenant_latency(reqs, resps) -> dict:
    """Each tenant's submit → completion p50 / p99 in ms (nearest rank)
    over every request of a load, from the scheduler's own stamps
    (admission ``enqueued_at``, the sink's ``completed_at``)."""
    import numpy as np

    by: dict = {}
    for req, resp in zip(reqs, resps):
        by.setdefault(req.tenant, []).append(
            1e3 * (resp.completed_at - req.enqueued_at))
    return {t: {q: float(np.percentile(v, p, method="nearest"))
                for q, p in (("e2e_ms_p50", 50), ("e2e_ms_p99", 99))}
            for t, v in sorted(by.items())}


def _submit_load(plane, items, kill=None, threads: int = 4) -> tuple:
    """``items`` (``(case, features)`` pairs) submitted to ``plane`` (a
    loop or a pool) by ``threads`` threads as 4 tenants, ``kill()`` called
    once half of them are in; returns the requests, their responses and
    the wall from the first submit to the last answer."""
    from rca_tpu_torch.serve import ServeClient
    from rca_tpu_torch.util.threads import make_thread

    reqs = [None] * len(items)
    tenants = [f"tenant-{c}" for c in "abcd"]
    client = ServeClient(plane)

    def submitter(w: int) -> None:
        for i in range(w, len(items), threads):
            if kill is not None and w == 0 and i >= len(items) // 2:
                kill()
            case, f = items[i]
            reqs[i] = client.submit(
                f, case.dep_src, case.dep_dst, names=case.names,
                tenant=tenants[i % 4], k=SERVE_K)

    workers = [make_thread(submitter, name=f"smoke-submit-{w}",
                           daemon=True, args=(w,)) for w in range(threads)]
    t0 = time.perf_counter()
    for t in workers:
        t.start()
    for t in workers:
        t.join(60)
    resps = [r.result(120.0) for r in reqs]
    return reqs, resps, time.perf_counter() - t0


def _serve_load(engine, case, feats, max_batch: int) -> dict:
    """One open-loop load through a ``ServeLoop`` on the card: ``feats``
    submitted by 4 threads as 4 tenants, every dispatch counted and
    sync-checked (:func:`_counting_dispatch`) after one warm dispatch
    builds the graph's prepared state.  Returns the responses, the
    per-batch log, the launches counted from after the warm dispatch and
    the numbers."""
    import numpy as np
    from rca_tpu_torch.config import ServeConfig
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches
    from rca_tpu_torch.serve import ServeLoop, ServeRequest

    loop = ServeLoop(engine=engine, config=ServeConfig(
        max_batch=max_batch, queue_cap=4 * SERVE_REQUESTS))
    warm = ServeRequest("warm", case.features, case.dep_src, case.dep_dst)
    loop.dispatcher.fetch(loop.dispatcher.dispatch([warm]))
    reset_launches()
    log: list = []
    _counting_dispatch(loop.dispatcher, log)
    with loop:
        reqs, resps, wall_s = _submit_load(loop, [(case, f) for f in feats])
    summary = loop.metrics.summary()
    e2e = _tenant_latency(reqs, resps)
    widths = [e["width"] for e in log]
    return {
        "responses": resps, "log": log, "wall_s": wall_s,
        "launches": {k: v for k, v in LAUNCHES.items() if v},
        "analyses_per_s": sum(r.ok for r in resps) / wall_s,
        "device_batches": loop.device_batches,
        "mean_width": float(np.mean(widths)),
        "widths": sorted(set(widths)),
        "delta_batches": sum(1 for e in log if e["delta"]),
        "tenants": {t: {"queue_ms_p50": v["queue_ms_p50"],
                        "queue_ms_p99": v["queue_ms_p99"], **e2e[t],
                        "answered": v["answered"]}
                    for t, v in sorted(summary["tenants"].items())},
    }


def _kill_after_first_batch(replica):
    """A ``kill`` for :func:`_submit_load`: kills ``replica`` once it has
    dispatched a device batch (or 10 s on), so it dies mid-wave."""
    def kill() -> None:
        t_end = time.perf_counter() + 10.0
        while not replica.device_batches and time.perf_counter() < t_end:
            time.sleep(0.001)
        replica.kill()
    return kill


def _pool_load(engine, items, homes, mix: str, kill: bool,
               threads: int = 4) -> dict:
    """``items`` through a ``ServePool`` on the card, as
    :func:`_submit_load` submits them from ``threads`` threads: ``mix``
    its replica kinds (``""``: two dense replicas), ``kill`` kills
    replica 0 mid-wave.  Replica ``i``
    is warmed over the graph of ``homes[i]`` (so a graph no other replica
    holds is routed there), then every device batch is counted and
    sync-checked (:func:`_counting_dispatch`, one lock over the replicas'
    device calls)."""
    import threading

    from rca_tpu_torch.config import ServeConfig
    from rca_tpu_torch.kernels import reset_launches
    from rca_tpu_torch.parallel.mesh import visible_devices
    from rca_tpu_torch.serve import ServePool, ServeRequest

    pool = ServePool(config=ServeConfig(
        max_batch=16, queue_cap=4 * SERVE_REQUESTS, replicas=2,
        replica_mix=mix), devices=visible_devices(engine.device))
    lock, log = threading.Lock(), []
    for r, home in zip(pool.replicas, homes):
        warm = ServeRequest("warm", home.features, home.dep_src,
                            home.dep_dst, k=SERVE_K)
        r.dispatcher.fetch(r.dispatcher.dispatch([warm]))
        _counting_dispatch(r.dispatcher, log, lock=lock,
                           replica=(r.replica_id, r.kind))
    reset_launches()
    with pool:
        reqs, resps, wall_s = _submit_load(
            pool, items,
            kill=_kill_after_first_batch(pool.replicas[0]) if kill else None,
            threads=threads)
    summary = pool.metrics.summary()
    return {
        "responses": resps, "log": log, "wall_s": wall_s,
        "analyses_per_s": sum(r.ok for r in resps) / wall_s,
        "device_batches": len(log),
        "double_completions": pool.sink.double_completions,
        "steals_total": summary.get("steals_total", 0),
        "breaker_state": {str(r.replica_id): r.breaker.state if r.alive()
                          else "dead" for r in pool.replicas},
        "replica_mix": [r.kind for r in pool.replicas],
        "replica_batches": {
            str(r.replica_id): sum(1 for e in log
                                   if e["replica"][0] == r.replica_id)
            for r in pool.replicas},
        "tenants": _tenant_latency(reqs, resps),
        # each kind's solo oracle: the dense kind's is ``engine`` (the
        # same packaged weights and kernels as the dense replicas), as in
        # serve_selftest
        "engines": {"serve+single": engine, **{
            r.dispatcher.engine_tag: r.dispatcher.engine
            for r in pool.replicas if r.kind != "dense"}},
    }


def _same_as_solo(res, solo) -> bool:
    import numpy as np

    return res.ranked == solo.ranked and np.array_equal(res.score,
                                                        solo.score)


def serve_phase(engine, cases, shapes, aw, hw, params, smi: str) -> dict:
    """The serving scheduler on the card (``rca_tpu_torch.serve``): its
    selftest with and without chaos; the batch dispatcher driven directly
    at every width, full and delta staging; a 64-request, 4-tenant load
    per tier through a ``ServeLoop`` and the same requests through a
    ``max_batch = 1`` loop, in turns; then the same requests through a
    pool of two dense replicas with one killed mid-wave and through a
    dense + sharded pool.  Every ok answer bitwise equal to its solo card
    analysis on its own kind's engine, every dense device batch 1 / 1 / 8
    / 8 launches and every sharded one (sp logical shards of the card)
    1 / 1 / 1 launches of the sharded front and the shard recursions, none
    of the per-shard front and steps, every dispatch sync-free, each
    batched launch held against
    its plain version and timed at 1, 2, 4 and 16 lanes."""
    import dataclasses

    import numpy as np
    import torch
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches
    from rca_tpu_torch.resilience.policy import drain_faults
    from rca_tpu_torch.serve import BatchDispatcher, ServeRequest
    from rca_tpu_torch.serve import serve_selftest

    t_phase = time.perf_counter()
    # a sharded device batch: the front and each recursion once over the
    # card's sp logical shards
    want_sharded = _shard_launches(SHARD_SP)
    want_shard = {name: want_sharded[name] for name in SHARD_SOURCES}
    out = {"nvidia_smi": smi, "selftest": {}, "widths": {}, "load": {},
           "batched": {}, "by_width": {}, "pool": {},
           "per_sharded_batch": want_shard}
    drain_faults()

    # -- the selftest, without and with chaos ----------------------------
    for chaos in (False, True):
        got = serve_selftest(engine=engine, chaos=chaos, seed=3 if chaos
                             else 0, n_requests=32, timeout_s=120.0)
        row = {k: got[k] for k in ("ok", "by_status", "parity_checked",
                                   "parity_ok", "device_batches",
                                   "resident_delta_requests")}
        out["selftest"]["chaos" if chaos else "clean"] = row
        phase("serve_selftest", chaos=chaos, **row)
        if not (got["ok"] and got["all_resolved"] and got["parity_ok"]):
            fail(f"serve selftest (chaos={chaos}) failed: {row}; "
                 f"faults {drain_faults()}")
        if not chaos and set(got["by_status"]) - {"ok", "shed"}:
            fail(f"serve selftest answered {got['by_status']} without "
                 "chaos")

    rng = np.random.default_rng(97)
    for n, case in cases.items():
        n_pad, e_pad = shapes[n]
        want = main_launches(n)
        solo_cache = {}

        def solo(f, eng=engine, c=case):
            key = (id(eng), id(c), f.tobytes())
            if key not in solo_cache:
                solo_cache[key] = eng.analyze_arrays(
                    f, c.dep_src, c.dep_dst, c.names, k=SERVE_K)
            return solo_cache[key]

        # -- the dispatcher at every width, full then delta ---------------
        disp = BatchDispatcher(engine)
        warm = ServeRequest("warm", case.features, case.dep_src,
                            case.dep_dst, k=SERVE_K)
        disp.fetch(disp.dispatch([warm]))
        per_width = {}
        for w in SERVE_WIDTHS:
            dense = [np.clip(case.features + rng.uniform(
                0, 0.05, case.features.shape), 0, 1).astype(np.float32)
                for _ in range(w)]
            for staging in ("full", "delta"):
                if staging == "delta":
                    base = disp._graphs[warm.graph_key].base_host[: case.n]
                    feats = []
                    for _ in range(w):
                        f = base.copy()
                        rows = rng.choice(case.n, 4, replace=False)
                        f[rows] = rng.uniform(0, 1, (4, C))
                        feats.append(f)
                    feats[0][rows[0], 3] = np.nan    # a poisoned lane
                else:
                    feats = dense
                reqs = [ServeRequest(f"t{i % 4}", f, case.dep_src,
                                     case.dep_dst, names=case.names,
                                     k=SERVE_K) for i, f in enumerate(feats)]
                reset_launches()
                handle = _no_sync(lambda: disp.dispatch(reqs))
                launches = dict(LAUNCHES)
                results = disp.fetch(handle)
                if launches != want:
                    fail(f"serve batch of {w} ({staging}) at {n} launched "
                         f"{launches}, want {want}")
                if handle.resident_delta != (staging == "delta"):
                    fail(f"serve batch of {w} at {n} took the wrong "
                         f"staging (delta={handle.resident_delta})")
                for i, (f, res) in enumerate(zip(feats, results)):
                    if not _same_as_solo(res, solo(f)):
                        fail(f"serve lane {i} of {w} ({staging}) at {n} "
                             "differs from its solo card analysis")
                if staging == "delta" and results[0].sanitized_rows != 1:
                    fail(f"the delta batch at {n} counted "
                         f"{results[0].sanitized_rows} bad rows")
            per_width[w] = {"b_pad": disp._b_pad(w),
                            "launches": {k: v for k, v in launches.items()
                                         if v}}
            out["by_width"].setdefault(disp._b_pad(w), launches)
        out["widths"][str(n)] = per_width
        phase("serve_widths", services=n, widths=list(SERVE_WIDTHS),
              per_batch=want, bitwise_solo=True, sync_free=True)

        # -- each lane count's batched launches against the plain ones ---
        times = {}
        for lanes in SERVE_LANES:
            fb = np.zeros((lanes, n_pad, C), np.float32)
            fb[:, :n] = _serve_features(case, rng, lanes)
            _, times[str(lanes)] = _batched_kernels(
                torch.from_numpy(fb).to(engine.device), case, n_pad, e_pad,
                aw, hw, params, rng, plain_recursions=False)
        out["batched"][str(n)] = times

        # -- the load, coalesced and max_batch = 1, in turns (after one
        # warm load: the first pays the pinned host buffers' growth) ----
        feats = _serve_features(case, rng)
        runs = {}
        for label, max_batch in (("warm", 16), ("coalesced", 16),
                                 ("max_batch_1", 1), ("coalesced_2", 16),
                                 ("max_batch_1_2", 1)):
            got = _serve_load(engine, case, feats, max_batch)
            totals = {k: got["launches"].get(k, 0) for k in want}
            bad = [r.status for r in got["responses"] if not r.ok]
            if bad:
                fail(f"serve load ({label}) at {n} answered {bad}; faults "
                     f"{drain_faults()}")
            for i, (f, r) in enumerate(zip(feats, got["responses"])):
                if not _same_as_solo(r.result, solo(f)):
                    fail(f"serve load ({label}) at {n}: request {i} "
                         "differs from its solo card analysis")
            for e in got["log"]:
                if e["launches"] != want:
                    fail(f"serve load ({label}) at {n}: a batch of "
                         f"{e['width']} launched {e['launches']}, want "
                         f"{want}")
                out["by_width"].setdefault(e["b_pad"], e["launches"])
            if totals != {k: v * got["device_batches"]
                          for k, v in want.items()}:
                fail(f"serve load ({label}) at {n}: {totals} launches for "
                     f"{got['device_batches']} batches")
            del got["responses"], got["log"]
            runs[label] = got
            phase("serve_load", services=n, run=label, **got)
        out["load"][str(n)] = runs

        # -- the same requests through a pool: two dense replicas, replica
        # 0 killed mid-wave; and a dense + sharded mix over two graphs (the
        # tier's edges, and the same edges in another order), each homed
        # on one replica, so both kinds serve ------------------------------
        perm = rng.permutation(len(case.dep_src))
        other = dataclasses.replace(case, dep_src=case.dep_src[perm],
                                    dep_dst=case.dep_dst[perm])
        mixed = [(other if i % 4 > 1 else case, f) for i, f in
                 enumerate(feats)]
        pools = {}
        for label, mix, items, homes, kill in (
                ("dense_x2_kill", "", [(case, f) for f in feats],
                 (case, case), True),
                ("dense_sharded", f"dense,sharded@{SHARD_SP}", mixed,
                 (other, case), False)):
            t_pool = time.perf_counter()
            got = _pool_load(engine, items, homes, mix, kill)
            bad = [r.status for r in got["responses"] if not r.ok]
            if bad or got["double_completions"]:
                fail(f"serve pool ({label}) at {n} answered {bad}, "
                     f"{got['double_completions']} double completions; "
                     f"faults {drain_faults()}")
            for i, ((c, f), r) in enumerate(zip(items, got["responses"])):
                if not _same_as_solo(r.result, solo(
                        f, got["engines"][r.result.engine], c)):
                    fail(f"serve pool ({label}) at {n}: request {i} differs "
                         f"from its solo analysis on {r.result.engine}")
            for e in got["log"]:
                sharded = e["replica"][1] == "sharded"
                if (e["launches"], e["shard"]) != (
                        (want_sharded, want_shard) if sharded
                        else (want, dict.fromkeys(want_shard, 0))):
                    fail(f"serve pool ({label}) at {n}: replica "
                         f"{e['replica']} launched {e['launches']} "
                         f"({e['shard']} per shard) for a batch of "
                         f"{e['width']}")
            sharded_log = [e for e in got["log"]
                           if e["replica"][1] == "sharded"]
            row = {k: got[k] for k in (
                "wall_s", "analyses_per_s", "device_batches", "steals_total",
                "double_completions", "breaker_state", "replica_mix",
                "replica_batches", "tenants")}
            row.update(
                widths=sorted({e["width"] for e in got["log"]}),
                launches={k: sum(e["launches"][k] for e in got["log"])
                          for k in want},
                sharded_batches=len(sharded_log),
                shard_launches={k: sum(e["shard"][k] for e in sharded_log)
                                for k in want_shard},
                seconds=time.perf_counter() - t_pool)
            pools[label] = row
            phase("serve_pool", services=n, run=label, **row)
        if "dead" not in pools["dense_x2_kill"]["breaker_state"].values():
            fail(f"the killed replica at {n} did not die")
        if not pools["dense_sharded"]["sharded_batches"]:
            fail(f"the sharded replica at {n} served no device batch")
        out["pool"][str(n)] = pools

    out["seconds"] = time.perf_counter() - t_phase
    phase("serve", seconds=out["seconds"])
    return out


def _blocks_agree(card: dict, cpu: dict, label: str) -> None:
    """A card attribution block against the port's CPU block, under the
    CPU tests' tolerances: channels and evidence rows equal, ``upstream``
    bitwise, values within rtol 1e-5 / atol 1e-6, the counterfactual order
    equal outside drops within 1e-6, the blame paths' rows equal and their
    terms within 1e-6, saliency within rtol 1e-4 / atol 1e-6 over the same
    channels and rows."""
    def close(a, b, rtol=1e-5, atol=1e-6):
        return abs(a - b) <= atol + rtol * abs(b)

    if card["evidence_rows"] != cpu["evidence_rows"]:
        fail(f"evidence rows differ from the CPU block ({label})")
    for c, r in zip(card["candidates"], cpu["candidates"]):
        who = f"{label}, {r['component']}"
        if (c["component"], c["channels"]) != (r["component"],
                                                r["channels"]):
            fail(f"channels differ from the CPU block ({who})")
        if c["upstream"] != r["upstream"]:
            fail(f"u differs from the CPU block ({who})")
        for key in ("score", "anomaly", "hard", "impact_mean"):
            if not close(c[key], r[key]):
                fail(f"{key} {c[key]} vs {r[key]} on the CPU ({who})")
        drops = {x["row"]: x["score_drop"] for x in r["counterfactuals"]}
        order = [x["row"] for x in c["counterfactuals"]]
        for x in c["counterfactuals"]:
            if not close(x["score_drop"], drops[x["row"]]):
                fail(f"score drop of row {x['row']} differs ({who})")
        values = [drops[row] for row in order]
        if any(a < b - 1e-6 for a, b in zip(values, values[1:])):
            fail(f"counterfactual order differs from the CPU block ({who})")
        if [h["row"] for h in c["blame_path"]] != \
                [h["row"] for h in r["blame_path"]] or any(
                    abs(hc["term"] - hr["term"]) > 1e-6
                    for hc, hr in zip(c["blame_path"], r["blame_path"])):
            fail(f"blame path differs from the CPU block ({who})")
        cs, rs = c["saliency"]["channels"], r["saliency"]["channels"]
        if sorted(cs) != sorted(rs) or any(
                not close(cs[k], v, rtol=1e-4) for k, v in rs.items()):
            fail(f"saliency differs from the CPU block ({who})")
    rows = {x["row"]: x["grad_l1"] for x in cpu["saliency_rows"]}
    if sorted(x["row"] for x in card["saliency_rows"]) != sorted(rows) or \
            any(not close(x["grad_l1"], rows[x["row"]], rtol=1e-4)
                for x in card["saliency_rows"]):
        fail(f"saliency rows differ from the CPU block ({label})")


def _check_block(block: dict, label: str) -> None:
    if "saliency_unavailable" in block:
        fail(f"saliency unavailable ({label}): "
             f"{block['saliency_unavailable']}")
    if block["kernel"] != "kernels" or not block["candidates"]:
        fail(f"the sweep ran {block['kernel']} with "
             f"{len(block['candidates'])} candidates ({label})")
    worst = max(c["reconstruction_error"] for c in block["candidates"])
    if worst > 1e-5:
        fail(f"reconstruction error {worst} ({label})")


def attribution_phase(engine, big_case, profile_it: bool = False,
                      out_dir=None) -> dict:
    """``RCA_EXPLAIN=1`` comprehensive analyses on the card over the
    50-service fixture and the 2047-service cascade, and
    ``analyze_arrays(...).attribution()`` at 49,999 services: the block is
    there, with saliency and every candidate's reconstruction error at most
    1e-5, equal to the port's CPU block under the CPU tests' tolerances
    (``_blocks_agree``) and identical over two card runs; the sweep runs
    through the kernels (``main_launches`` of two analyses at 49,999,
    counted from 0 just before), the saliency on the ``attribution`` row
    (``torch``); the attribution's wall time is recorded, and with
    ``profile_it`` its device time by op (``device_profile``)."""
    import torch
    from rca_tpu_torch.cluster.generator import synthetic_cascade_world
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.coordinator import RCACoordinator
    from rca_tpu_torch.engine import GraphEngine
    from rca_tpu_torch.engine.registry import kernel_table
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches

    out = {}
    os.environ["RCA_EXPLAIN"] = "1"
    for label, n, roots, seed in (("50svc", 50, 1, 7), ("2047svc", 2047, 3,
                                                         0)):
        ns = "synthetic"
        world = synthetic_cascade_world(n, n_roots=roots, seed=seed,
                                        namespace=ns)
        card = RCACoordinator(MockClusterClient(world), backend="torch")
        blocks = []
        for _ in range(2):
            t0 = time.perf_counter()
            rec = card.run_analysis("comprehensive", ns)
            wall_ms = (time.perf_counter() - t0) * 1e3
            corr = rec["results"].get("correlated", {})
            if rec["status"] != "completed" or "provenance" not in corr:
                fail(f"no provenance block at {label}: "
                     f"{corr.get('provenance_error', rec.get('error'))}")
            blocks.append(corr["provenance"])
        if _dumps(blocks[0]) != _dumps(blocks[1]):
            fail(f"two card runs give different blocks at {label}")
        block = blocks[0]["attribution"]
        _check_block(block, label)
        cpu = RCACoordinator(MockClusterClient(world), backend="torch",
                             device="cpu").run_analysis("comprehensive", ns)
        _blocks_agree(block, cpu["results"]["correlated"]["provenance"][
            "attribution"], label)
        out[label] = {"candidates": len(block["candidates"]),
                      "run_analysis_ms": wall_ms,
                      "digest": blocks[0]["digest"]}
        phase("attribution", world=label, **out[label])
    del os.environ["RCA_EXPLAIN"]

    case = big_case
    blocks, walls = [], []
    for i in range(3):
        res = engine.analyze_case(case)
        reset_launches()
        t0 = time.perf_counter()
        blocks.append(res.attribution())
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            sweep_launches = {k: v for k, v in LAUNCHES.items() if v}
    # the base run and one batch of the counterfactual lanes
    want = {k: v for k, v in main_launches(case.n, 2).items() if v}
    if sweep_launches != want:
        fail(f"the attribution launched {sweep_launches}, want {want}")
    if any(_dumps(b) != _dumps(blocks[0]) for b in blocks[1:]):
        fail("two card runs give different blocks at 49,999 services")
    block = blocks[0]["attribution"]
    _check_block(block, "49999")
    cpu = GraphEngine(device="cpu").analyze_case(case).attribution()
    _blocks_agree(block, cpu["attribution"], "49999")
    rows = [r for r in kernel_table() if r["variant"] == "attribution"]
    if not rows or any(r["winner"] != "torch" for r in rows):
        fail(f"the attribution rows engage {rows}")
    out["49999"] = {"candidates": len(block["candidates"]),
                    "attribution_ms": walls, "launches": sweep_launches,
                    "registry_rows": rows}
    phase("attribution", world="49999 arrays", **out["49999"])
    if profile_it:
        # fresh results, analyzed beforehand: attribution() caches its block
        fresh = iter([engine.analyze_case(case) for _ in range(4)])
        out["device_profile_49999"] = device_profile(
            lambda: next(fresh).attribution(), min(walls), out_dir,
            "attribution_49999")
        phase("attribution_device_profile", **out["device_profile_49999"])
    return out


def commands_start(cli=()) -> dict:
    """The port's commands that need nothing of the phases around them,
    started together as subprocesses on the card so that each pays its
    start-up (an interpreter, ``torch``, a CUDA context, the library)
    beside the others, then each held to its gate: ``hypotheses
    --fixture 50svc --seed 7`` puts the fixture's fault root first over
    a batch of 8; ``analyze --fixture 50svc --seed 7`` ranks it first
    with the torch engine; ``analyze`` with no fixture, no ``kubectl``
    and a missing ``KUBECONFIG`` prints the reference's report for an
    empty, unreachable cluster; ``stream --fixture 50svc --ticks 10
    --pipeline-depth 2`` ranks it first after 10 undegraded lines; ``train
    --iters 20 --allow-unshippable`` writes a checkpoint that
    ``GraphEngine()`` loads under ``RCA_WEIGHTS``.  Started here, beside
    other phases; :func:`commands_finish` holds them to their gates.
    ``cli`` rehearses it on the CPU (``("--device", "cpu")``)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_commands_")
    weights = os.path.join(tmp, "weights.json")
    argvs = {
        "hypotheses": ["hypotheses", "--fixture", "50svc", "--seed", "7",
                       "--compact"],
        "analyze": ["analyze", "--fixture", "50svc", "--seed", "7",
                    "--compact"],
        "no_cluster": ["analyze", "--compact"],
        "stream": ["stream", "--fixture", "50svc", "--ticks", "10",
                   "--pipeline-depth", "2", "--interval", "0"],
        "train": ["train", "--iters", "20", "--out", weights,
                  "--allow-unshippable"]}
    procs = {}
    t0 = time.perf_counter()
    for label, argv in argvs.items():
        procs[label] = subprocess.Popen(
            [sys.executable, "-m", "rca_tpu_torch", *argv, *cli],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_no_kubectl_env(tmp) if label == "no_cluster" else None)
        atexit.register(lambda p=procs[label]: p.poll() is None and p.kill())
    return {"procs": procs, "argvs": argvs, "tmp": tmp, "weights": weights,
            "t0": t0}


def commands_finish(started: dict, smi: str, device="cuda") -> dict:
    """The gates of the commands :func:`commands_start` started (``device``
    ``"cpu"`` rehearses them on the CPU); ``done_s`` and ``seconds``
    count from their start."""
    import shutil

    from rca_tpu_torch.cluster.generator import synthetic_cascade_world
    from rca_tpu_torch.engine import GraphEngine
    from rca_tpu_torch.engine.train import load_params

    procs, argvs, tmp = started["procs"], started["argvs"], started["tmp"]
    weights, t0 = started["weights"], started["t0"]
    stdout, done_s = {}, {}
    try:
        for label, proc in procs.items():
            stdout[label], err = proc.communicate(timeout=600)
            done_s[label] = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"python -m rca_tpu_torch {' '.join(argvs[label])} "
                     f"exited {proc.returncode}: {err[-2000:]}")
        out = {"done_s": done_s}

        got = json.loads(stdout["hypotheses"])
        roots = synthetic_cascade_world(50, n_roots=1, seed=7).ground_truth[
            "fault_roots"]
        top = got["hypotheses"][0]
        if got["batch_width"] != BATCH or top["candidate"] not in roots:
            fail(f"hypotheses: {got['batch_width']} lanes, top {top} vs "
                 f"fault roots {roots}")
        out["hypotheses"] = {
            "top": top["candidate"], "support": top["support"],
            "batch_width": got["batch_width"], "engine": got["engine"],
            "batch_latency_ms_per_hypothesis":
                got["batch_latency_ms_per_hypothesis"]}

        cli = json.loads(stdout["analyze"])
        causes = cli.get("root_causes") or []
        if cli.get("status") != "completed" or not causes or \
                "explained_by_upstream" not in causes[0]:
            fail(f"the CLI gave no engine ranking: "
                 f"{stdout['analyze'][:500]}")
        if causes[0]["component"] not in roots:
            fail(f"the CLI's top-1 {causes[0]['component']} is not a fault "
                 f"root {roots}")
        out["analyze"] = {"top": causes[0]["component"]}

        report = json.loads(stdout["no_cluster"])
        if report != NO_CLUSTER_REPORT:
            fail(f"analyze with no cluster printed {report}, the reference "
                 f"prints {NO_CLUSTER_REPORT}")
        out["no_cluster"] = {"report": report}

        lines = [json.loads(line) for line in stdout["stream"].splitlines()]
        roots_0 = synthetic_cascade_world(50, n_roots=1, seed=0).ground_truth[
            "fault_roots"]
        last = lines[-1]
        if len(lines) != 10 or not last["ranked"] or \
                last["ranked"][0]["component"] not in roots_0 or \
                last.get("degraded") or last.get("pipeline_depth") != 2:
            fail(f"stream: {len(lines)} lines, last {last}, roots {roots_0}")
        out["stream"] = {"top": last["ranked"][0]["component"]}

        cli = json.loads(stdout["train"].strip().splitlines()[-1])
        with mock.patch.dict(os.environ, {"RCA_WEIGHTS": weights}):
            loaded = GraphEngine(device=device).params
        if cli["checkpoint"] != weights or loaded != load_params(weights):
            fail(f"RCA_WEIGHTS did not load the train checkpoint: {cli}")
        out["train"] = {"final_loss": cli["final_loss"],
                        "ships": cli["shippability"]["ships"],
                        "rca_weights_loaded": True}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    phase("commands", smi=smi, **out)
    return out


def _causes_match(got, want, label):
    """The root causes of two comprehensive analyses: same components in
    the same order, every other field equal, floats within rel 1e-5 / abs
    1e-6 and the (4-place) score within 1e-4."""
    import math

    if [r["component"] for r in got] != [r["component"] for r in want]:
        fail(f"root causes differ ({label}): "
             f"{[r['component'] for r in got]} vs "
             f"{[r['component'] for r in want]}")
    for g, w in zip(got, want):
        if sorted(g) != sorted(w):
            fail(f"root-cause fields differ ({label}, {w['component']})")
        for key, value in w.items():
            if key == "score":
                ok = abs(g[key] - value) <= 1e-4
            elif isinstance(value, float):
                ok = math.isclose(g[key], value, rel_tol=1e-5, abs_tol=1e-6)
            else:
                ok = _dumps(g[key]) == _dumps(value)
            if not ok:
                fail(f"root cause {w['component']} field {key} differs "
                     f"({label}): {g[key]} vs {value}")


def _dumps(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=str)


def _without_times(results: dict) -> str:
    """A comprehensive result as JSON without what a rerun may change: the
    stage profile and the engine's latency (also inside its summary)."""
    out = {k: v for k, v in results.items() if k != "profile"}
    out["correlated"] = {k: v for k, v in results["correlated"].items()
                         if k not in ("engine_latency_ms", "summary")}
    return _dumps(out)


def snapshot_phase(smi: str, profile_it: bool = False, out_dir=None) -> dict:
    """Comprehensive analyses through the port's coordinator on the card
    (phase 8 of the module docstring), then the OOM chain's measurement
    and the app's Stream tab over the phase's worlds; ``profile_it`` adds
    a ``torch.profiler`` table of the 2047-service analysis and of its
    betweenness pass."""
    import numpy as np
    import torch
    from rca_tpu_torch.agents import ALL_AGENT_TYPES, AnalysisContext
    from rca_tpu_torch.cluster.fixtures import NS, five_service_world
    from rca_tpu_torch.cluster.generator import synthetic_cascade_world
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
    from rca_tpu_torch.coordinator import RCACoordinator
    from rca_tpu_torch.graph import analysis
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches

    out = {"worlds": []}
    # ``ui`` with no streamlit (exit 1) starts here and is read at the
    # end: its start-up overlaps the analyses
    ui_cli = _ui_command()
    worlds = []
    for label, make, ns in (
            ("5svc", five_service_world, NS),
            ("50svc", lambda: synthetic_cascade_world(
                50, n_roots=1, seed=7, namespace="synthetic"), "synthetic"),
            ("2047svc", lambda: synthetic_cascade_world(
                2047, n_roots=3, seed=0), "synthetic")):
        t0 = time.perf_counter()
        world = make()
        worlds.append((label, world, ns))
        phase("snapshot_world", world=label,
              services=len(world.services[ns]),
              generate_s=time.perf_counter() - t0)

    total = {name: 0 for name in LAUNCHES}
    for label, world, ns in worlds:
        card = RCACoordinator(MockClusterClient(world), backend="torch")
        if card.device.type != "cuda":
            fail(f"coordinator on {card.device}")
        # the analysis takes the columnar default (no silent dict sweep)
        if ClusterSnapshot.capture(MockClusterClient(world),
                                   ns).columnar is None:
            fail(f"the capture at {label} did not take the columnar path")
        # a first analysis resolves the registry row of the world's shape
        # (its race launches kernels); the counted one reads the row
        card.run_analysis("comprehensive", ns)
        reset_launches()
        t0 = time.perf_counter()
        rec = card.run_analysis("comprehensive", ns)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(LAUNCHES)
        if rec["status"] != "completed":
            fail(f"comprehensive analysis {rec['status']} at {label}: "
                 f"{rec.get('error')}")
        # every world here is at most 2047 services: the fused recursions
        if launches != main_launches(2047):
            fail(f"launch counts {launches} for one analysis at {label}, "
                 f"want {main_launches(2047)}")
        for name, count in launches.items():
            total[name] += count
        res = rec["results"]
        corr = res["correlated"]
        if corr.get("backend") != "torch" or "fallback_from" in corr:
            fail(f"correlate fell back at {label}: "
                 f"{corr.get('fallback_reason')}")
        top = [r["component"] for r in corr["root_causes"]]
        if label == "5svc":
            if set(top[:2]) != {"database", "api-gateway"}:
                fail(f"top-2 at 5svc is {top[:2]}")
        elif top[0] not in world.ground_truth["fault_roots"]:
            fail(f"top-1 {top[0]} at {label} is not a fault root "
                 f"{world.ground_truth['fault_roots']}")

        cpu = RCACoordinator(MockClusterClient(world), backend="torch",
                             device="cpu").run_analysis("comprehensive", ns)
        if cpu["status"] != "completed":
            fail(f"CPU analysis {cpu['status']} at {label}")
        cres = cpu["results"]
        for agent in ALL_AGENT_TYPES:
            if _dumps(res[agent]) != _dumps(cres[agent]):
                fail(f"agent {agent} findings differ from the CPU run at "
                     f"{label}")
        if _dumps(corr["groups"]) != _dumps(cres["correlated"]["groups"]):
            fail(f"groups differ from the CPU run at {label}")
        _causes_match(corr["root_causes"], cres["correlated"]["root_causes"],
                      f"card vs CPU, {label}")
        if res["summary"] != cres["summary"]:
            fail(f"summary differs from the CPU run at {label}")
        again = card.run_analysis("comprehensive", ns)
        if _without_times(again["results"]) != _without_times(res):
            fail(f"two card runs differ at {label}")
        with mock.patch.dict(os.environ, {"RCA_COLUMNAR": "0"}):
            dict_rec = card.run_analysis("comprehensive", ns)
        if _without_times(dict_rec["results"]) != _without_times(res):
            fail(f"the dict capture's findings differ from the columnar "
                 f"capture's at {label}")
        row = {"world": label, "status": rec["status"], "top": top[:3],
               "fault_roots": world.ground_truth.get("fault_roots"),
               "launches": launches, "run_analysis_ms": wall_ms,
               "summary": corr["summary"]}
        out["worlds"].append(row)
        phase("snapshot", **row)

    # the betweenness device pass at 2047 against the float64 loop
    label, world, ns = worlds[-1]
    ctx = AnalysisContext(ClusterSnapshot.capture(
        MockClusterClient(world), ns), device=card.device)
    src, dst = ctx.dep_edges
    n = ctx.features.num_services
    if not (analysis._BC_DEVICE_MIN_NODES <= n
            <= analysis._BC_DEVICE_MAX_NODES):
        fail(f"{n} services do not take the betweenness device path")
    got = analysis.betweenness_centrality(n, src, dst, device=card.device)
    t0 = time.perf_counter()
    exact = analysis._betweenness_python(n, src, dst)
    python_ms = (time.perf_counter() - t0) * 1e3
    if not np.allclose(got, exact, rtol=1e-5, atol=1e-7):
        fail("the card's betweenness disagrees with the float64 loop")
    n_pad = -(-n // 256) * 256
    _, finite, levels = analysis._bc_kernel(src, dst, n_pad, card.device)

    def bc():
        analysis.betweenness_centrality(n, src, dst, device=card.device)
        torch.cuda.synchronize()

    products = 2 * levels - 1      # forward levels + backward levels
    bc_ms = host_ms(bc, reps=5)
    bound_ms, bound_by, _ = bound((
        4 * (len(src) * 2 + n_pad),            # the edges in, bc out
        products * 2.0 * n_pad ** 3))          # the [n, n] products
    out["betweenness"] = {
        "services": n, "edges": int(len(src)), "n_pad": n_pad,
        "levels": levels, "finite": finite, "products": products,
        "max_abs_err": float(np.abs(got - exact).max()),
        "ms": bc_ms, "python_float64_ms": python_ms,
        "bound_ms": bound_ms, "bound_by": bound_by}
    phase("betweenness", **out["betweenness"])

    # the stage profile at 2047, columnar (the default) and dict in turns:
    # median of 5 each after a warm-up of each
    walls = {"columnar": [], "dict": []}
    profiles = {"columnar": [], "dict": []}

    def timed_run(path):
        with mock.patch.dict(os.environ, {
                "RCA_COLUMNAR": "1" if path == "columnar" else "0"}):
            t0 = time.perf_counter()
            rec = card.run_analysis("comprehensive", ns)
            return (time.perf_counter() - t0) * 1e3, rec

    for path in ("columnar", "dict"):
        timed_run(path)
    for i in range(5):
        for path in (("columnar", "dict") if i % 2 == 0
                     else ("dict", "columnar")):
            wall, rec = timed_run(path)
            walls[path].append(wall)
            profiles[path].append(rec["results"]["profile"])
    client = MockClusterClient(world)
    captures = {
        "columnar": host_samples(
            lambda: ClusterSnapshot.capture(client, ns), reps=5),
        "dict": host_samples(lambda: ClusterSnapshot.capture(
            client, ns, columnar=False), reps=5)}
    for path, suffix in (("columnar", ""), ("dict", "_dict")):
        prof = profiles[path]
        out[f"profile{suffix}_2047"] = {
            stage: float(np.median([p[stage] for p in prof]))
            for stage in prof[0]}
        out[f"run_analysis_ms{suffix}_2047"] = float(np.median(walls[path]))
        out[f"capture_ms{suffix}_2047"] = float(np.median(captures[path]))
        # the spread of the host walls: the card's host shares its cores
        spread = {
            "run_analysis_ms_range": [min(walls[path]), max(walls[path])],
            "capture_ms_range": [min(captures[path]), max(captures[path])]}
        out.update({f"{k}{suffix}_2047": v for k, v in spread.items()})
        phase("snapshot_profile", services=n, capture=path,
              run_analysis_ms=out[f"run_analysis_ms{suffix}_2047"],
              capture_ms=out[f"capture_ms{suffix}_2047"], **spread,
              **out[f"profile{suffix}_2047"])
    if profile_it:
        out["device_profile_2047"] = {
            "run_analysis": device_profile(
                lambda: card.run_analysis("comprehensive", ns),
                out["run_analysis_ms_2047"], out_dir, "snapshot_2047"),
            "betweenness": device_profile(bc, bc_ms, out_dir,
                                          "betweenness_2047")}
        phase("snapshot_device_profile", **out["device_profile_2047"])

    out["launches"] = total
    out["oomchain"] = _oomchain_leg(smi)
    out["ui"] = _ui_leg(worlds, smi)
    out["ui_command"] = _ui_command_done(ui_cli)
    phase("ui", leg="ui command", **out["ui_command"], smi=smi)
    return out


def _ui_command():
    """``python -m rca_tpu_torch ui`` as a subprocess, started: the card's
    host has no streamlit, so it must exit 1 with its message."""
    return subprocess.Popen(
        [sys.executable, "-m", "rca_tpu_torch", "ui"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _ui_command_done(proc) -> dict:
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    if proc.returncode != 1 or "streamlit is not installed" not in err \
            or "python -m rca_tpu_torch analyze --fixture 5svc" not in err:
        fail(f"ui without streamlit: exit {proc.returncode}: {out[-500:]} "
             f"{err[-1500:]}")
    return {"exit": proc.returncode, "stderr": err.strip()}


def _oomchain_leg(smi: str, device="cuda") -> dict:
    """BASELINE.md row 3 on the card: ``measure_analyze`` over the
    200-pod OOMKill chain (two comprehensive analyses), its launches
    counted from 0 (the shape's registry row elected first: its race
    launches kernels), held to the same measurement on the CPU."""
    import numpy as np
    from rca_tpu_torch.agents import AnalysisContext
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.cluster.oomchain import (
        OOM_NS,
        OOM_ROOT,
        measure_analyze,
        oom_chain_world,
    )
    from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
    from rca_tpu_torch.engine import GraphEngine
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    world = oom_chain_world(200)
    engine = GraphEngine(device=device)
    ctx = AnalysisContext(ClusterSnapshot.capture(MockClusterClient(world),
                                                  OOM_NS), device=device)
    src, dst = ctx.dep_edges
    n = ctx.features.num_services
    f, s, _ = engine._pad(np.zeros((n, C), np.float32), src, dst)
    engine.plan_for(f.shape[0], len(s), src, dst)
    reset_launches()
    card = measure_analyze(MockClusterClient(world), OOM_NS, OOM_ROOT,
                           device=device)
    launches = dict(LAUNCHES)
    cpu = measure_analyze(MockClusterClient(world), OOM_NS, OOM_ROOT,
                          device="cpu")
    if card["status"] != "completed" or card["backend"] != "torch" \
            or card["fallback_reason"] is not None:
        fail(f"oomchain on {device}: {card}")
    if not card["hit1"] or card["top5"] != cpu["top5"]:
        fail(f"oomchain top5 {card['top5']} on {device}, {cpu['top5']} "
             f"on the CPU")
    if device != "cpu" and launches != main_launches(2047, times=2):
        fail(f"oomchain launches {launches}, want "
             f"{main_launches(2047, times=2)} over the two analyses")
    row = {key: card[key] for key in (
        "metric", "environment", "status", "backend", "engine",
        "fallback_reason", "latency_first_run_ms", "latency_warm_ms",
        "engine_latency_ms", "top5", "hit1", "hit3")}
    row.update(services=n, edges=int(len(src)), launches=launches,
               cpu={key: cpu[key] for key in (
                   "latency_first_run_ms", "latency_warm_ms",
                   "engine_latency_ms")},
               seconds=time.perf_counter() - t0)
    phase("oomchain", **{**row, "launches": _nonzero(launches)}, smi=smi)
    return row


def _nonzero(launches: dict) -> dict:
    """The kernels a count saw launch, for a phase line."""
    return {name: count for name, count in launches.items() if count}


#: the Stream tab's polls per world on the card and on the CPU
UI_POLLS = 3


class _ScriptedSt:
    """A stand-in for ``st`` that the app's Stream tab runs on: scripted
    buttons, the tables it draws recorded."""

    def __init__(self):
        self.session_state = {}
        self.buttons = {}
        self.frames = []

    def button(self, label):
        return self.buttons.get(label, False)

    def checkbox(self, label, value=False, key=None):
        return False

    def dataframe(self, data):
        self.frames.append(data)

    def markdown(self, text):
        pass

    def caption(self, text):
        pass

    def info(self, text):
        pass


def _stream_tab_polls(world, ns, device) -> dict:
    """The app's Stream tab on ``device``: start the stream, then
    ``UI_POLLS`` polls, each counted from 0; the ranked table and the
    history of each poll."""
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches
    from rca_tpu_torch.ui.app import _render_stream_tab

    client = MockClusterClient(world)
    st = _ScriptedSt()
    st.buttons = {"Start / reset stream": True}
    t0 = time.perf_counter()
    _render_stream_tab(st, client, ns, device=device)
    start_ms = (time.perf_counter() - t0) * 1e3
    polls = []
    st.buttons = {"Poll now": True}
    for _ in range(UI_POLLS):
        reset_launches()
        t0 = time.perf_counter()
        _render_stream_tab(st, client, ns, device=device)
        polls.append({"wall_ms": (time.perf_counter() - t0) * 1e3,
                      "launches": dict(LAUNCHES),
                      "ranked": st.frames[-2], "history": st.frames[-1]})
    return {"start_ms": start_ms, "polls": polls}


def _ui_leg(worlds, smi: str, device="cuda") -> dict:
    """The app's Stream tab (``rca_tpu_torch/ui/app.py``) ranking on the
    card over the phase's 5-service and 2047-service worlds: the main
    path's launches each poll, the history ticking 1..3, the rankings
    those of the same polls on the CPU."""
    import numpy as np

    out = {}
    for label, world, ns in worlds:
        if label not in ("5svc", "2047svc"):
            continue
        t0 = time.perf_counter()
        card = _stream_tab_polls(world, ns, device)
        cpu = _stream_tab_polls(world, ns, "cpu")
        history = card["polls"][-1]["history"]
        if [h["tick"] for h in history] != list(range(1, UI_POLLS + 1)):
            fail(f"ui {label}: history ticks {[h['tick'] for h in history]}")
        for i, (got, want) in enumerate(zip(card["polls"], cpu["polls"])):
            if device != "cpu" and got["launches"] != main_launches(2047):
                fail(f"ui {label} poll {i + 1}: launches {got['launches']}"
                     f", want {main_launches(2047)}")
            names = [r["component"] for r in got["ranked"]]
            if names != [r["component"] for r in want["ranked"]]:
                fail(f"ui {label} poll {i + 1}: ranked {names} on "
                     f"{device}, {[r['component'] for r in want['ranked']]}"
                     " on the CPU")
            scores = [[r["score"] for r in p["ranked"]] for p in (got, want)]
            if not np.allclose(*scores, rtol=1e-5, atol=1e-6):
                fail(f"ui {label} poll {i + 1}: scores {scores}")
            if label == "5svc" and names[0] != "database":
                fail(f"ui 5svc poll {i + 1}: top {names[0]}")
        row = {
            "world": label, "services": len(world.services[ns]),
            "polls": UI_POLLS, "top": card["polls"][-1]["ranked"][0][
                "component"],
            "launches_per_poll": [p["launches"] for p in card["polls"]],
            "poll_ms": [p["wall_ms"] for p in card["polls"]],
            "start_ms": card["start_ms"],
            "cpu_poll_ms": [p["wall_ms"] for p in cpu["polls"]],
            "history": [h["tick"] for h in history],
            "seconds": time.perf_counter() - t0}
        out[label] = row
        phase("ui", leg=f"stream tab {label}", **{
            **row, "launches_per_poll": [
                _nonzero(counts) for counts in row["launches_per_poll"]]},
            smi=smi)
    return out


#: the capture phase's world sizes, each captured columnar and by the dict
#: sweep in the same call
CAPTURE_SIZES = (2047, 10000, 49999)
#: what the reference's ``analyze --compact`` prints with no fixture, no
#: kubectl and a missing kubeconfig (tier-1 holds the port's JSON to the
#: reference's in that setting)
NO_CLUSTER_REPORT = {"status": "completed", "summary": "No issues detected.",
                     "root_causes": []}


def _same(a, b) -> bool:
    """Deep equality of snapshot values, NaN equal to NaN."""
    import math

    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


def _no_kubectl_env(tmp: str) -> dict:
    """The environment of a host with no cluster: no ``kubectl`` on the
    PATH and a ``KUBECONFIG`` naming a missing file."""
    path = os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "kubectl")))
    return {**os.environ, "PATH": path,
            "KUBECONFIG": os.path.join(tmp, "missing-kubeconfig")}


def _native_check(world, ns) -> dict:
    """Build the native scanner and sanitize extension from
    ``rca_tpu_torch/native/`` with g++ into the port's cache; the scanner
    must load and count what the regex scanner counts on every log of the
    world, and the sanitize extension, where ``Python.h`` exists, must
    load and return what the Python walk returns on fuzzed objects."""
    import copy
    import hashlib
    import random
    import sysconfig
    from pathlib import Path

    import numpy as np
    from rca_tpu_torch import native
    from rca_tpu_torch.cluster.sanitize import sanitize_object
    from rca_tpu_torch.features.logscan import scan_text_python

    t0 = time.perf_counter()
    lib = native.load_native()
    scan_build_s = time.perf_counter() - t0
    if lib is None or not native.native_available():
        fail("the native log scanner did not build or load (g++ on the "
             "card's host)")
    so = Path(lib._name).resolve()
    configured = native.native_cache_dir()
    cache = (Path(configured).resolve() if configured
             else native._default_cache_dir().resolve())
    abi = (sysconfig.get_config_var("SOABI") or "unknown-abi").encode()
    tag = hashlib.sha256(native._SOURCE.read_bytes() + abi).hexdigest()[:16]
    here = Path(__file__).resolve().parent / "rca_tpu_torch" / "native"
    if so.parent != cache or so.name != f"liblogscan-{tag}.so" or \
            native._SOURCE.resolve().parent != here:
        fail(f"the scanner {so} is not the port's build of {here}")

    texts = [text for store in (world.logs, world.previous_logs)
             for by_pod in store.values()
             for by_container in by_pod.values()
             for text in by_container.values()]
    for text in texts:
        if not np.array_equal(native.scan_text_native(text),
                              scan_text_python(text)):
            fail(f"the native scanner disagrees with the regex scanner on "
                 f"a log of the world: {text[:200]!r}")
    t0 = time.perf_counter()
    for text in texts:
        native.scan_text_native(text)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for text in texts:
        scan_text_python(text)
    regex_ms = (time.perf_counter() - t0) * 1e3

    include = sysconfig.get_paths().get("include") or ""
    has_header = os.path.exists(os.path.join(include, "Python.h"))
    t0 = time.perf_counter()
    san = native.load_sanitize()
    san_build_s = time.perf_counter() - t0
    fuzzed = 0
    if san is not None:
        status = "loaded"

        def mangle(obj, rng):
            if isinstance(obj, dict):
                for k in list(obj):
                    r = rng.random()
                    if r < 0.1:
                        del obj[k]
                    elif r < 0.18:
                        obj[k] = None
                    elif r < 0.2:
                        obj[k] = 123
                    else:
                        mangle(obj[k], rng)
            elif isinstance(obj, list):
                for i, item in enumerate(obj):
                    if rng.random() < 0.06:
                        obj[i] = None
                    else:
                        mangle(item, rng)

        objects = [o for store in (world.pods, world.services,
                                   world.deployments, world.events,
                                   world.endpoints)
                   for o in store.get(ns, [])[:60]]
        for seed in range(10):
            rng = random.Random(seed)
            for obj in copy.deepcopy(objects):
                mangle(obj, rng)
                if san.sanitize_object(copy.deepcopy(obj)) != \
                        sanitize_object(copy.deepcopy(obj)):
                    fail(f"the native sanitize disagrees with the Python "
                         f"walk (seed {seed}): {obj!r:.300}")
                fuzzed += 1
    elif has_header:
        fail(f"Python.h is at {include} but the native sanitize did not "
             f"build or load")
    else:
        status = f"not loaded: no Python.h under {include!r}"
    print(f"native_sanitize: {status}", flush=True)
    return {"scanner": str(so), "scanner_build_s": scan_build_s,
            "logs_checked": len(texts), "native_scan_ms": native_ms,
            "regex_scan_ms": regex_ms, "native_sanitize": status,
            "sanitize_build_s": san_build_s, "sanitize_fuzzed": fuzzed}


def capture_phase(smi: str) -> dict:
    """The capture layer on the card's host: the native scanners
    (:func:`_native_check`), then at 2047, 10,000 and 49,999 services one
    world captured columnar (the default) and by the dict sweep in the
    same call: snapshot values and feature matrices bitwise equal, and
    ``capture_ms`` / ``features_ms`` / ``graph_ms`` of each path beside
    each other (medians; the columnar path's first capture, which builds
    the master tables, and its diff capture through a persisted mirror
    apart).  (``analyze`` with no cluster runs in :func:`commands_start`.)"""
    import dataclasses

    import numpy as np
    from rca_tpu_torch.cluster.columnar import (
        ColumnarClientState,
        digest_array_crc,
    )
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
    from rca_tpu_torch.features.extract import extract_features
    from rca_tpu_torch.graph.build import (
        build_typed_graph,
        service_dependency_edges,
    )

    ns = "synthetic"
    out = {"card": smi, "sizes": {}}
    fields = ("pod_features", "service_features", "pod_service", "memb_pod",
              "memb_svc", "pod_node", "node_features")

    def timed(fn, reps):
        walls, value = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            value = fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls)), [min(walls), max(walls)], value

    for n in CAPTURE_SIZES:
        t0 = time.perf_counter()
        world = _generated("world", n, 3, 0)
        generate_s = time.perf_counter() - t0
        if n == CAPTURE_SIZES[0]:
            out["native"] = _native_check(world, ns)
            phase("native", card=smi, **out["native"])
        client = MockClusterClient(world)
        reps = 3 if n > 10000 else 5
        t0 = time.perf_counter()
        first = ClusterSnapshot.capture(client, ns)
        first_ms = (time.perf_counter() - t0) * 1e3
        if first.columnar is None:
            payload = client.get_columnar(ns)
            fail(f"the columnar capture fell back at {n} services: "
                 f"{payload.get('reason', 'columnar view missing')}")
        col_ms, col_range, col = timed(
            lambda: ClusterSnapshot.capture(client, ns), reps)
        state = ColumnarClientState()
        ClusterSnapshot.capture(client, ns, columnar_state=state)
        diff_ms, _, diff = timed(lambda: ClusterSnapshot.capture(
            client, ns, columnar_state=state), reps)
        dict_ms, dict_range, dic = timed(
            lambda: ClusterSnapshot.capture(client, ns, columnar=False),
            reps)
        for snap, label in ((col, "columnar"), (diff, "columnar diff")):
            if snap.columnar is None:
                fail(f"the {label} capture fell back at {n} services")
            for f in dataclasses.fields(snap):
                if f.name != "columnar" and not _same(
                        getattr(snap, f.name), getattr(dic, f.name)):
                    fail(f"snapshot field {f.name} differs between the "
                         f"{label} and the dict capture at {n} services")
        feat_col_ms, _, fs_col = timed(lambda: extract_features(col), reps)
        feat_dict_ms, _, fs_dict = timed(lambda: extract_features(dic), reps)
        for fs in (fs_dict, extract_features(diff)):
            if (fs.pod_names, fs.service_names, fs.node_names) != \
                    (fs_col.pod_names, fs_col.service_names,
                     fs_col.node_names):
                fail(f"feature names differ between the paths at {n}")
            for f in fields:
                a, b = getattr(fs_col, f), getattr(fs, f)
                if a.dtype != b.dtype or a.shape != b.shape or \
                        a.tobytes() != b.tobytes():
                    fail(f"{f} not bitwise equal between the columnar and "
                         f"the dict capture at {n} services")

        def graph(snap, fs):
            g = build_typed_graph(snap)
            return service_dependency_edges(snap, fs, g)

        graph_col_ms, _, e_col = timed(lambda: graph(col, fs_col), reps)
        graph_dict_ms, _, e_dict = timed(lambda: graph(dic, fs_dict), reps)
        if any(a.tobytes() != b.tobytes() for a, b in zip(e_col, e_dict)):
            fail(f"dependency edges differ between the paths at {n}")
        row = {
            "pods": len(col.pods), "generate_s": generate_s,
            "columnar": {"capture_ms": col_ms, "capture_ms_range": col_range,
                         "first_capture_ms": first_ms,
                         "diff_capture_ms": diff_ms,
                         "features_ms": feat_col_ms,
                         "graph_ms": graph_col_ms},
            "dict": {"capture_ms": dict_ms, "capture_ms_range": dict_range,
                     "features_ms": feat_dict_ms, "graph_ms": graph_dict_ms},
            "service_features_crc": digest_array_crc(fs_col.service_features),
            "bitwise_equal": True}
        out["sizes"][str(n)] = row
        phase("capture", services=n, card=smi, **row)
        del world, client, first, col, diff, dic, fs_col, fs_dict

    return out


STREAM_SIZES = (2047, 10000, 49999)


def _bits(t):
    """A float32 tensor's bit pattern (NaN-safe bitwise comparisons)."""
    import torch

    return t.contiguous().view(torch.int32)


def _pow2(u: int) -> int:
    return 1 << max(0, (u - 1).bit_length()) if u else 1


def _resident_requests(case, n_pad, rng):
    """The seeded request sequence of the resident phase: labelled feature
    matrices over one graph."""
    import numpy as np

    n = case.n
    f = case.features.copy()
    out = [("first", f.copy()), ("identical", f.copy())]
    rows = rng.choice(n, 1, replace=False)
    f[rows] = rng.uniform(0, 1, (1, C))
    out.append(("delta_1", f.copy()))
    rows = rng.choice(n, 8, replace=False)
    f[rows] = rng.uniform(0, 1, (8, C))
    f[rows[0]] = np.nan
    f[rows[1], 4] = np.inf
    out.append(("delta_8_nan_inf", f.copy()))
    rows = rng.choice(n, 64, replace=False)
    f[rows] = rng.uniform(0, 1, (64, C))
    f[rows[2], 0] = -np.inf
    out.append(("delta_64", f.copy()))
    f[rng.choice(n, 3, replace=False)] = 0.0
    out.append(("delete_3", f.copy()))
    rows = rng.choice(n, n_pad // 2 + 16, replace=False)
    f[rows] = rng.uniform(0, 1, (len(rows), C))
    out.append(("wide", f.copy()))
    f = np.nan_to_num(f, posinf=0.0, neginf=0.0)
    out.append(("heal", f.copy()))
    out.append(("identical_again", f.copy()))
    return out


def resident_phase(cases, shapes) -> dict:
    """Resident sessions on the card at both tiers: every request of the
    seeded sequence is bitwise equal to ``GraphEngine(resident=False)``
    of the same features (the ``[4, n_pad]`` stack, the top-k with its tie
    order, ``sanitized_rows``), launches the main path's counts, and moves
    the bytes the reference's formula predicts; then the host wall of a delta
    request beside a restaged one."""
    import numpy as np
    import torch
    from rca_tpu_torch.engine import GraphEngine
    from rca_tpu_torch.kernels import (
        LAUNCHES,
        PERSIST_LAUNCHES,
        reset_launches,
    )

    out = {}
    for n, case in cases.items():
        n_pad, _ = shapes[n]
        rng = np.random.default_rng(70 + n)
        res = GraphEngine()
        restaged = GraphEngine(resident=False)
        kk = min(5 + 8, n_pad)
        want_up = want_fetch = 0
        prev = None
        rows = []
        for label, f in _resident_requests(case, n_pad, rng):
            changed = (None if prev is None else
                       np.flatnonzero(np.any(f != prev, axis=1)))
            if changed is None or 2 * len(changed) >= n_pad:
                want_up += n_pad * C * 4
                prev = f.copy()
            elif len(changed):
                want_up += _pow2(len(changed)) * (4 + C * 4)
                prev[changed] = f[changed]
            want_fetch += 4 * kk * 4 + kk * 4 + kk * 4 + 4
            reset_launches()
            got = res.analyze_arrays(f, case.dep_src, case.dep_dst,
                                     case.names)
            launches = dict(LAUNCHES)
            persisting = sum(PERSIST_LAUNCHES.values())
            ref = restaged.analyze_arrays(f, case.dep_src, case.dep_dst,
                                          case.names)
            if launches != main_launches(n) or persisting:
                fail(f"resident {label} at {n}: launches {launches}, "
                     f"{persisting} persisting")
            if not torch.equal(_bits(torch.from_numpy(
                    got.full_diagnostics())), _bits(torch.from_numpy(
                        ref.full_diagnostics()))):
                fail(f"resident {label} at {n} is not bitwise restaging")
            if got.ranked != ref.ranked or \
                    got.sanitized_rows != ref.sanitized_rows:
                fail(f"resident {label} at {n}: ranking or sanitized_rows "
                     f"differ from restaging")
            sess = next(iter(res._resident_cache._sessions.values()))
            rows.append({"request": label,
                         "upload_rows": sess.last_upload_rows,
                         "sanitized_rows": got.sanitized_rows,
                         "launches": launches,
                         "persist_launches": persisting})
        stats = res._resident_cache.stats()
        if (stats["upload_bytes"], stats["fetch_bytes"]) != (want_up,
                                                             want_fetch):
            fail(f"resident bytes at {n}: {stats} vs upload {want_up}, "
                 f"fetch {want_fetch}")
        # host walls: a delta of 8 rows (alternating two matrices) beside
        # the same request restaged, and an identical request
        a = case.features.copy()
        b = a.copy()
        b[rng.choice(n, 8, replace=False)] = rng.uniform(0, 1, (8, C))
        flip = [a, b]

        def delta():
            flip.reverse()
            res.analyze_arrays(flip[0], case.dep_src, case.dep_dst,
                               case.names)

        def restage():
            restaged.analyze_arrays(a, case.dep_src, case.dep_dst,
                                    case.names)

        def identical():
            res.analyze_arrays(flip[0], case.dep_src, case.dep_dst,
                               case.names)

        walls = {"delta_request_ms": host_samples(delta),
                 "restaged_request_ms": host_samples(restage),
                 "identical_request_ms": host_samples(identical)}
        out[str(n)] = {
            "requests": rows, "stats": stats, "bitwise": True,
            **{k: float(np.median(v)) for k, v in walls.items()},
            **{f"{k}_range": [min(v), max(v)] for k, v in walls.items()}}
        phase("resident", services=n, **out[str(n)])
    return out


def _stream_script(n, n_pad, rng):
    """30 ticks: ``("delta", idx, rows)``, ``("quiet",)`` or
    ``("set_all", matrix)``, with NaN/Inf rows, deletes and a delta wider
    than ``n_pad / 2``."""
    import numpy as np

    def delta(u, poison=False):
        idx = rng.choice(n, u, replace=False)
        rows = rng.uniform(0, 1, (u, C)).astype(np.float32)
        if poison:
            rows[0] = np.nan
            rows[-1, 3] = np.inf
        return ("delta", idx, rows)

    script = []
    for t in range(30):
        kind = t % 6
        if t == 15:
            script.append(("set_all", None))
        elif kind == 0:
            script.append(delta(1))
        elif kind == 1:
            script.append(delta(8, poison=True))
        elif kind == 2:
            script.append(delta(64, poison=True))
        elif kind == 3:
            script.append(("quiet",))
        elif kind == 4:
            idx = rng.choice(n, 3, replace=False)
            script.append(("delta", idx, np.zeros((3, C), np.float32)))
        else:
            script.append(delta(n_pad // 2 + 8) if t == 5 else delta(8))
    return script


def stream_phase(engine, cases, profile_it: bool = False,
                 out_dir=None) -> dict:
    """``StreamingSession`` on the card at 2047, 10,000 and 49,999
    services over a 30-tick script: each tick launches the main path's
    counts (``evidence_front_fused`` persisting on delta ticks only, and
    no persisting row pass), its buffer is bitwise
    the plain version's (a twin session on the ``torch`` row), its ranking
    the plain twin's within rtol 1e-5 / atol 1e-6, manual depth-2
    pipelining is serial shifted by one, bitwise, every ``dispatch`` runs
    under ``torch.cuda.set_sync_debug_mode("error")``, and
    ``memory_allocated`` passes the leak gate; then the tick's times
    (``profile_it``: the device time and busy share of a delta and a
    quiet tick)."""
    import numpy as np
    import torch
    from rca_tpu_torch.config import RCAConfig, bucket_for
    from rca_tpu_torch.engine.streaming import StreamingSession
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches
    from rca_tpu_torch.observability.kernelscope import leak_gate

    def stage(session, step, start):
        if step[0] == "delta":
            session.update_rows(step[1], step[2])
        elif step[0] == "set_all":
            session.set_all(start)

    out = {}
    for n in STREAM_SIZES:
        case = cases.get(n) or _generated("arrays", n, 3, 0)
        n_pad = bucket_for(n + 1, RCAConfig().shape_buckets)
        rng = np.random.default_rng(90 + n)
        script = _stream_script(n, n_pad, rng)
        bad_start = case.features.copy()
        bad_start[rng.choice(n, 4, replace=False)] = np.nan

        names = (list(case.names) if case.names is not None
                 else [f"svc-{i}" for i in range(n)])

        def session():
            s = StreamingSession(names, case.dep_src, case.dep_dst,
                                 num_features=C, engine=engine, k=5)
            s.set_all(case.features)
            return s

        serial, plain, piped = session(), session(), session()
        plain.use_torch_row()
        if serial.kernel_path != "kernels":
            fail(f"stream at {n} engages {serial.kernel_path}")
        serial_out, piped_out, mem = [], [], []
        prev = None
        persisted_rows = 0
        counted = {}  # the launches of the first tick of each kind
        for t, step in enumerate(script):
            for s in (serial, plain, piped):
                stage(s, step, bad_start)
            reset_launches()
            handle = _no_sync(serial.dispatch)
            got = serial.fetch(handle)
            launches = _launch_snapshot()
            persisting = launches["evidence_front_fused_persist"]
            if {k: launches[k] for k in LAUNCHES} != main_launches(n) or \
                    persisting != int(step[0] == "delta") or \
                    launches["evidence_front_persist"]:
                fail(f"stream tick {t} ({step[0]}) at {n}: launches "
                     f"{launches}, {persisting} persisting")
            counted.setdefault(step[0], launches)
            want = plain.tick()
            if not torch.equal(_bits(serial._features),
                               _bits(plain._features)):
                fail(f"stream tick {t} at {n}: the persisted buffer is not "
                     f"bitwise its plain version")
            if [r["component"] for r in got["ranked"]] != \
                    [r["component"] for r in want["ranked"]] or \
                    not np.allclose([r["score"] for r in got["ranked"]],
                                    [r["score"] for r in want["ranked"]],
                                    rtol=1e-5, atol=1e-6):
                fail(f"stream tick {t} at {n}: ranking differs from the "
                     f"plain twin")
            for key in ("sanitized_rows", "upload_rows"):
                if got[key] != want[key]:
                    fail(f"stream tick {t} at {n}: {key} {got[key]} vs "
                         f"{want[key]}")
            if step[0] == "delta":
                persisted_rows += got["sanitized_rows"]
            serial_out.append(got)
            h = _no_sync(piped.dispatch)
            if prev is not None:
                piped_out.append(piped.fetch(prev))
            prev = h
            torch.cuda.synchronize()
            mem.append(torch.cuda.memory_allocated())
        piped_out.append(piped.fetch(prev))
        for t, (a, b) in enumerate(zip(serial_out, piped_out)):
            if (a["ranked"], a["upload_rows"], a["sanitized_rows"]) != \
                    (b["ranked"], b["upload_rows"], b["sanitized_rows"]):
                fail(f"stream at {n}: depth-2 tick {t} differs from serial")
        if not torch.equal(_bits(serial._features), _bits(piped._features)):
            fail(f"stream at {n}: the depth-2 buffer differs from serial")
        if torch.isnan(serial._features).any():
            fail(f"stream at {n}: a NaN row survived a delta tick")
        gate = leak_gate(mem, warmup=3)
        if not gate["ok"]:
            fail(f"stream at {n}: device memory grew {gate}")

        # the sync debug mode does not see every sync, so also: a dispatch
        # (delta, then quiet) queued behind a 0.2 s sleep kernel returns
        # while the card is still busy, its result not yet ready
        behind = []
        for step in (_stream_script(n, n_pad, rng)[1], ("quiet",)):
            stage(serial, step, bad_start)
            torch.cuda._sleep(int(0.2 * 2e9))
            t0 = time.perf_counter()
            handle = _no_sync(serial.dispatch)
            ms = (time.perf_counter() - t0) * 1e3
            pending = not handle.result.ready.query()
            serial.fetch(handle)
            if not pending or ms > 100:
                fail(f"stream at {n}: a {step[0]} dispatch waited for the "
                     f"card ({ms:.1f} ms, result pending {pending})")
            behind.append(ms)

        # times: 8-row delta ticks, serial
        walls, dispatch, fetch = [], [], []
        for _ in range(23):
            serial.update_rows(rng.choice(n, 8, replace=False),
                               rng.uniform(0, 1, (8, C)).astype(np.float32))
            t0 = time.perf_counter()
            tick = serial.tick()
            walls.append((time.perf_counter() - t0) * 1e3)
            dispatch.append(tick["dispatch_ms"])
            fetch.append(tick["fetch_ms"])
        quiet = host_samples(serial.tick)
        walls, dispatch, fetch = walls[3:], dispatch[3:], fetch[3:]
        profiles = {}
        if profile_it:
            from rca_tpu_torch.observability.spans import set_profiling

            # name the tick's halves in the profile (device_annotation)
            set_profiling(True)
            def delta_tick():
                serial.update_rows(
                    rng.choice(n, 8, replace=False),
                    rng.uniform(0, 1, (8, C)).astype(np.float32))
                serial.tick()

            profiles = {
                "device_profile_delta_tick": device_profile(
                    delta_tick, float(np.median(walls)), out_dir,
                    f"tick_{n}", calls=5, warm=2),
                "device_profile_quiet_tick": device_profile(
                    serial.tick, float(np.median(quiet)), out_dir,
                    f"quiet_tick_{n}", calls=5, warm=2)}
            set_profiling(False)
        out[str(n)] = {
            "n_pad": n_pad, "ticks": len(script), "tick_launches": counted,
            "persisting_sanitized_rows": persisted_rows,
            "sync_free_dispatches": 2 * len(script) + 2,
            "dispatch_behind_sleep_ms": behind,
            "memory_gate": gate,
            "tick_wall_ms": float(np.median(walls)),
            "tick_wall_ms_range": [min(walls), max(walls)],
            "dispatch_ms": float(np.median(dispatch)),
            "fetch_ms": float(np.median(fetch)),
            "quiet_tick_wall_ms": float(np.median(quiet)), **profiles}
        phase("stream", services=n, **out[str(n)])
    return out


def _mutate(world, ns, op):
    """One descriptor-driven mutation of a world (the live tests' mix:
    crash, heal, logs, metrics; the same descriptor keeps twin worlds
    identical)."""
    from rca_tpu_torch.cluster.world import waiting_status

    kind, idx, arg = op
    pods = world.pods[ns]
    pod = pods[idx % len(pods)]
    name = pod["metadata"]["name"]
    app = pod["metadata"]["labels"].get("app", "x")
    if kind == "crash":
        pod["status"]["phase"] = "Running"
        pod["status"]["containerStatuses"] = [
            waiting_status(app, "CrashLoopBackOff", restarts=arg,
                           last_exit_code=1)]
        world.touch("pod", ns, name)
    elif kind == "heal":
        pod["status"]["phase"] = "Running"
        pod["status"]["containerStatuses"] = [
            {"name": app, "ready": True, "restartCount": 0,
             "state": {"running": {}}}]
        world.touch("pod", ns, name)
    elif kind == "logs":
        world.logs[ns][name] = {app: f"ERROR: failure mode {arg}\n" * arg}
        world.touch("logs", ns, name)
    elif kind == "metrics":
        rec = world.pod_metrics[ns]["pods"].get(name)
        if rec:
            rec["cpu"]["usage_percentage"] = float(arg)
            world.touch("pod_metrics", ns, name)


def _op_sequence(seed, n):
    import numpy as np

    rng = np.random.default_rng(seed)
    kinds = ("crash", "heal", "logs", "metrics")
    return [(kinds[int(rng.integers(0, len(kinds)))],
             int(rng.integers(0, 10_000)), int(rng.integers(1, 9)))
            for _ in range(n)]


class _FeedClient:
    """A mock client whose ``get_columnar`` is the live columnar feed
    (``LiveColumnarFeed``, what ``K8sApiClient.get_columnar`` serves over
    a connected cluster) instead of the mock's own columnar master; pod
    metrics come back as fresh objects on every call, as a live API server
    returns them."""

    def __init__(self, inner, ns):
        from rca_tpu_torch.cluster.live_columnar import LiveColumnarFeed

        self._inner = inner
        self.feed = LiveColumnarFeed(self, ns)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def get_columnar(self, namespace, cursor=None):
        return self.feed.payload(cursor)

    def get_pod_metrics(self, namespace):
        import copy

        return copy.deepcopy(self._inner.get_pod_metrics(namespace))


def _live_run(make_world, ns, device, depth, ops, check_every,
              use_columnar=None, feed=False):
    """Polls of a live session over a mutating world; ``use_columnar``
    None takes the default (``RCA_COLUMNAR``, on), which must hold to the
    end: a columnar session that fell back to the dict sweep fails.
    ``feed`` serves the columnar capture through the live feed."""
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.engine import GraphEngine, LiveStreamingSession

    world = make_world()
    client = MockClusterClient(world)
    if feed:
        client = _FeedClient(client, ns)
    live = LiveStreamingSession(
        client, ns, k=3, engine=GraphEngine(device=device),
        topology_check_every=check_every, pipeline_depth=depth,
        use_columnar=use_columnar)
    outs = []
    for t, op in enumerate(ops):
        if t % 3 != 2:          # every third poll stays quiet
            _mutate(world, ns, op)
        outs.append(live.poll())
    if live._use_columnar is not (use_columnar is not False):
        fail(f"live session at {len(live._names)} services: columnar "
             f"{live._use_columnar}, asked {use_columnar}")
    if feed:
        client.feed.close()
    return outs


def _card_ladder(make_world) -> dict:
    """The degradation ladder on the card: a dispatch that keeps failing
    (injected) takes the ``single-device`` rung, a fresh engine on the
    same kernels, then ``poll()`` raises ``KernelPathFailed`` where the
    reference would step to ``interpret``; no tick ran on the ``torch``
    row."""
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.engine import GraphEngine, LiveStreamingSession
    from rca_tpu_torch.engine.live import KernelPathFailed
    from rca_tpu_torch.engine.streaming import StreamingSession
    from rca_tpu_torch.resilience.policy import drain_faults

    live = LiveStreamingSession(MockClusterClient(make_world()),
                                "synthetic", k=3, engine=GraphEngine(),
                                topology_check_every=100)
    live.poll()
    real = StreamingSession.dispatch

    def broken(self):
        raise RuntimeError("injected dispatch failure")

    StreamingSession.dispatch = broken
    try:
        live.poll()
    except KernelPathFailed as exc:
        raised = type(exc).__name__
    else:
        fail("live ladder: a dispatch failing on every rung did not raise")
    finally:
        StreamingSession.dispatch = real
    # the raise left the injected faults in the process's fault log
    faults = [f["op"] for f in drain_faults()]
    if live.degradation != 1 or live.session.kernel_path != "kernels" or \
            live.engine.device.type != "cuda":
        fail(f"live ladder: rung {live.degradation}, kernel_path "
             f"{live.session.kernel_path}, device {live.engine.device}")
    return {"raised": raised, "rung": "single-device",
            "kernel_path": live.session.kernel_path, "faults": faults}


def live_phase() -> dict:
    """``LiveStreamingSession`` on the card: the 50-service fixture, 60
    polls of the live tests' mutation mix at depths 1 and 2, and a
    10,000-service cascade world, 20 polls at depth 2.  On every tick:
    depth 2 is depth 1 shifted by one, bitwise; nothing degraded, no rung
    taken, no fault; the ranking equals the port's CPU run (components and
    order exact, scores within rtol 1e-5 / atol 1e-6).  The ladder on the
    card raises instead of taking the ``interpret`` rung.  (The
    ``stream`` command runs in :func:`commands_start`.)"""
    import numpy as np
    from rca_tpu_torch.cluster.generator import synthetic_cascade_world

    def healthy(outs, label):
        for t, o in enumerate(outs):
            h = o["health"]
            if o["degraded"] or h["degradation"] or h["faults"]:
                fail(f"live {label} tick {t}: degraded {o['degraded']}, "
                     f"rung {h['degradation_rung']}, faults {h['faults']}")
            if h["kernel_path"] != "kernels":
                fail(f"live {label} tick {t}: kernel_path "
                     f"{h['kernel_path']}")

    def same_as_cpu(card, cpu, label):
        for t, (a, b) in enumerate(zip(card, cpu)):
            if [r["component"] for r in a["ranked"]] != \
                    [r["component"] for r in b["ranked"]] or \
                    not np.allclose([r["score"] for r in a["ranked"]],
                                    [r["score"] for r in b["ranked"]],
                                    rtol=1e-5, atol=1e-6):
                fail(f"live {label} tick {t}: ranking differs from the CPU "
                     f"run")
            for key in ("changed_rows", "upload_rows", "quiet", "resynced"):
                if a[key] != b[key]:
                    fail(f"live {label} tick {t}: {key} {a[key]} vs "
                         f"{b[key]}")

    out = {}
    ops = _op_sequence(13, 60)

    def fixture():
        return synthetic_cascade_world(50, n_roots=1, seed=7,
                                       namespace="synthetic")

    d1 = _live_run(fixture, "synthetic", "cuda", 1, ops, 7)
    d2 = _live_run(fixture, "synthetic", "cuda", 2, ops, 7)
    cpu = _live_run(fixture, "synthetic", "cpu", 1, ops, 7)
    healthy(d1, "50svc depth 1")
    healthy(d2, "50svc depth 2")
    if not d2[0]["health"]["pipeline_fill"]:
        fail("live 50svc depth 2: the first poll is not a fill tick")
    for t in range(1, 60):
        if d2[t]["ranked"] != d1[t - 1]["ranked"]:
            fail(f"live 50svc: depth-2 tick {t} is not depth-1 tick {t - 1}")
    same_as_cpu(d1, cpu, "50svc")
    out["50svc"] = {
        "polls": 60, "busy_polls": sum(not o["quiet"] for o in d1),
        "tick_ms": float(np.median([o["latency_ms"] for o in d1[1:]])),
        "capture_ms_busy": float(np.median(
            [o["capture_ms"] for o in d1 if not o["quiet"]])),
        "capture_ms_quiet": float(np.median(
            [o["capture_ms"] for o in d1 if o["quiet"]]))}
    phase("live", world="50svc", **out["50svc"])
    out["ladder"] = _card_ladder(fixture)
    phase("live_ladder", **out["ladder"])

    def world_10k():
        return _generated("world", 10000, 3, 0)

    roots = world_10k().ground_truth["fault_roots"]
    ops = _op_sequence(29, 20)
    card = _live_run(world_10k, "synthetic", "cuda", 2, ops, 5)
    cpu = _live_run(world_10k, "synthetic", "cpu", 2, ops, 5)
    healthy(card, "10k depth 2")
    same_as_cpu(card, cpu, "10k")
    # the dict sweep on the card, for its capture times beside the default
    dict_run = _live_run(world_10k, "synthetic", "cuda", 2, ops, 5,
                         use_columnar=False)
    healthy(dict_run, "10k depth 2, dict capture")

    def capture_times(run):
        # poll p (1-based) is a sweep when p % 5 == 0, a watch poll
        # otherwise
        quiet = [o["capture_ms"] for o in run[1:] if o["quiet"]]
        busy = [o["capture_ms"] for p, o in enumerate(run[1:], start=2)
                if not o["quiet"] and not o["resynced"] and p % 5]
        sweeps = [o["capture_ms"] for p, o in enumerate(run, start=1)
                  if p % 5 == 0]
        return {"capture_ms_quiet": float(np.median(quiet)),
                "capture_ms_busy": float(np.median(busy)),
                "capture_ms_busy_range": [min(busy), max(busy)],
                "capture_ms_sweep": float(np.median(sweeps))}

    ticks = [o["latency_ms"] for o in card[2:]]
    dispatch = [o["dispatch_ms"] for o in card[2:]]
    fetch = [o["fetch_ms"] for o in card[2:]]
    out["10k"] = {
        "polls": 20, "capture": "columnar",
        **capture_times(card),
        "dict": capture_times(dict_run),
        "dict_ranked_as_columnar": sum(
            a["ranked"] == b["ranked"] for a, b in zip(dict_run, card)),
        "tick_ms": float(np.median(ticks)),
        "tick_ms_range": [min(ticks), max(ticks)],
        "dispatch_ms": float(np.median(dispatch)),
        "fetch_ms": float(np.median(fetch)),
        "top": [r["component"] for r in card[-1]["ranked"]],
        "fault_roots": roots}
    phase("live", world="10k", **out["10k"])

    # the live columnar feed (the live client's get_columnar) over the
    # same world and mutations: every tick ranks as the session over the
    # mock's own columnar feed, with the same changed rows, root first
    fed = _live_run(world_10k, "synthetic", "cuda", 2, ops, 5, feed=True)
    healthy(fed, "10k depth 2, live columnar feed")
    for t, (a, b) in enumerate(zip(fed, card)):
        if a["ranked"] != b["ranked"] or \
                a["changed_rows"] != b["changed_rows"]:
            fail(f"live feed tick {t}: ranking or changed_rows "
                 f"{a['changed_rows']} differ from the mock's own feed's "
                 f"({b['changed_rows']})")
        if a["ranked"] and a["ranked"][0]["component"] not in roots:
            fail(f"live feed tick {t}: top-1 {a['ranked'][0]['component']}"
                 f" is not a fault root {roots}")
    if not fed[-1]["ranked"]:
        fail("live feed: no ranking after 20 polls")
    out["10k_feed"] = {"polls": 20, **capture_times(fed),
                       "top": [r["component"] for r in fed[-1]["ranked"]],
                       "fault_roots": roots}
    phase("live", world="10k live feed", **out["10k_feed"])
    return out


#: the kernels of a tick (the front's persisting launches apart): the
#: front, then the one-CTA or the grid recursions, and the per-step
#: kernels and the front's two halves, which a dense tick no longer
#: launches
TICK_KERNELS = ("evidence_front_fused", *FUSED_KERNELS, *GRID_KERNELS,
                *STEP_KERNELS, "evidence_front", "seg_contrast_step")


def _launch_snapshot() -> dict:
    from rca_tpu_torch.kernels import LAUNCHES, PERSIST_LAUNCHES

    return {**LAUNCHES,
            **{f"{name}_persist": count
               for name, count in PERSIST_LAUNCHES.items()}}


def _counted_polls(per_tick: list, faults: list):
    """A replacement for ``LiveStreamingSession.poll`` that sets the
    launch counters to 0 just before each poll, appends the counts read
    just after to ``per_tick`` and the poll's recorded faults (the health
    record drains the fault log) to ``faults``."""
    from rca_tpu_torch.engine.live import LiveStreamingSession
    from rca_tpu_torch.kernels import reset_launches

    real = LiveStreamingSession.poll

    def poll(self):
        reset_launches()
        out = real(self)
        per_tick.append(_launch_snapshot())
        faults.extend(f["op"] for f in out["health"]["faults"])
        return out

    return real, poll


def _recorded_live(world, ops, recorder, per_tick: list) -> tuple:
    """20 polls of the live mix over ``world`` at depth 2 on the columnar
    capture (``recorder`` None: unrecorded), each poll counted; returns
    the outputs and the per-poll host walls (ms)."""
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.engine import GraphEngine, LiveStreamingSession
    from rca_tpu_torch.kernels import reset_launches

    live = LiveStreamingSession(
        MockClusterClient(world), "synthetic", k=5, engine=GraphEngine(),
        topology_check_every=5, pipeline_depth=2, use_columnar=True,
        recorder=recorder)
    outs, walls = [], []
    for t, op in enumerate(ops):
        if t % 3 != 2:          # every third poll stays quiet
            _mutate(world, "synthetic", op)
        reset_launches()
        t0 = time.perf_counter()
        outs.append(live.poll())
        walls.append(1e3 * (time.perf_counter() - t0))
        per_tick.append(_launch_snapshot())
    if not live._use_columnar:
        fail("replay: the recorded 10,000-service session left the "
             "columnar capture")
    if recorder is not None:
        recorder.close()
    return outs, walls


def replay_phase(cases, smi: str) -> dict:
    """Flight recording and replay on the card.

    - 20 polls of the live mix over ``synthetic_cascade_world(10000,
      n_roots=3, seed=0)`` at depth 2 on the columnar capture, recorded
      and unrecorded in turns (once each, a fresh world each run): the
      tape holds ``coldiff`` frames; ``replay_stream`` gives ``parity_ok``
      bitwise, no unconsumed call, ``kernels`` on every tick, and per
      tick the launches of the recorded poll; the record overhead per
      poll, the bytes per tick, the replayed ticks per second;
    - ``run_chaos_soak`` over the 50-service fixture world for 200 ticks
      with the record leg: no uncaught exception, all five fault classes,
      fault-free ticks bitwise the baseline, the replay in parity on the
      ``kernels`` row, no post-warm recompile, the memory gate;
    - the serve phase's 64-request, 4-tenant load at 2047 through
      ``ServeLoop(recorder=...)``: ``replay_serve`` bitwise for all 64;
    - the committed CPU tape replayed on the card under rank parity
      (hit@1 and hit@3 equal, Kendall-tau), its bitwise verdict printed.

    No recording phase may leave a ``serve.record`` or ``live.*`` fault
    (the chaos soak's come from its injected faults and are counted).
    Tapes go to a temporary directory, removed at the end."""
    import shutil
    import tempfile

    import numpy as np
    from rca_tpu_torch.cluster.generator import synthetic_cascade_world
    from rca_tpu_torch.config import ServeConfig
    from rca_tpu_torch.engine import GraphEngine, LiveStreamingSession
    from rca_tpu_torch.kernels import reset_launches
    from rca_tpu_torch.replay import (
        Recorder,
        load_recording,
        replay_serve,
        replay_stream,
    )
    from rca_tpu_torch.resilience.chaos import FAULT_CLASSES, run_chaos_soak
    from rca_tpu_torch.resilience.policy import drain_faults
    from rca_tpu_torch.serve import ServeLoop

    def no_faults(label, ops=()):
        # a live session drains the fault log into each tick's health
        # record: ``ops`` are those, the log holds the rest
        bad = [op for op in [*ops, *(f["op"] for f in drain_faults())]
               if op == "serve.record" or op.startswith("live.")]
        if bad:
            fail(f"replay {label}: faults {bad}")

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="rca_replay_")
    out = {"nvidia_smi": smi}
    try:
        # -- live recording at 10,000 services ----------------------------
        ops = _op_sequence(29, 20)
        drain_faults()
        walls = {"recorded": [], "unrecorded": []}
        rec_ticks: list = []
        # one turn each keeps the whole run inside about 800 s
        for turn in range(1):
            walls["unrecorded"] += _recorded_live(
                _generated("world", 10000, 3, 0), ops, None, [])[1]
            path = os.path.join(tmp, f"live{turn}")
            rec = Recorder(path, mode="stream")
            rec_ticks = []
            outs, w = _recorded_live(
                _generated("world", 10000, 3, 0), ops, rec, rec_ticks)
            walls["recorded"] += w
        no_faults("10k recording", [f["op"] for o in outs
                                    for f in o["health"]["faults"]])
        for t, o in enumerate(outs):
            if o["degraded"] or o["health"]["kernel_path"] != "kernels":
                fail(f"replay: recorded tick {t + 1} degraded "
                     f"{o['degraded']} on {o['health']['kernel_path']}")
        tape = load_recording(path)
        coldiff = sum(fr["kind"] == "coldiff" for fr in tape.calls)
        if not coldiff:
            fail("replay: the 10,000-service tape holds no coldiff frame")
        replay_ticks: list = []
        replay_faults: list = []
        real, counted = _counted_polls(replay_ticks, replay_faults)
        LiveStreamingSession.poll = counted
        try:
            t0 = time.perf_counter()
            report = replay_stream(path)
            replay_s = time.perf_counter() - t0
        finally:
            LiveStreamingSession.poll = real
        no_faults("10k replay", replay_faults)
        if not report["parity_ok"] or report["unconsumed_calls"] or \
                report["kernel_paths"] != {"kernels": 20}:
            fail(f"replay 10k: parity {report['parity_ok']}, unconsumed "
                 f"{report['unconsumed_calls']}, rows "
                 f"{report['kernel_paths']}, first divergence "
                 f"{report.get('first_divergent_tick')}")
        if replay_ticks != rec_ticks:
            fail(f"replay 10k: launches per tick {replay_ticks} differ from "
                 f"the recorded session's {rec_ticks}")
        for name in TICK_KERNELS:
            if main_launches(10000)[name] and not sum(
                    t[name] for t in replay_ticks):
                fail(f"replay 10k: {name} never launched")
        med_rec = float(np.median(walls["recorded"]))
        med_plain = float(np.median(walls["unrecorded"]))
        out["live_10k"] = {
            "ticks": 20, "coldiff_frames": coldiff,
            "bytes": rec.bytes_written,
            "bytes_per_tick": rec.bytes_written / 20,
            "poll_ms_recorded": med_rec, "poll_ms_unrecorded": med_plain,
            "record_overhead_pct": 100.0 * (med_rec - med_plain) / med_plain,
            "replay_s": replay_s, "replayed_ticks_per_s": 20 / replay_s,
            "launches_per_tick": {
                "delta_or_busy_max": {k: max(t[k] for t in replay_ticks)
                                      for k in replay_ticks[0]},
                "total": {k: sum(t[k] for t in replay_ticks)
                          for k in replay_ticks[0]}},
            "kernel_paths": report["kernel_paths"]}
        phase("replay", leg="live_10k", **out["live_10k"])

        # -- the chaos soak -------------------------------------------------
        t0 = time.perf_counter()
        soak = run_chaos_soak(
            lambda: synthetic_cascade_world(50, n_roots=1, seed=7,
                                            namespace="synthetic"),
            "synthetic", seed=7, ticks=200, engine_factory=GraphEngine,
            record_path=os.path.join(tmp, "chaos"))
        faults = [f["op"] for f in drain_faults()]
        leg = soak["replay"]
        scope = soak["kernelscope"]
        if soak["uncaught_exceptions"] or not soak["all_classes_observed"] \
                or not soak["parity_ok"] or not leg["parity_ok"] or \
                leg["unconsumed_calls"] or \
                scope["recompiles_post_warm"] or \
                not scope["memory_gate"].get("ok", True) or \
                leg["kernel_paths"] != {"kernels": 200} or \
                soak["kernel_paths"] != {"kernels": 200} or \
                "chaos.soak.uncaught" in faults or "serve.record" in faults:
            fail(f"replay chaos soak: {soak}")
        out["chaos"] = {
            "ticks": 200, "seconds": time.perf_counter() - t0,
            "faults_injected": soak["faults_injected"],
            "fault_classes": len(FAULT_CLASSES),
            "degraded_ticks": soak["degraded_ticks"],
            "parity_ticks_checked": soak["parity_ticks_checked"],
            "replay_ticks": leg["ticks_replayed"],
            "bytes": leg["bytes"], "fault_log": sorted(set(faults))}
        phase("replay", leg="chaos", **out["chaos"])

        # -- serve: 64 requests at 2047, recorded -------------------------
        case = cases[2047]
        items = [(case, f) for f in _serve_features(
            case, np.random.default_rng(11))]
        drain_faults()
        rec = Recorder(os.path.join(tmp, "serve"), mode="serve")
        loop = ServeLoop(engine=GraphEngine(), recorder=rec,
                         config=ServeConfig(max_batch=16,
                                            queue_cap=4 * SERVE_REQUESTS))
        with loop:
            _, resps, wall_s = _submit_load(loop, items)
        rec.close()
        no_faults("serve recording")
        if not all(r.ok for r in resps):
            fail(f"replay serve: statuses {[r.status for r in resps]}")
        t0 = time.perf_counter()
        served = replay_serve(os.path.join(tmp, "serve"))
        serve_replay_s = time.perf_counter() - t0
        if not served["parity_ok"] or \
                served["requests_recorded"] != SERVE_REQUESTS:
            fail(f"replay serve: parity {served['parity_ok']}, "
                 f"{served['requests_recorded']} frames, first divergence "
                 f"{served['first_divergent_index']}")
        out["serve"] = {
            "requests": SERVE_REQUESTS, "frames": served["requests_recorded"],
            "device_batches": loop.device_batches, "load_s": wall_s,
            "bytes_per_request": rec.bytes_written / SERVE_REQUESTS,
            "replay_s": serve_replay_s}
        phase("replay", leg="serve", **out["serve"])

        # -- the CPU tape on the card -------------------------------------
        tape_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tests", "corpus_torch",
                                 "chaos-20svc-seed11.torch.rcz")
        rank = replay_stream(tape_path, parity="rank")
        exact = replay_stream(tape_path)
        if not rank["parity_ok"] or rank["unconsumed_calls"] or \
                rank["kernel_paths"] != {"kernels": 40}:
            fail(f"replay CPU tape on the card: {rank}")
        out["cpu_tape"] = {
            "ticks": rank["ticks_replayed"],
            "recorded_on": rank["env_recorded"]["device_kind"],
            "rank_parity_ok": rank["parity_ok"],
            "bitwise_parity_ok": exact["parity_ok"],
            "bitwise_mismatched_ticks": exact["mismatched_ticks"]}
        phase("replay", leg="cpu_tape", **out["cpu_tape"])
        reset_launches()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    phase("replay", seconds=out["seconds"])
    return out


# -- the quantized and doubling rows, and training ---------------------------

VARIANT_ROWS = ("kernels", "doubling", "quantized", "torch")
#: the doubling row: the front's one kernel, no seg step
DOUBLING_LAUNCHES = {**main_launches(2047), "seg_up_steps": 0,
                     "seg_down_steps": 0}
NO_LAUNCHES = dict.fromkeys(DOUBLING_LAUNCHES, 0)
TRAIN_MODES = ("standard", "crashing_victims", "correlated_noise",
               "adversarial")


def _row_env(row: str):
    """``RCA_KERNEL`` naming ``row`` while the block runs; for ``kernels``
    (the row the card's race elects; the registry phase left the knob
    unset) nothing."""
    return mock.patch.dict(os.environ,
                           {} if row == "kernels" else {"RCA_KERNEL": row})


def _same_ranked(got, want) -> bool:
    return [(r["component"], r["score"]) for r in got] == [
        (r["component"], r["score"]) for r in want]


def variants_phase(cases, shapes, smi: str) -> dict:
    """The ``quantized`` and ``doubling`` rows on the card, at both tiers,
    beside ``kernels`` and ``torch``: ``GraphEngine().analyze_case`` on
    each row (restaged), the launch counters set to 0 just before one
    analysis.  ``kernels`` launches the main path's counts; ``doubling``
    launches ``evidence_front_fused`` once and no seg step, or, where the
    frontier cap declines the graph, its plan says ``kernels`` and it
    launches the main path's counts (the 2047 tier must engage); its ``u``
    is bitwise the ``kernels`` row's, its scores within rtol 1e-5 / atol
    1e-6, its top-k identical.  ``quantized`` launches none of the port's
    kernels (its reference has no Pallas body) and keeps rank parity with
    ``kernels``; ``torch`` launches none either.  Each row is bitwise
    equal to itself over two runs.  Then ``analyze_arrays`` restaged,
    median of 20, per row, and at 2047 one 8-lane ``analyze_batch`` and
    one streaming session (a full tick, a delta tick) under
    ``RCA_KERNEL=doubling``, each bitwise equal to its solo analysis."""
    import numpy as np
    import torch
    from rca_tpu_torch.engine import GraphEngine
    from rca_tpu_torch.engine.quantized import rank_parity
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    out = {}
    for n, case in cases.items():
        n_pad, e_pad = shapes[n]
        args = (case.features, case.dep_src, case.dep_dst, case.names)
        res, counts, plans, walls = {}, {}, {}, {}
        for row in VARIANT_ROWS:
            with _row_env(row):
                eng = GraphEngine(resident=False)
                eng.analyze_case(case)          # the row's layouts, warm
                torch.cuda.synchronize()
                reset_launches()
                first = eng.analyze_case(case)
                counts[row] = dict(LAUNCHES)
                again = eng.analyze_case(case)
                plans[row] = eng.plan_for(n_pad, e_pad, case.dep_src,
                                          case.dep_dst).kernel
                walls[row] = host_ms(lambda: eng.analyze_arrays(*args))
            if not np.array_equal(first.full_diagnostics(),
                                  again.full_diagnostics()):
                fail(f"the {row} row is not bitwise equal to itself at {n}")
            res[row] = first
        engaged = plans["doubling"] == "doubling"
        want = {"kernels": main_launches(n),
                "doubling": DOUBLING_LAUNCHES if engaged
                else main_launches(n),
                "quantized": NO_LAUNCHES, "torch": NO_LAUNCHES}
        for row in VARIANT_ROWS:
            if counts[row] != want[row]:
                fail(f"{row} row launched {counts[row]} at {n}, want "
                     f"{want[row]} (plan {plans[row]})")
        if not engaged and (n == TIERS[0][0] or plans["doubling"]
                            != "kernels"):
            fail(f"doubling declined at {n}: plan {plans['doubling']}")
        kern, dbl = res["kernels"], res["doubling"]
        if not np.array_equal(dbl.upstream, kern.upstream):
            fail(f"doubling u not bitwise the kernels row's at {n}")
        if not np.allclose(dbl.score, kern.score, rtol=1e-5, atol=1e-6):
            fail(f"doubling scores disagree with the kernels row at {n}")
        if dbl.top_components() != kern.top_components():
            fail(f"doubling top-k {dbl.top_components()} vs "
                 f"{kern.top_components()} at {n}")
        parity = rank_parity(kern.ranked, res["quantized"].ranked)
        if not parity["ok"]:
            fail(f"quantized rank parity at {n}: {parity}")
        entry = {
            "doubling": "engaged" if engaged else "declined (frontier cap)",
            "plans": plans, "launches": counts,
            "launches_per_analysis": {r: sum(c.values())
                                      for r, c in counts.items()},
            "analyze_arrays_ms": walls,
            "doubling_score_max_abs_err": float(
                np.abs(dbl.score - kern.score).max()),
            "quantized_rank_parity": parity,
            "quantized_score_max_abs_err": float(
                np.abs(res["quantized"].score - kern.score).max()),
            "top": kern.top_components()}
        if n == TIERS[0][0]:
            entry.update(_doubling_surfaces(case))
        out[str(n)] = entry
        phase("variants", services=n, smi=smi, **entry)
    out["layouts"] = _layouts_leg(cases, shapes, smi)
    out["seconds"] = time.perf_counter() - t_phase
    return out


LAYOUTS = ("hybrid", "coo", "ell")
#: launches per analysis under each ``RCA_EDGE_LAYOUT``: ``coo`` runs the
#: seg steps over the same sorted edges as ``hybrid``; ``ell`` runs the K1
#: front, then its gather tables with the overflow's flagged segmented sum
#: (``segscan_sum``) once a step
def layout_launches(services: int) -> dict:
    """Launches per analysis under each edge layout: ``hybrid`` and
    ``coo`` the main path's; ``ell`` the front's and the overflow's
    flagged sum once a step."""
    return {"hybrid": main_launches(services),
            "coo": main_launches(services),
            "ell": {**DOUBLING_LAUNCHES, "segscan_sum": 8}}


def _layouts_leg(cases, shapes, smi: str) -> dict:
    """``RCA_EDGE_LAYOUT`` on the card at both tiers: one restaged
    ``analyze_case`` per layout counted from 0 (:func:`layout_launches`),
    each result stamped with the ``kernels`` row and its layout, the dense
    registry row keyed by the layout; ``coo``'s ``u`` bitwise ``hybrid``'s
    with scores at rtol 1e-5 / atol 1e-6, ``ell``'s ``u`` bitwise and
    scores within 1e-6, top-k identical on both; every layout bitwise
    itself over two runs; an 8-lane ``ell`` batch bitwise its 8 solo runs;
    ``segscan_sum`` over the ``ell`` down overflow (the analysis's own
    last-step values) against ``segscan_plain`` at rtol 1e-5 / atol 1e-6
    and bitwise itself, with its times; each layout's ``analyze_arrays``
    wall (restaged, median of 20); the full-ELL tables' widths, overflow
    and bytes beside the largest hub's dependents."""
    import numpy as np
    import torch
    from rca_tpu_torch.engine import GraphEngine
    from rca_tpu_torch.engine.ell import EllGraph, ell_tables_for
    from rca_tpu_torch.engine.propagate import background_excess
    from rca_tpu_torch.engine.registry import get_registry
    from rca_tpu_torch.engine.segscan import segscan_plain, segscan_sum
    from rca_tpu_torch.kernels import LAUNCHES, cost, reset_launches

    out = {}
    for n, case in cases.items():
        n_pad, e_pad = shapes[n]
        args = (case.features, case.dep_src, case.dep_dst, case.names)
        rng = np.random.default_rng(13)
        batch = np.repeat(case.features[None], BATCH, axis=0)
        for b in range(BATCH):
            batch[b, rng.integers(0, case.n, 4)] = rng.uniform(0, 1, (4, C))
        batch[5, 11, 2] = np.inf
        res, counts, stamps, walls = {}, {}, {}, {}
        for layout in LAYOUTS:
            with mock.patch.dict(os.environ, {"RCA_EDGE_LAYOUT": layout}):
                eng = GraphEngine(resident=False)
                eng.analyze_case(case)      # the layout's tables, warm
                torch.cuda.synchronize()
                reset_launches()
                first = eng.analyze_case(case)
                counts[layout] = dict(LAUNCHES)
                row = get_registry().resolve(n_pad, e_pad=e_pad,
                                             device=eng.device)
                stamps[layout] = {"kernel": first.kernel,
                                  "layout": first.layout,
                                  "row_source": row.source,
                                  "row_layout": row.layout}
                again = eng.analyze_case(case)
                walls[layout] = host_ms(lambda: eng.analyze_arrays(*args))
                if layout == "ell":
                    lanes = eng.analyze_batch(batch, *args[1:])
                    for b, lane in enumerate(lanes):
                        solo = eng.analyze_arrays(batch[b], *args[1:])
                        if not np.array_equal(lane.full_diagnostics(),
                                              solo.full_diagnostics()):
                            fail(f"ell batch lane {b} is not its solo run "
                                 f"at {n}")
            if not np.array_equal(first.full_diagnostics(),
                                  again.full_diagnostics()):
                fail(f"the {layout} layout is not bitwise itself at {n}")
            if counts[layout] != layout_launches(n)[layout]:
                fail(f"{layout} launched {counts[layout]} at {n}, want "
                     f"{layout_launches(n)[layout]}")
            if (stamps[layout]["kernel"] != "kernels"
                    or stamps[layout]["layout"] != layout
                    or stamps[layout]["row_layout"] != layout):
                fail(f"the {layout} stamp at {n}: {stamps[layout]}")
            res[layout] = first
        hyb = res["hybrid"]
        for layout in ("coo", "ell"):
            got = res[layout]
            if not np.array_equal(got.upstream, hyb.upstream):
                fail(f"{layout} u is not bitwise hybrid's at {n}")
            if got.top_components() != hyb.top_components():
                fail(f"{layout} top-k {got.top_components()} vs "
                     f"{hyb.top_components()} at {n}")
        if not np.allclose(res["coo"].score, hyb.score, rtol=1e-5,
                           atol=1e-6):
            fail(f"coo scores disagree with hybrid at {n}")
        ell_err = float(np.abs(res["ell"].score - hyb.score).max())
        if ell_err > 1e-6:
            fail(f"ell scores {ell_err} from hybrid's at {n}")
        graph = EllGraph.build(n_pad, case.dep_src, case.dep_dst)
        # the ell down step's overflow sum at this graph's overflow shape,
        # over the values of the analysis's last step
        ovf = ell_tables_for(n_pad, case.dep_src, case.dep_dst,
                             eng.device).dn_ovf
        diag = torch.from_numpy(res["ell"].full_diagnostics()).to(eng.device)
        a_ex = background_excess(diag[0], case.n)
        decay = eng.params.decay
        x = (a_ex[ovf.other_sorted] + decay * diag[2][ovf.other_sorted])
        x = x.contiguous()
        k1, k2 = segscan_sum(x, ovf.flags), segscan_sum(x, ovf.flags)
        plain = segscan_plain(x, ovf.flags, "sum")
        if not torch.equal(k1, k2):
            fail(f"segscan_sum over the ell overflow not deterministic "
                 f"at {n}")
        if not torch.allclose(k1, plain, rtol=1e-5, atol=1e-6):
            fail(f"segscan_sum disagrees with plain over the ell overflow "
                 f"at {n}")
        o_pad = int(x.shape[0])
        lengths = torch.from_numpy(np.bincount(
            graph.down.ovf_seg, minlength=n_pad).astype(np.int64)).to(
                eng.device)
        entry = {
            "ell_overflow_scan": {
                "e_pad": o_pad, "edges": graph.down.n_overflow,
                "max_abs_err": float((k1 - plain).abs().max()),
                "rtol": 1e-5, "atol": 1e-6,
                "ms": cuda_ms(lambda: segscan_sum(x, ovf.flags)),
                "plain_ms": cuda_ms(lambda: segscan_plain(x, ovf.flags,
                                                          "sum")),
                "library_ms": cuda_ms(lambda: torch.segment_reduce(
                    x, "sum", lengths=lengths)),
                "bound": bound(cost.segscan(o_pad))},
            "launches": counts, "stamps": stamps,
            "analyze_arrays_ms": walls,
            "coo_score_max_abs_err": float(
                np.abs(res["coo"].score - hyb.score).max()),
            "ell_score_max_abs_err": ell_err,
            "ell_batch_lanes": BATCH, "ell_batch_bitwise_solo": True,
            "ell_tables": {
                "up_width": int(graph.up.idx.shape[1]),
                "down_width": int(graph.down.idx.shape[1]),
                "up_overflow": graph.up.n_overflow,
                "down_overflow": graph.down.n_overflow,
                "down_overflow_pad": int(len(graph.down.ovf_seg)),
                "bytes": graph.nbytes(),
                "largest_hub_dependents": int(np.bincount(
                    case.dep_dst, minlength=n_pad).max())},
            "top": hyb.top_components()}
        out[str(n)] = entry
        phase("variants", leg="layouts", services=n, smi=smi, **entry)
    return out


def _doubling_surfaces(case) -> dict:
    """Under ``RCA_KERNEL=doubling``: 8 lanes of ``analyze_batch`` (4 rows
    changed per lane, a NaN in lane 3) and a streaming session (a full
    tick, then a delta tick), each bitwise equal to its solo analysis."""
    import numpy as np
    from rca_tpu_torch.engine import GraphEngine, StreamingSession
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches

    rng = np.random.default_rng(12)
    batch = np.repeat(case.features[None], BATCH, axis=0)
    for b in range(BATCH):
        batch[b, rng.integers(0, case.n, 4)] = rng.uniform(0, 1, (4, C))
    batch[3, 9, 1] = np.nan
    args = (case.dep_src, case.dep_dst, case.names)
    with _row_env("doubling"):
        eng = GraphEngine(resident=False)
        reset_launches()
        lanes = eng.analyze_batch(batch, *args)
        batch_launches = dict(LAUNCHES)
        for b, lane in enumerate(lanes):
            solo = eng.analyze_arrays(batch[b], *args)
            if not np.array_equal(lane.full_diagnostics(),
                                  solo.full_diagnostics()):
                fail(f"doubling batch lane {b} is not its solo analysis")
        sess = StreamingSession(case.names, case.dep_src, case.dep_dst,
                                num_features=C, engine=eng, k=5)
        if sess.kernel_path != "doubling":
            fail(f"the doubling session runs {sess.kernel_path}")
        sess.set_all(case.features)
        ticks = [sess.tick()]
        changed = case.features.copy()
        changed[17] = np.clip(changed[17] + 0.5, 0, 1)
        sess.update(17, changed[17])
        ticks.append(sess.tick())
        for tick, feats in zip(ticks, (case.features, changed)):
            solo = eng.analyze_arrays(feats, *args, k=5)
            if not _same_ranked(tick["ranked"], solo.ranked):
                fail("a doubling tick is not its solo analysis")
    if batch_launches != DOUBLING_LAUNCHES:
        fail(f"the doubling batch launched {batch_launches}")
    return {"batch_lanes": BATCH, "batch_launches": batch_launches,
            "stream_ticks": len(ticks), "batch_and_stream_bitwise": True}


def train_phase(smi: str) -> dict:
    """Training on the card at the ``train`` command's defaults (256
    services, 64 cases, 150 iterations, the four modes): the first 5
    iterations' losses and raw values within rtol 1e-4 (atol 1e-6 on the
    raw values) of the port's CPU run of the same config; the whole fit on
    the card (ms per iteration, the wall, the first and last loss);
    ``shippability_report`` of the card's fitted weights on the card
    (``kernels`` row) equal as a dict to the same report on
    ``GraphEngine(device="cpu")``.  (The ``train`` command runs in
    :func:`commands_start`.)"""
    import dataclasses

    import numpy as np
    import torch
    from rca_tpu_torch.engine.runner import resolve_device
    from rca_tpu_torch.engine.train import (
        TrainConfig,
        make_dataset,
        shippability_report,
        stage_dataset,
        train,
    )

    t_phase = time.perf_counter()
    cfg = TrainConfig(modes=TRAIN_MODES)
    short = dataclasses.replace(cfg, iters=5)
    cpu_raw, card_raw = [], []
    _, cpu_hist = train(short, device="cpu", history_raw=cpu_raw)
    _, card_hist = train(short, history_raw=card_raw)
    if not np.allclose(card_hist, cpu_hist, rtol=1e-4, atol=0.0):
        fail(f"card losses {card_hist} vs CPU {cpu_hist}")
    raw_err = 0.0
    for card_it, cpu_it in zip(card_raw, cpu_raw):
        for key, value in card_it.items():
            if not np.allclose(value, cpu_it[key], rtol=1e-4, atol=1e-6):
                fail(f"raw {key} after {len(card_raw)} iterations: card "
                     f"{value} vs CPU {cpu_it[key]}")
            raw_err = max(raw_err, float(np.max(np.abs(
                value - cpu_it[key]) / np.maximum(np.abs(cpu_it[key]),
                                                  1e-6))))
    t0 = time.perf_counter()
    stage_dataset(*make_dataset(cfg), resolve_device(None))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params, hist = train(cfg)
    fit_s = time.perf_counter() - t0
    if not (np.isfinite(hist).all() and hist[-1] < hist[0]):
        fail(f"the card fit did not lower its loss: {hist[0]} -> {hist[-1]}")
    t0 = time.perf_counter()
    card_report = shippability_report(params)
    gate_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_report = shippability_report(params, device="cpu")
    gate_cpu_s = time.perf_counter() - t0
    if card_report != cpu_report:
        fail(f"the gate on the card {card_report} vs on the CPU "
             f"{cpu_report}")
    out = {
        "config": {"services": cfg.n_services, "cases": cfg.n_cases,
                   "iters": cfg.iters, "modes": list(cfg.modes)},
        "first5_losses_card": card_hist, "first5_losses_cpu": cpu_hist,
        "first5_raw_max_rel_err": raw_err,
        "fit_s": fit_s, "setup_s": setup_s,
        "ms_per_iter": (fit_s - setup_s) * 1e3 / cfg.iters,
        "first_loss": hist[0], "last_loss": hist[-1],
        "decay": params.decay, "explain_strength": params.explain_strength,
        "impact_bonus": params.impact_bonus,
        "ships": card_report["ships"],
        "holdout_adversarial_hit1": card_report["holdout_adversarial_hit1"],
        "gate_card_s": gate_card_s, "gate_cpu_s": gate_cpu_s,
        "gate_equal_cpu": True,
        "seconds": time.perf_counter() - t_phase}
    phase("train", smi=smi, **out)
    return out


# -- the investigation layer ---------------------------------------------------

#: what differs between two runs of one investigation: ids, clocks, walls
INVESTIGATION_VOLATILE = {"id", "timestamp", "started_at", "finished_at",
                          "latency_ms", "engine_latency_ms", "profile",
                          "logged_at"}
_FUSION_SUMMARY = (r"propagation over (\d+) services / (\d+) edges in "
                   r"[0-9.]+ ms on (?:cuda|cpu); top root cause: (.+)")


def _investigation_norm(obj):
    """``obj`` without the volatile keys, the fusion summary reduced to
    its counts and top cause (the device and the wall differ)."""
    import re

    if isinstance(obj, dict):
        out = {}
        for key, value in obj.items():
            if key in INVESTIGATION_VOLATILE:
                continue
            if key == "summary" and isinstance(value, str):
                m = re.fullmatch(_FUSION_SUMMARY, value)
                value = list(m.groups()) if m else value
            out[key] = _investigation_norm(value)
        return out
    if isinstance(obj, (list, tuple)):
        return [_investigation_norm(x) for x in obj]
    return obj


def _same_tree(got, want, path="$"):
    """The first path where two normalized outputs differ (a ``score``
    within 1e-4, other floats within rel 1e-5 / abs 1e-6), or None."""
    import math

    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            return path
        for key in want:
            if key == "score" and isinstance(want[key], float):
                if abs(got[key] - want[key]) > 1e-4:
                    return f"{path}.{key}"
                continue
            bad = _same_tree(got[key], want[key], f"{path}.{key}")
            if bad:
                return bad
        return None
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return path
        for i, (g, w) in enumerate(zip(got, want)):
            bad = _same_tree(g, w, f"{path}[{i}]")
            if bad:
                return bad
        return None
    if isinstance(want, float) and isinstance(got, float):
        return None if math.isclose(got, want, rel_tol=1e-5,
                                    abs_tol=1e-6) else path
    return None if got == want else path


def _first_pod_finding(results):
    for agent in ("resources", "logs", "events", "metrics", "traces",
                  "topology"):
        for f in results.get(agent, {}).get("findings", []):
            if str(f.get("component", "")).startswith("Pod/"):
                return f
    return None


def _suggestion_actions(top, pod_finding):
    """The five suggestion types, aimed at the top root cause and the
    first pod-level finding."""
    kind, _, name = top["findings"][0]["component"].partition("/")
    pod = (pod_finding["component"].partition("/")[2] if pod_finding
           else top["component"])
    return {
        "run_agent": {"type": "run_agent", "agent_type": "comprehensive"},
        "check_resource": {"type": "check_resource", "kind": kind or "Pod",
                           "name": name},
        "check_logs": {"type": "check_logs", "pod_name": pod,
                       "previous": True, "tail_lines": 50},
        "check_events": {"type": "check_events", "kind": "Pod",
                         "name": pod},
        "query": {"type": "query",
                  "query": f"what broke {top['component']}?"},
    }


def _investigation(coord, ns, launches=None):
    """One scripted investigation: a comprehensive analysis, the guided
    hypothesis workflow on the top root cause's first finding and on the
    first pod-level finding, a chat turn, then the five suggestion types
    (and every action the chat turn suggested), each followed by
    ``update_suggestions_after_action``.  ``launches`` (a dict) receives
    the kernel launches of the ``run_agent`` suggestion."""
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches

    out = {}
    rec = coord.run_analysis("comprehensive", ns)
    if rec["status"] != "completed":
        fail(f"investigation analysis {rec['status']}: {rec.get('error')}")
    out["analysis"] = rec
    top = rec["results"]["correlated"]["root_causes"][0]
    pod_finding = _first_pod_finding(rec["results"])
    out["workflow"] = []
    for finding in [top["findings"][0]] + [pod_finding] * bool(pod_finding):
        comp = finding["component"]
        hyps = coord.generate_hypotheses(comp, finding, ns, "inv-smoke")
        plan = coord.get_investigation_plan(hyps[0], ns)
        steps = [coord.execute_investigation_step(step, hyps[0], ns,
                                                  "inv-smoke")
                 for step in plan["steps"]]
        report = coord.generate_root_cause_report({
            "component": comp, "accepted_hypothesis": hyps[0],
            "steps": steps, "finding": finding})
        out["workflow"].append({"hypotheses": hyps, "plan": plan,
                                "steps": steps, "report": report})
    chat = coord.process_user_query(
        "why is the top service down?", ns,
        previous_findings=[f"{top['component']} is {top['severity']}"])
    out["chat"] = chat
    actions = list(_suggestion_actions(top, pod_finding).values())
    out["suggestions"] = []
    for action in actions + [s["action"] for s in chat["suggestions"]]:
        if launches is not None and action is actions[0]:
            reset_launches()
            res = coord.process_suggestion(action, ns)
            launches.update(LAUNCHES)
        else:
            res = coord.process_suggestion(action, ns)
        fresh = coord.update_suggestions_after_action(action, res, ns)
        taken = _dumps(action)
        if any(_dumps(f.get("action", {})) == taken for f in fresh):
            fail(f"the taken action {action} came back as a follow-up")
        out["suggestions"].append({"action": action, "result": res,
                                   "after": fresh})
    return out


def investigate_phase(smi: str) -> dict:
    """The investigation layer on the card over
    ``synthetic_cascade_world(2047, n_roots=3, seed=0)``: a coordinator on
    ``cuda`` with the offline provider, an ``EvidenceLogger`` and a
    ``PromptLogger`` in a temporary directory runs :func:`_investigation`
    (the comprehensive analysis, the hypothesis workflow with its report,
    a chat turn, the five suggestion types and the regenerated
    follow-ups), then the same analysis with ``use_llm_agents=True``;
    each output equals the same sequence run by the port on the CPU once
    the volatile keys are gone (ids, clocks, ``latency_ms``, ``profile``;
    the fusion summary's device and wall), and so do the evidence files;
    the top root cause is an injected root, and the ``run_agent``
    suggestion launches the main path's counts.  Each
    stage's host wall, median of 5.  Then the store on the serve plane:
    ``python -m rca_tpu_torch chat --investigation new`` over ``--fixture
    50svc`` makes an investigation, one explained request naming it goes
    through ``ServeLoop(store=...)`` on the card and its provenance must
    land in the store; ``suggest`` and ``report --out`` (started with
    ``chat``), then ``investigations`` and ``why`` (started together)
    run as subprocesses and exit 0, and ``why`` prints the blame tree of
    the stored provenance."""
    import shutil
    import tempfile

    import torch
    from rca_tpu_torch.cluster.generator import synthetic_cascade_world
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
    from rca_tpu_torch.coordinator import RCACoordinator
    from rca_tpu_torch.features.extract import extract_features
    from rca_tpu_torch.graph.build import service_dependency_edges
    from rca_tpu_torch.llm import LLMClient, OfflineProvider
    from rca_tpu_torch.observability.causelens import render_blame_tree
    from rca_tpu_torch.obslog import EvidenceLogger, PromptLogger
    from rca_tpu_torch.serve import ServeLoop, ServeRequest
    from rca_tpu_torch.store import InvestigationStore
    from rca_tpu_torch.ui.render import report_markdown

    t_phase = time.perf_counter()
    procs: list = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_investigate_")
    out = {}
    try:
        ns = "synthetic"
        world = synthetic_cascade_world(2047, n_roots=3, seed=0)
        roots = world.ground_truth["fault_roots"]

        def coordinator(device, name, **kw):
            prompts = PromptLogger(os.path.join(tmp, name, "prompts"))
            return RCACoordinator(
                MockClusterClient(world), backend="torch", device=device,
                llm_client=LLMClient(provider=OfflineProvider(),
                                     log_fn=prompts.as_log_fn(
                                         namespace=ns)),
                evidence_logger=EvidenceLogger(
                    os.path.join(tmp, name, "evidence")), **kw), prompts

        card, card_prompts = coordinator(None, "card")
        if card.device.type != "cuda":
            fail(f"the investigation coordinator runs on {card.device}")
        cpu, _ = coordinator("cpu", "cpu")
        run_agent_launches = {}
        got = _investigation(card, ns, launches=run_agent_launches)
        torch.cuda.synchronize()
        want = _investigation(cpu, ns)
        for stage in want:
            bad = _same_tree(_investigation_norm(got[stage]),
                             _investigation_norm(want[stage]), stage)
            if bad:
                fail(f"the card's investigation differs from the CPU's "
                     f"at {bad}")
        top = got["analysis"]["results"]["correlated"]["root_causes"][0]
        if top["component"] not in roots:
            fail(f"the investigation's top cause {top['component']} is "
                 f"not an injected root {roots}")
        if run_agent_launches != main_launches(2047):
            fail(f"the run_agent suggestion launched {run_agent_launches}, "
                 f"want {main_launches(2047)}")
        files = {}
        for name in ("card", "cpu"):
            root = os.path.join(tmp, name, "evidence")
            files[name] = [
                (fn[15:], _investigation_norm(json.load(open(
                    os.path.join(root, fn)))))
                for fn in sorted(os.listdir(root), key=lambda f: f[15:])]
        if (len(files["card"]) != len(files["cpu"])
                or _same_tree(files["card"], files["cpu"])):
            fail("the card's evidence files differ from the CPU's")
        llm_card, _ = coordinator(None, "card_llm", use_llm_agents=True)
        llm_cpu, _ = coordinator("cpu", "cpu_llm", use_llm_agents=True)
        llm_got = llm_card.run_analysis("comprehensive", ns)
        llm_want = llm_cpu.run_analysis("comprehensive", ns)
        if llm_got["status"] != "completed":
            fail(f"the LLM-agent analysis {llm_got['status']}")
        bad = _same_tree(_investigation_norm(llm_got),
                         _investigation_norm(llm_want), "llm_agents")
        if bad:
            fail(f"the LLM-agent analysis differs from the CPU's at {bad}")

        # each stage's host wall on the card, median of 5
        actions = _suggestion_actions(top, _first_pod_finding(
            got["analysis"]["results"]))
        finding = top["findings"][0]

        def workflow():
            hyps = card.generate_hypotheses(finding["component"], finding,
                                            ns, "inv-smoke")
            plan = card.get_investigation_plan(hyps[0], ns)
            steps = [card.execute_investigation_step(st, hyps[0], ns,
                                                     "inv-smoke")
                     for st in plan["steps"]]
            card.generate_root_cause_report({
                "component": finding["component"],
                "accepted_hypothesis": hyps[0], "steps": steps,
                "finding": finding})

        walls = {
            "hypothesis_workflow": host_ms(workflow, reps=5),
            "chat_turn": host_ms(lambda: card.process_user_query(
                "why is the top service down?", ns), reps=5),
            **{f"suggest_{kind}": host_ms(
                lambda a=action: card.process_suggestion(a, ns), reps=5)
               for kind, action in actions.items()},
            "report": host_ms(lambda: report_markdown(card.run_analysis(
                "comprehensive", ns)["results"]), reps=5),
        }
        out["2047"] = {
            "top": top["component"], "fault_roots": roots,
            "run_agent_launches": run_agent_launches,
            "suggestions": len(got["suggestions"]),
            "hypotheses": sum(len(w["hypotheses"])
                              for w in got["workflow"]),
            "steps": sum(len(w["steps"]) for w in got["workflow"]),
            "evidence_files": len(files["card"]),
            "prompt_records": len(card_prompts.read_all()),
            "card_equal_cpu": True, "llm_agents_equal_cpu": True,
            "host_ms": walls}
        phase("investigate", services=2047, smi=smi, **out["2047"])

        # the store on the serve plane, and the commands: the ones that
        # need nothing of each other start together, so their start-ups
        # (interpreter, torch, a CUDA context, the library) overlap
        log_dir = os.path.join(tmp, "store")

        def start(*argv):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "rca_tpu_torch", *argv,
                 "--log-dir", log_dir], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
            return argv[0], procs[-1]

        def cli(started):
            name, proc = started
            out, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                fail(f"python -m rca_tpu_torch {name} exited "
                     f"{proc.returncode}: {err[-2000:]}")
            return out

        t0 = time.perf_counter()
        report_path = os.path.join(tmp, "report.md")
        started = {
            "chat": start("chat", "--fixture", "50svc", "--compact",
                          "--investigation", "new",
                          "why is the top service down?"),
            "suggest": start(
                "suggest", "--fixture", "50svc", "--compact",
                json.dumps({"type": "run_agent",
                            "agent_type": "comprehensive"})),
            "report": start("report", "--fixture", "50svc", "--out",
                            report_path)}
        chat = json.loads(cli(started["chat"]))
        iid = chat["investigation_id"]
        world50 = synthetic_cascade_world(50, n_roots=1, seed=0)
        snap = ClusterSnapshot.capture(MockClusterClient(world50), ns)
        fs = extract_features(snap)
        src, dst = service_dependency_edges(snap, fs)
        store = InvestigationStore(root=log_dir)
        loop = ServeLoop(store=store).start()
        try:
            req = ServeRequest(tenant="investigate",
                               features=fs.service_features, dep_src=src,
                               dep_dst=dst, names=fs.service_names, k=5,
                               explain=True, investigation_id=iid)
            loop.submit(req)
            resp = req.result(300.0)
        finally:
            loop.stop()
        if resp.status != "ok" or not resp.provenance or \
                "error" in resp.provenance:
            fail(f"the explained serve request: {resp.status} "
                 f"{resp.detail} {resp.provenance}")
        stored = store.get_investigation(iid)
        if _dumps(stored.get("provenance")) != _dumps(json.loads(
                json.dumps(resp.provenance))):
            fail("the served provenance did not land in the store")
        if not any(m["role"] == "serve" for m in stored["conversation"]):
            fail("the serve note did not land in the store")
        suggested = json.loads(cli(started["suggest"]))
        written = json.loads(cli(started["report"]))
        with open(report_path) as f:
            if not f.read().startswith("# Root Cause Analysis Report"):
                fail("report --out wrote no report")
        started["investigations"] = start("investigations")
        started["why"] = start("why", iid)
        listed = json.loads(cli(started["investigations"]))
        if [row["id"] for row in listed] != [iid]:
            fail(f"investigations listed {listed}")
        why = cli(started["why"])
        tree = render_blame_tree(stored["provenance"])
        if tree not in why or not why.startswith(f"investigation {iid}"):
            fail(f"why did not print the stored blame tree: {why[:500]}")
        out["commands"] = {
            "investigation_id": iid, "chat_top": chat["key_findings"][:1],
            "suggest_points": suggested["response"]["points"][:1],
            "report_bytes": written["bytes"],
            "served_top": resp.ranked[0]["component"],
            "why_lines": why.count("\n"),
            "seconds": time.perf_counter() - t0}
        phase("investigate", leg="store and commands", **out["commands"])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    phase("investigate", seconds=out["seconds"])
    return out


#: the gateway phase: the clients of its first load, the body cap of the
#: 49,999-service gateway and its requests, and the committed certificate
#: pair its TLS request uses
GATEWAY_THREADS = 16
GATEWAY_BIG_CAP = 32 << 20
GATEWAY_BIG_REQUESTS = 4
GATEWAY_CERT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures", "gateway_cert.pem")
GATEWAY_KEY = os.path.join(os.path.dirname(GATEWAY_CERT), "gateway_key.pem")


def _closed_loop(items, send, threads: int) -> tuple:
    """``send(i, item)`` for every item by ``threads`` closed-loop clients
    (client ``w`` sends items ``w``, ``w + threads``, ...): the answers in
    item order, each request's wall in ms (submit to answer) and the whole
    load's wall in s."""
    from rca_tpu_torch.util.threads import make_thread

    answers = [None] * len(items)
    walls = [0.0] * len(items)

    def client(w: int) -> None:
        for i in range(w, len(items), threads):
            t0 = time.perf_counter()
            answers[i] = send(i, items[i])
            walls[i] = (time.perf_counter() - t0) * 1e3

    ts = [make_thread(client, name=f"smoke-gateway-{w}", daemon=True,
                      args=(w,)) for w in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    if any(t.is_alive() for t in ts):
        fail("a gateway client did not finish within 600 s")
    return answers, walls, time.perf_counter() - t0


def _quantiles(walls) -> dict:
    import numpy as np

    return {q: float(np.percentile(walls, p, method="nearest"))
            for q, p in (("p50_ms", 50), ("p99_ms", 99))}


def _wire_ok(label, code, body, want_ranked) -> None:
    """One wire answer: 200, ``ok``, not degraded, ranked as ``want``."""
    if code != 200 or body.get("status") != "ok" or body.get("degraded"):
        fail(f"gateway ({label}): HTTP {code}, {body.get('status')}, "
             f"degraded {body.get('degraded')}: {body.get('detail')}")
    if body["ranked"] != want_ranked:
        fail(f"gateway ({label}): the wire ranking differs from its "
             f"in-process answer")


def _raw_http(host, port, method, path, body=None, headers=None,
              declared=None):
    """One plain HTTP request: ``(status, json body, headers)``.  With
    ``declared`` only the headers go out, ``Content-Length`` set to it."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=120)
    try:
        if declared is None:
            conn.request(method, path, body=body, headers=headers or {})
        else:
            conn.putrequest(method, path)
            for key, value in (headers or {}).items():
                conn.putheader(key, value)
            conn.putheader("Content-Length", str(declared))
            conn.endheaders()
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read()), dict(resp.getheaders())
    finally:
        conn.close()


def gateway_phase(engine, cases, shapes, smi: str, cli=()) -> dict:
    """The wire front door on the card (``rca_tpu_torch.gateway``), every
    request served in a device batch of the plane's kernels:

    - 2047 services: ``GatewayServer(ServeLoop(engine))`` takes a
      concurrency-16 load over 4 tenants, then the serve phase's 64-request
      mix over the wire and in process, in turns; every wire ranking equals
      its in-process answer and its solo card analysis, every device batch
      launches the main path's counts, nothing is degraded, the registry
      row is ``kernels`` (``/metrics`` names it), ``/v1/subscribe`` gets
      every wire response; the wire and in-process latencies and the JSON
      codec's host ms per request;
    - 49,999 services: a gateway with ``max_body`` 32 MiB serves 4
      requests, each bitwise its solo analysis at the main path's counts
      per batch; the 15.4 MB request to a default-cap gateway gets 413
      with no device batch, launch or queue entry;
    - the front door: 429 with ``Retry-After`` from a saturated queue of
      cap 1, 503 from a shed deadline, 400, 404, ``/healthz`` 200 then 503
      once the plane stops, ``?explain=1`` and ``/v1/explain/<trace_id>``,
      one TLS request with a bearer token bitwise the plain answer;
    - ``python -m rca_tpu_torch serve --listen`` in a subprocess (16
      requests bitwise in process, exit 0 on SIGTERM) and the ``canary``
      command: ``--mode both`` exits 0, a perturbed decay exits 1 naming
      the bisected tick, ``--listen-url`` against the subprocess's gateway
      mints a recording that replays bitwise, ``--mode multicluster``
      exits 0.

    ``cli`` is appended to every command line run here."""
    import shutil
    import signal
    import tempfile

    import numpy as np
    from rca_tpu_torch.config import ServeConfig
    from rca_tpu_torch.engine.registry import get_registry
    from rca_tpu_torch.gateway import (
        GatewayClient,
        GatewayServer,
        decode_analyze,
        encode_analyze,
    )
    from rca_tpu_torch.kernels import LAUNCHES
    from rca_tpu_torch.observability.spans import TRACE_HEADER, Tracer
    from rca_tpu_torch.resilience.policy import drain_faults
    from rca_tpu_torch.serve import ServeClient, ServeLoop, ServeRequest
    from rca_tpu_torch.util.threads import make_thread

    t_phase = time.perf_counter()
    small, big = TIERS[0][0], TIERS[-1][0]
    rng = np.random.default_rng(1515)
    out = {"nvidia_smi": smi, "per_batch": {}}
    drain_faults()
    solo_cache = {}

    def solo(f, c):
        key = (id(c), f.tobytes())
        if key not in solo_cache:
            solo_cache[key] = engine.analyze_arrays(
                f, c.dep_src, c.dep_dst, c.names, k=SERVE_K).ranked
        return solo_cache[key]

    def perturbed(c, count):
        return [np.clip(c.features + rng.uniform(0, 0.05, c.features.shape),
                        0, 1).astype(np.float32) for _ in range(count)]

    def plane(c, counted=True, tracer=None):
        """A ServeLoop over ``engine`` warmed on ``c``'s graph (one device
        batch), each later batch counted and sync-checked unless
        ``counted`` is false."""
        loop = ServeLoop(engine=engine, config=ServeConfig(
            max_batch=16, queue_cap=4 * SERVE_REQUESTS), tracer=tracer)
        warm = ServeRequest("warm", c.features, c.dep_src, c.dep_dst,
                            k=SERVE_K)
        loop.dispatcher.fetch(loop.dispatcher.dispatch([warm]))
        log: list = []
        if counted:
            _counting_dispatch(loop.dispatcher, log)
        return loop, log

    def batches_ok(log, n, label):
        want = main_launches(n)
        for e in log:
            if e["launches"] != want:
                fail(f"gateway ({label}): a device batch of {e['width']} "
                     f"launched {e['launches']}, not {want}")
        out["per_batch"][str(n)] = want
        return {"device_batches": len(log),
                "mean_width": float(np.mean([e["width"] for e in log])),
                "delta_batches": sum(1 for e in log if e["delta"]),
                "launches": {k: sum(e["launches"][k] for e in log)
                             for k in want}}

    def codec_ms(c, f, reps):
        body = encode_analyze(f, c.dep_src, c.dep_dst, names=c.names,
                              k=SERVE_K)
        payload = json.dumps(body)
        loaded = json.loads(payload)
        return {
            "body_bytes": len(payload.encode()),
            "encode_analyze_ms": host_ms(lambda: encode_analyze(
                f, c.dep_src, c.dep_dst, names=c.names, k=SERVE_K),
                reps=reps),
            "json_dumps_ms": host_ms(lambda: json.dumps(body), reps=reps),
            "json_loads_ms": host_ms(lambda: json.loads(payload), reps=reps),
            "decode_analyze_ms": host_ms(lambda: decode_analyze(loaded),
                                         reps=reps),
        }, payload

    # -- 2047 services: the loads -------------------------------------------
    case = cases[small]
    loop, log = plane(case)
    loop.start()
    try:
        with GatewayServer(loop, port=0) as gw:
            cl = GatewayClient(gw.host, gw.port, timeout_s=300)
            inproc = ServeClient(loop)
            feats = perturbed(case, 2 * GATEWAY_THREADS)
            answers, walls, wall_s = _closed_loop(
                feats, lambda i, f: cl.analyze(
                    f, case.dep_src, case.dep_dst, names=case.names,
                    tenant=f"tenant-{'abcd'[i % 4]}", k=SERVE_K),
                GATEWAY_THREADS)
            for i, (f, (code, body, _)) in enumerate(zip(feats, answers)):
                _wire_ok(f"concurrency {GATEWAY_THREADS}, request {i}", code,
                         body, solo(f, case))
                resp = inproc.analyze(f, case.dep_src, case.dep_dst,
                                      names=case.names, tenant="oracle",
                                      k=SERVE_K, timeout_s=300)
                if not resp.ok or resp.ranked != body["ranked"]:
                    fail(f"gateway: request {i} in process ranks otherwise")
            row = {"requests": len(feats), "clients": GATEWAY_THREADS,
                   "wall_s": wall_s, **_quantiles(walls)}
            phase("gateway", services=small, load="concurrency", smi=smi,
                  **row)
            out["concurrency"] = row

            # the serve phase's mix, over the wire and in process, in turns;
            # the subscription takes every wire response
            items = _serve_features(case, rng)
            events: list = []
            sub = make_thread(lambda: events.extend(cl.subscribe(
                max_events=2 * len(items), idle_s=120.0, timeout_s=600.0)),
                name="smoke-gateway-subscriber", daemon=True)
            sub.start()
            for _ in range(400):
                if gw.hub.subscriber_count():
                    break
                time.sleep(0.01)
            turns = {"wire": [], "in_process": []}
            walls_s = {"wire": [], "in_process": []}
            wire_ids = []
            for label in ("wire", "in_process", "in_process", "wire"):
                if label == "wire":
                    answers, walls, wall_s = _closed_loop(
                        items, lambda i, f: cl.analyze(
                            f, case.dep_src, case.dep_dst, names=case.names,
                            tenant=f"tenant-{'abcd'[i % 4]}", k=SERVE_K), 4)
                    for i, (f, (code, body, _)) in enumerate(
                            zip(items, answers)):
                        _wire_ok(f"mix, request {i}", code, body,
                                 solo(f, case))
                        wire_ids.append(body["request_id"])
                else:
                    answers, walls, wall_s = _closed_loop(
                        items, lambda i, f: inproc.submit(
                            f, case.dep_src, case.dep_dst, names=case.names,
                            tenant=f"tenant-{'abcd'[i % 4]}",
                            k=SERVE_K).result(300), 4)
                    for i, (f, resp) in enumerate(zip(items, answers)):
                        if not resp.ok or resp.ranked != solo(f, case):
                            fail(f"gateway: in-process mix request {i} "
                                 f"{resp.status} or ranked otherwise")
                turns[label] += walls
                walls_s[label].append(wall_s)
            sub.join(300)
            if sub.is_alive() or sorted(e["request_id"] for e in events) \
                    != sorted(wire_ids):
                fail(f"gateway: the subscription got {len(events)} of "
                     f"{len(wire_ids)} wire responses")
            metrics = cl.metrics_text()
            for needle in ('rca_serve_requests_total{outcome="answered",'
                           'tenant="tenant-a"}',
                           f'kernel="kernels",n_pad="{shapes[small][0]}"'):
                if needle not in metrics:
                    fail(f"gateway: /metrics does not name {needle}")
        row = get_registry().resolve(*shapes[small], device=engine.device)
        if row.winner != "kernels":
            fail(f"gateway: the registry row at {small}: {row.to_dict()}")
    finally:
        loop.stop()
    codec, _ = codec_ms(case, items[0], reps=20)
    mix = {
        "requests": len(items), "clients": 4, "turns": 2,
        "wire": {**_quantiles(turns["wire"]), "wall_s": walls_s["wire"]},
        "in_process": {**_quantiles(turns["in_process"]),
                       "wall_s": walls_s["in_process"]},
        "subscribed_events": len(events), "codec": codec,
        **batches_ok(log, small, f"{small} services")}
    mix["wire_overhead_p50_ms"] = mix["wire"]["p50_ms"] - mix[
        "in_process"]["p50_ms"]
    phase("gateway", services=small, load="mix", smi=smi, **mix)
    out["2047"] = mix

    # -- 49,999 services: a raised body cap, and the default cap's 413 ----
    case = cases[big]
    loop, log = plane(case)
    loop.start()
    try:
        with GatewayServer(loop, port=0, max_body=GATEWAY_BIG_CAP) as gw, \
                GatewayServer(loop, port=0) as capped:
            cl = GatewayClient(gw.host, gw.port, timeout_s=600)
            feats = perturbed(case, GATEWAY_BIG_REQUESTS)
            answers, walls, wall_s = _closed_loop(
                feats, lambda i, f: cl.analyze(
                    f, case.dep_src, case.dep_dst, names=case.names,
                    tenant=f"tenant-{'abcd'[i % 4]}", k=SERVE_K),
                GATEWAY_BIG_REQUESTS)
            for i, (f, (code, body, _)) in enumerate(zip(feats, answers)):
                _wire_ok(f"{big} services, request {i}", code, body,
                         solo(f, case))
            codec, payload = codec_ms(case, feats[0], reps=3)
            served = batches_ok(log, big, f"{big} services")
            before = (loop.device_batches, len(loop.queue), dict(LAUNCHES))
            status, body, _ = _raw_http(
                capped.host, capped.port, "POST", "/v1/analyze",
                headers={"Content-Type": "application/json"},
                declared=len(payload.encode()))
            after = (loop.device_batches, len(loop.queue), dict(LAUNCHES))
            if status != 413 or "RCA_GATEWAY_MAX_BODY" not in body["detail"] \
                    or after != before or capped.metrics.snapshot()[
                        "body_rejections"] != 1:
                fail(f"gateway: the default cap answered {status} "
                     f"({body.get('detail')}); batches, queue and launches "
                     f"{before[:2]} -> {after[:2]}")
    finally:
        loop.stop()
    row = {"requests": len(feats), "clients": len(feats),
           "max_body": GATEWAY_BIG_CAP, "wall_s": wall_s, **_quantiles(walls),
           "codec": codec, "default_cap_status": status,
           "default_cap": capped.max_body, **served}
    phase("gateway", services=big, load="raised cap", smi=smi, **row)
    out["49999"] = row

    # -- the front door ------------------------------------------------------
    case = cases[small]
    f = items[1]
    body_bytes = json.dumps(encode_analyze(
        f, case.dep_src, case.dep_dst, names=case.names, k=SERVE_K)).encode()
    door = {}
    # spans on, so an explained answer is kept under its trace id
    loop, _ = plane(case, counted=False, tracer=Tracer(seed=11))
    loop.start()
    try:
        with GatewayServer(loop, port=0) as gw, GatewayServer(
                loop, port=0, tls=(GATEWAY_CERT, GATEWAY_KEY),
                tokens={"smoke-token": ("tls-tenant", None)}) as tls_gw:
            cl = GatewayClient(gw.host, gw.port, timeout_s=300)
            code, plain, _ = cl.analyze(f, case.dep_src, case.dep_dst,
                                        names=case.names, k=SERVE_K)
            _wire_ok("plain", code, plain, solo(f, case))
            code, secure, _ = GatewayClient(
                tls_gw.host, tls_gw.port, tls=True, ca_file=GATEWAY_CERT,
                token="smoke-token", timeout_s=300).analyze(
                f, case.dep_src, case.dep_dst, names=case.names, k=SERVE_K)
            _wire_ok("TLS with a bearer token", code, secure,
                     plain["ranked"])
            if secure["tenant"] != "tls-tenant":
                fail(f"gateway: the token bound {secure['tenant']}")
            status, explained, hdrs = _raw_http(
                gw.host, gw.port, "POST", "/v1/analyze?explain=1",
                body=body_bytes,
                headers={"Content-Type": "application/json"})
            _wire_ok("?explain=1", status, explained, plain["ranked"])
            trace_id = explained.get("trace_id")
            if not explained.get("provenance") or not trace_id or \
                    not hdrs.get(TRACE_HEADER, "").startswith(trace_id):
                fail("gateway: ?explain=1 carried no provenance or trace")
            status, kept, _ = _raw_http(gw.host, gw.port, "GET",
                                        f"/v1/explain/{trace_id}")
            if status != 200 or kept["provenance"] != explained["provenance"]:
                fail(f"gateway: /v1/explain/{trace_id} answered {status}")
            door.update(tls=True, explain=True)
            for label, argv in (
                    ("400", ("POST", "/v1/analyze", b"{not json",
                             {"Content-Type": "application/json"})),
                    ("404", ("GET", "/v1/nope", None, None))):
                status = _raw_http(gw.host, gw.port, *argv)[0]
                if str(status) != label:
                    fail(f"gateway: {label} case answered {status}")
                door[label] = status
            if cl.healthz()[0] != 200:
                fail("gateway: /healthz on a running plane is not 200")
            loop.stop()
            code, health = cl.healthz()
            if code != 503 or not health.get("stopped"):
                fail(f"gateway: /healthz after the plane stopped: {code}")
            door["healthz"] = [200, code]
    finally:
        loop.stop()
    # backpressure on a queue of cap 1 that one request holds (the loop is
    # not started, so it stays full) and a deadline already past
    loop = ServeLoop(engine=engine, config=ServeConfig(queue_cap=1))
    loop.submit(ServeRequest("holder", case.features, case.dep_src,
                             case.dep_dst))
    with GatewayServer(loop, port=0) as gw:
        cl = GatewayClient(gw.host, gw.port, timeout_s=60)
        for label, kw in (("429", {}), ("503", {"deadline_ms": -1.0})):
            code, body, hdrs = cl.analyze(f, case.dep_src, case.dep_dst,
                                          k=SERVE_K, **kw)
            if str(code) != label or int(hdrs.get("Retry-After", 0)) < 1 \
                    or "X-RCA-Retry-After-Ms" not in hdrs:
                fail(f"gateway: the {label} case answered {code} "
                     f"({body.get('status')}) with {hdrs}")
            door[label] = {"status": body["status"],
                           "retry_after": hdrs["Retry-After"],
                           "retry_after_ms": hdrs["X-RCA-Retry-After-Ms"]}
    loop.queue.pop()
    phase("gateway", leg="front door", **door)
    out["front_door"] = door
    faults = drain_faults()
    if any(not f["op"].startswith("gateway.") for f in faults):
        fail(f"gateway: faults recorded: {faults}")

    # -- serve --listen and the canary, as commands --------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gateway_")
    cmd = [sys.executable, "-m", "rca_tpu_torch"]
    canary = [*cmd, "canary", "--fixture", "20svc", "--rounds", "1",
              "--no-store", "--compact"]
    t0 = time.perf_counter()
    procs = {}
    serve = None
    try:
        for label, argv in (("both", ["--mode", "both"]),
                            ("perturbed", ["--candidate-decay", "0.5"]),
                            ("multicluster", ["--mode", "multicluster"])):
            procs[label] = subprocess.Popen(
                [*canary, "--out", os.path.join(tmp, label), *argv, *cli],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        serve = subprocess.Popen(
            [*cmd, "serve", "--listen", "127.0.0.1:0", "--max-batch", "8",
             "--log-dir", os.path.join(tmp, "logs"), *cli],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        banner: list = []
        reader = make_thread(lambda: banner.append(serve.stdout.readline()),
                             name="smoke-gateway-banner", daemon=True)
        reader.start()
        reader.join(300)
        if not banner or not banner[0]:
            fail("serve --listen printed no banner within 300 s")
        info = json.loads(banner[0])
        if info["endpoints"] != ["/v1/analyze", "/v1/subscribe",
                                 "/v1/traces", "/metrics", "/healthz"]:
            fail(f"serve --listen banner: {info}")
        host, port = info["listening"].rsplit(":", 1)
        cl = GatewayClient(host, int(port), timeout_s=300)
        feats = perturbed(case, 16)
        answers, walls, _ = _closed_loop(
            feats, lambda i, f: cl.analyze(
                f, case.dep_src, case.dep_dst, names=case.names,
                tenant=f"t{i % 4}", k=SERVE_K), 16)
        for i, (f, (code, body, _)) in enumerate(zip(feats, answers)):
            _wire_ok(f"serve --listen, request {i}", code, body,
                     solo(f, case))
        listened = subprocess.run(
            [*canary, "--out", os.path.join(tmp, "listen"), "--listen-url",
             f"http://{host}:{port}", "--requests", "4", *cli],
            capture_output=True, text=True, timeout=600)
        serve.send_signal(signal.SIGTERM)
        _, err = serve.communicate(timeout=120)
        if serve.returncode != 0:
            fail(f"serve --listen exited {serve.returncode} on SIGTERM: "
                 f"{err[-2000:]}")
        reports = {"listen": (listened.returncode, listened.stdout,
                              listened.stderr)}
        for label, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            reports[label] = (p.returncode, stdout, stderr)
    finally:
        for p in [*procs.values(), serve]:
            if p is not None and p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    commands = {"serve_listen": {"requests": len(feats),
                                 **_quantiles(walls), "exit": 0}}
    for label, (rc, stdout, stderr) in reports.items():
        want_rc = 1 if label == "perturbed" else 0
        if rc != want_rc:
            fail(f"canary ({label}) exited {rc}, not {want_rc}: "
                 f"{stderr[-2000:]}")
        report = json.loads(stdout)
        recs = report["recordings"]
        if label == "perturbed":
            tick = (report["first_divergence"] or {}).get("tick")
            if not isinstance(tick, int):
                fail(f"canary (perturbed) named no tick: {report}")
            commands[label] = {"exit": rc, "tick": tick,
                               "probes": recs[0].get("probes")}
        else:
            if not report["ok"] or not recs or not all(
                    r["parity_ok"] for r in recs) or (
                    label == "listen" and report["mode"] != "gateway"):
                fail(f"canary ({label}): {report}")
            commands[label] = {"exit": rc, "recordings": [
                {k: r.get(k) for k in ("mode", "ticks", "requests")}
                for r in recs]}
    commands["seconds"] = time.perf_counter() - t0
    phase("gateway", leg="commands", **commands)
    out["commands"] = commands
    out["seconds"] = time.perf_counter() - t_phase
    phase("gateway", seconds=out["seconds"])
    return out


SHARD_SP = 4
#: the lanes the shard recursions are checked over: one analysis (flat
#: vectors), a hypothesis batch and the widest serve batch
SHARD_LANES = (1, 8, 16)
#: the node-sharded engine's kernels, their sources and the TPU kernel each
#: one replaces: the per-shard entries (the ``step`` form's, and the
#: contrast), the recursions over every shard of one card and the
#: recursions over distinct cards
SHARD_SOURCES = {
    "seg_up_step": ("rca_tpu_torch/csrc/segstep.cu",
                    "rca_tpu/parallel/sharded.py:252 (pallas_segscan_max "
                    "per shard, pl.pallas_call rca_tpu/engine/segscan.py:"
                    "128)"),
    "seg_down_step": ("rca_tpu_torch/csrc/segstep.cu",
                      "rca_tpu/parallel/sharded.py:285 (pallas_segscan per "
                      "shard, pl.pallas_call rca_tpu/engine/segscan.py:"
                      "128)"),
    "seg_contrast_step": ("rca_tpu_torch/csrc/segstep.cu",
                          "rca_tpu/parallel/sharded.py:227-232 (the "
                          "per-block contrast, beside the Pallas scans of "
                          ":245-297)"),
    "seg_up_steps_shard": ("rca_tpu_torch/csrc/segshard.cu",
                           "rca_tpu/parallel/sharded.py:252 (pallas_segscan"
                           "_max per shard, 8 steps under lax.scan :246-254,"
                           " pl.pallas_call rca_tpu/engine/segscan.py:128)"),
    "seg_down_steps_shard": ("rca_tpu_torch/csrc/segshard.cu",
                             "rca_tpu/parallel/sharded.py:285 (pallas_segscan"
                             " per shard, 8 steps under lax.scan :280-289, "
                             "pl.pallas_call rca_tpu/engine/segscan.py:128)"),
    "evidence_front_shard": ("rca_tpu_torch/csrc/frontshard.cu",
                             "rca_tpu/parallel/sharded.py:225-242 (the "
                             "per-device front: the noisy-OR pair, the "
                             "dense path's pl.pallas_call rca_tpu/engine/"
                             "pallas_kernels.py:63; the e gather :234, the "
                             "masked scatter-max and fold_error_contrast "
                             ":235-239, the h / a gathers :241-242)"),
    "seg_up_steps_peer": ("rca_tpu_torch/csrc/segpeer.cu",
                          "rca_tpu/parallel/sharded.py:252 (pallas_segscan"
                          "_max per device between lax.all_gather over sp, "
                          "8 steps under lax.scan :246-254, pl.pallas_call "
                          "rca_tpu/engine/segscan.py:128)"),
    "seg_down_steps_peer": ("rca_tpu_torch/csrc/segpeer.cu",
                            "rca_tpu/parallel/sharded.py:285 (pallas_segscan"
                            " per device between lax.all_gather and "
                            "psum_scatter over sp, 8 steps under lax.scan "
                            ":280-289, pl.pallas_call rca_tpu/engine/"
                            "segscan.py:128)"),
}


#: the profile capture's world and length: BASELINE.md row 4's size, where
#: the plan runs the grid recursions
PROFILE_SERVICES = 10000
PROFILE_TICKS = 20
#: the cost model's and the bounds' tiers
COST_TIERS = (2047, 49999)
#: the cost families of /metrics
COST_FAMILIES = ("rca_kernel_cost_flops", "rca_kernel_cost_bytes_accessed",
                 "rca_kernel_peak_temp_bytes")
#: a closed recompile window's snapshot
CLOSED_WINDOW = {"enabled": False, "compiles": 0, "recompiles": 0,
                 "recompiles_post_warm": 0, "recompiled": []}


def _profile_capture(smi: str, device, cli=()) -> dict:
    """``python -m rca_tpu_torch profile`` at 10,000 services for 20 ticks
    in its own process, its Chrome trace parsed: 20 ``rca_tick`` ranges,
    the ``tick.dispatch`` / ``tick.fetch`` annotations of every tick, and
    the device kernels of the main path's grid plan, 1 + 1 + 1 a tick
    (``evidence_front_fused``, ``seg_up_steps_grid``,
    ``seg_down_steps_grid``), no other kernel of the port; then the same 20 polls unprofiled in this
    process, for the profiler's cost per tick."""
    import tempfile

    import numpy as np
    from rca_tpu_torch.cluster.generator import synthetic_cascade_world
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.engine import make_engine
    from rca_tpu_torch.engine.live import LiveStreamingSession
    from rca_tpu_torch.observability.profile import (
        KERNEL_SYMBOLS,
        device_kernel_counts,
    )
    from rca_tpu_torch.observability.spans import Tracer

    with tempfile.TemporaryDirectory(prefix="rca_profile_") as tmp:
        out_dir = os.path.join(tmp, "profile")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "rca_tpu_torch", "profile", "--services",
             str(PROFILE_SERVICES), "--ticks", str(PROFILE_TICKS), "--out",
             out_dir, "--compact", *cli], capture_output=True, text=True,
            timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"python -m rca_tpu_torch profile exited {proc.returncode}:"
                 f" {proc.stderr[-2000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        traces = [f for f in os.listdir(out_dir) if f.endswith(".json")]
        if len(traces) != 1:
            fail(f"profile: {len(traces)} trace files in {out_dir}")
        trace_bytes = os.path.getsize(os.path.join(out_dir, traces[0]))
        with open(os.path.join(out_dir, traces[0]), encoding="utf-8") as f:
            trace = json.load(f)
    spans = {name: [e["dur"] / 1e3 for e in trace["traceEvents"]
                    if e.get("name") == name
                    and e.get("cat") == "user_annotation"]
             for name in ("rca_tick", "tick.dispatch", "tick.fetch")}
    ranges = {name: len(durs) for name, durs in spans.items()}
    kernels = device_kernel_counts(trace)
    want = main_launches(PROFILE_SERVICES, PROFILE_TICKS)
    want = {name: want.get(name, 0) for name in KERNEL_SYMBOLS}
    got = {name: kernels[name] for name in KERNEL_SYMBOLS}
    if any(n != PROFILE_TICKS for n in ranges.values()):
        fail(f"profile: annotation ranges {ranges}, want {PROFILE_TICKS} "
             f"each")
    if got != want:
        fail(f"profile: device kernels {got}, want {want}")
    if summary["kernel_by_shape"] != {"10240": "kernels"} or \
            summary["device"] != "cuda" or summary["profile_files"] < 1:
        fail(f"profile: summary {summary}")

    # the same polls unprofiled, with a recording tracer as the capture's
    world = synthetic_cascade_world(PROFILE_SERVICES, n_roots=1, seed=7,
                                    namespace="profile")
    session = LiveStreamingSession(MockClusterClient(world), "profile", k=5,
                                   tracer=Tracer(),
                                   engine=make_engine(device=device))
    walls, captures = [], []
    for _ in range(PROFILE_TICKS):
        t0 = time.perf_counter()
        captures.append(session.poll()["capture_ms"])
        walls.append((time.perf_counter() - t0) * 1e3)
    plain_ms = float(np.mean(walls))
    out = {"services": PROFILE_SERVICES, "ticks": PROFILE_TICKS,
           "ranges": ranges, "device_kernels": kernels,
           "ms_per_tick": summary["ms_per_tick"],
           "unprofiled_ms_per_tick": plain_ms,
           # the profiled ranges' host ms (median), without the profiler's
           # start-up, and the unprofiled polls' walls and capture ms
           "range_ms_median": {name: float(np.median(durs))
                               for name, durs in spans.items()},
           "unprofiled_poll_ms": walls, "unprofiled_capture_ms": captures,
           "wall_ms": summary["wall_ms"],
           "spans_recorded": summary["spans_recorded"],
           "kernel_by_shape": summary["kernel_by_shape"],
           "trace_bytes": trace_bytes, "command_seconds": seconds,
           "card": smi}
    phase("observe_profile", **out)
    return out


def _cost_capture(cases, shapes, times, kin, smi: str, cli=()) -> dict:
    """``python -m rca_tpu_torch kernels`` at the two tiers' shapes with the
    cost capture up to 65,536 padded nodes: every dense row carries the
    model's ``flops`` and ``bytes_accessed`` (``basis`` ``"model"``) and
    the allocator's ``peak_temp_bytes``; the 2047 row's front and
    recursions move the bytes behind the ``times`` phase's bounds (the
    recursions' counted over the harness's long segments, not the
    cascade's: 4 bytes a long segment apart).  Prints the modelled bytes
    over 3.35 TB/s beside the row's measured ``t_win_ms``."""
    from rca_tpu_torch.kernels import cost

    cmd = [sys.executable, "-m", "rca_tpu_torch", "kernels", "--services",
           ",".join(str(n) for n in COST_TIERS), "--edges",
           ",".join(str(len(cases[n].dep_src)) for n in COST_TIERS),
           "--cost-max-pad", "65536", "--json", "--compact", *cli]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"kernels --cost-max-pad exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    rows = json.loads(proc.stdout)["rows"]
    out = {"rows": {}, "command_seconds": seconds, "card": smi}
    for n in COST_TIERS:
        n_pad, e_pad = shapes[n]
        row = next((r for r in rows if r["variant"] == "dense"
                    and (r["n_pad"], r["e_pad"]) == (n_pad, e_pad)), None)
        c = (row or {}).get("cost") or {}
        if row is None or row["winner"] != "kernels" or \
                c.get("basis") != "model" or not all(
                    c.get(key, 0) > 0 for key in (
                        "flops", "bytes_accessed", "peak_temp_bytes",
                        "output_bytes")):
            fail(f"kernels: the dense row at {n} has no measured cost: "
                 f"{row}")
        t_win = row["timings_ms"].get("kernels")
        out["rows"][str(n)] = {
            "n_pad": n_pad, "e_pad": e_pad, "source": row["source"],
            **{key: c.get(key) for key in ("flops", "bytes_accessed",
                                       "peak_temp_bytes", "output_bytes",
                                       "argument_bytes", "stages",
                                       "n_long")},
            "bytes_over_hbm_ms": c["bytes_accessed"]
            / cost.HBM_BYTES_PER_S * 1e3,
            "t_win_ms": t_win}
    # the 2047 row's front and recursions against the times phase's bounds
    row = out["rows"][str(COST_TIERS[0])]
    up_d, down_d, _ = kin[COST_TIERS[0]]["recursion"]
    tier_long = [int(up_d.long_ids.shape[0]), int(down_d.long_ids.shape[0])]
    t = times[COST_TIERS[0]]
    same = {
        "front": (row["stages"]["front"][0],
                  t["evidence_front_fused"]["bound"][2]),
        "up": (row["stages"]["up"][0] - 4 * row["n_long"][0],
               t["seg_up_steps"]["bound"][2] - 4 * tier_long[0]),
        "down": (row["stages"]["down"][0] - 4 * row["n_long"][1],
                 t["seg_down_steps"]["bound"][2] - 4 * tier_long[1]),
    }
    if any(a != b for a, b in same.values()):
        fail(f"kernels: the 2047 row's modelled bytes {same} differ from "
             f"the times phase's bounds")
    out["same_as_times"] = same
    out["tier_long"] = tier_long
    phase("observe_cost", **out)
    return out


def observe_phase(engine, cases, shapes, times, kin, smi: str,
                  cli=()) -> dict:
    """The port's instruments on the card: the ``profile`` capture
    (:func:`_profile_capture`), the registry's cost (:func:`_cost_capture`),
    a ``/metrics`` scrape that samples the three cost families without
    capturing anything, ``run_tracecheck()`` ``ok`` on every entry, and a
    serve loop whose recompile window closes when it stops.  ``cli``
    extends the two commands' arguments (``("--device", "cpu")`` rehearses
    the phase on the CPU, where its checks of the card fail)."""
    from rca_tpu_torch.analysis import run_tracecheck
    from rca_tpu_torch.engine.registry import get_registry, kernel_table
    from rca_tpu_torch.gateway import GatewayServer
    from rca_tpu_torch.gateway.client import GatewayClient
    from rca_tpu_torch.serve import ServeClient, ServeLoop

    out = {"profile": _profile_capture(smi, engine.device, cli),
           "cost": _cost_capture(cases, shapes, times, kin, smi, cli)}

    # the serve plane's /metrics after the dense rows' capture in this
    # process; then the loop stops and its window closes
    reg = get_registry()
    for n in COST_TIERS:
        reg.ensure_cost(reg.resolve(*shapes[n], device=engine.device))
    captured = sum(r["cost"] is not None for r in kernel_table())
    case = cases[COST_TIERS[0]]
    loop = ServeLoop(engine=engine).start()
    try:
        with GatewayServer(loop, port=0) as gw:
            client = ServeClient(loop)
            reqs = [client.submit(case.features, case.dep_src, case.dep_dst,
                                  names=case.names, tenant=f"t{i % 2}", k=5)
                    for i in range(8)]
            if any(r.result(120.0).status != "ok" for r in reqs):
                fail("observe: a served request was not ok")
            text = GatewayClient(gw.host, gw.port,
                                 timeout_s=120.0).metrics_text()
        scope = loop.kernelscope_summary()
    finally:
        loop.stop()
    closed = loop.recompile_monitor.snapshot()
    samples = {family: sum(1 for line in text.splitlines()
                           if line.startswith(family + "{"))
               for family in COST_FAMILIES}
    if not all(samples.values()):
        fail(f"observe: /metrics cost samples {samples}")
    if sum(r["cost"] is not None for r in kernel_table()) != captured:
        fail("observe: a /metrics scrape captured a cost")
    if not scope["enabled"] or scope["recompiles"] or closed != CLOSED_WINDOW \
            or loop.kernelscope_summary()["enabled"]:
        fail(f"observe: the serve loop's window: open {scope}, after stop "
             f"{closed}")
    out["metrics"] = {"cost_samples": samples, "captured_rows": captured}
    out["monitor"] = {"open": {key: scope[key] for key in CLOSED_WINDOW},
                      "closed": closed}
    phase("observe_metrics", **out["metrics"], monitor=out["monitor"])

    trace = run_tracecheck(device=engine.device)
    if not trace["ok"]:
        fail(f"tracecheck on the card: {trace}")
    out["tracecheck"] = trace
    phase("observe_tracecheck", ok=trace["ok"], entries={
        e["entry"]: {"warmup_compiles": e["warmup_compiles"],
                     "recompiles": e["recompiles"], "wall_ms": e["wall_ms"]}
        for e in trace["entries"]}, card=smi)
    return out


def _shard_launches(sp: int, form: str = "shard_grid", dp: int = 1) -> dict:
    """The kernel launches of one sharded analysis over ``dp`` rows of
    ``sp`` shards in the plan's ``form``: the front and each recursion
    once a row (``shard_grid``, every shard of the row on one card); the
    front's two halves once a shard and each recursion once a card
    (``peer``, one shard a card); or the front's two halves once a shard
    and 8 per-shard steps a shard (``step``)."""
    grid, peer = form == "shard_grid", form == "peer"
    return {"noisy_or_pair": 0, "segscan_sum": 0, "segscan_max": 0,
            "evidence_front": 0 if grid else dp * sp,
            "seg_contrast_step": 0 if grid else dp * sp,
            "seg_up_step": 0 if grid or peer else 8 * dp * sp,
            "seg_down_step": 0 if grid or peer else 8 * dp * sp,
            "seg_up_steps": 0, "seg_down_steps": 0,
            "evidence_front_fused": 0, **dict.fromkeys(GRID_KERNELS, 0),
            **dict.fromkeys(SHARD_KERNELS, dp if grid else 0),
            **dict.fromkeys(PEER_KERNELS, dp * sp if peer else 0)}


def _step_form():
    """Every sharded plan made in the ``step`` form, whatever its devices:
    the per-step composition on logical shards, the yardstick the
    ``shard_grid`` form is held to and timed beside."""
    return mock.patch("rca_tpu_torch.parallel.sharded.shard_steps_form",
                      lambda devices: "step")


def _hub_case(n: int, block: int, seed: int):
    """Edges of ``n`` services whose shard boundary cuts a hub: node
    ``block - 1``, the last of shard 0, has 3000 dependencies and 3000
    dependents spread over every shard, beside a random sparse graph."""
    import numpy as np

    rng = np.random.default_rng(seed)
    hub = block - 1
    src = np.concatenate([rng.integers(0, n, 2 * n), np.full(3000, hub),
                          rng.integers(0, n, 3000)])
    dst = np.concatenate([rng.integers(0, n, 2 * n), rng.integers(0, n, 3000),
                          np.full(3000, hub)])
    keep = src != dst
    return src[keep].astype(np.int32), dst[keep].astype(np.int32)


def _star_case(n: int, seed: int):
    """A star split across the shards: every service depends on node 5
    (one destination segment of about n / sp edges in each shard), and
    node 5 has 4096 dependencies drawn with repeats (one source segment of
    4096 edges in shard 0)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    others = np.setdiff1d(np.arange(n), [5])
    src = np.concatenate([others, np.full(4096, 5)])
    dst = np.concatenate([np.full(len(others), 5),
                          rng.choice(others, 4096)])
    return src.astype(np.int32), dst.astype(np.int32)


def sharded_phase(cases, shapes, profile_it: bool = False,
                  out_dir=None, rehearsal=None) -> dict:
    """The node-sharded engine on the card, over logical shards (a mesh
    whose device list repeats ``cuda:0``) and, with two cards or more,
    over distinct cards (:func:`multi_card_phase`; on one card the peer
    recursions' rehearsal, :func:`peer_rehearsal`, joined here): the
    per-shard kernel entries against their plain
    versions (the up-step and the contrast bitwise, the down-step at rtol
    1e-5 / atol 1e-6, each twice bitwise) over the tiers' layouts, a star
    split across the shards and a hub cut by a shard boundary;
    the shard recursions and the sharded front bitwise the per-shard
    composition they replace; ``ShardedGraphEngine`` at 2047 and 49,999
    services with ``sp = 4`` and at 49,999 with ``sp = 8``, restaged and
    resident, each analysis launching the front and each recursion once
    (``shard_grid``) and, in the ``step`` form, ``evidence_front`` /
    ``seg_contrast_step`` / ``seg_up_step`` / ``seg_down_step`` sp x 1 /
    1 / 8 / 8 times with its collectives moving the reference's round-5
    budget; ``a``, ``h`` and ``u`` bitwise
    the dense engine on the card, ``m`` and the score within rtol 1e-5 /
    atol 1e-6, top-3 identical, ``sanitized_rows`` identical on NaN/Inf
    rows, a second run bitwise, resident requests bitwise restaged;
    ``analyze_batch`` on ``dp = 2, sp = 2`` (B = 8) at 2047 against the
    dense batch; ``ShardedStreamingSession`` at 10,000 services, 30 ticks,
    against the dense session (rankings), its ``torch``-row twin (blocks
    bitwise), sync-free ``dispatch`` (also behind a sleep kernel); a live
    session over the 50-service fixture on a sharded engine, then its
    ladder from ``full`` to ``single-device``; the times."""
    import numpy as np
    import torch
    from rca_tpu_torch.cluster.generator import synthetic_cascade_world
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.engine import (
        GraphEngine,
        LiveStreamingSession,
        ShardedGraphEngine,
    )
    from rca_tpu_torch.engine.evidence import (
        evidence_front_rows,
        evidence_front_rows_plain,
        evidence_front_shard,
        evidence_front_shard_plain,
        seg_contrast_step_shard,
        seg_contrast_step_shard_plain,
    )
    from rca_tpu_torch.engine import segscan
    from rca_tpu_torch.engine.segscan import (
        down_seg_step_shard,
        down_seg_step_shard_plain,
        down_seg_steps_shard,
        down_seg_steps_shard_plain,
        down_shard_recursion,
        up_seg_step_shard,
        up_seg_step_shard_plain,
        up_seg_steps_shard,
        up_seg_steps_shard_plain,
        up_shard_recursion,
    )
    from rca_tpu_torch.engine.streaming import StreamingSession
    from rca_tpu_torch.features.schema import SvcF
    from rca_tpu_torch.kernels import (
        LAUNCHES,
        SHARD_LAUNCHES,
        cost,
        reset_launches,
    )
    from rca_tpu_torch.parallel import collectives
    from rca_tpu_torch.parallel.mesh import make_mesh
    from rca_tpu_torch.parallel.sharded import shard_plans, shard_steps_note
    from rca_tpu_torch.parallel.streaming import ShardedStreamingSession

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(808)

    def mesh(sp, dp=1, devices=None):
        return make_mesh([("dp", dp), ("sp", sp)],
                         devices or [dev] * (dp * sp))

    params = GraphEngine(device="cpu").params
    decay, weight = params.decay, params.error_contrast
    aw_d, hw_d = (torch.from_numpy(np.asarray(w)).to(dev)
                  for w in params.weight_arrays())
    out = {"sp": SHARD_SP, "steps_form": shard_steps_note(SHARD_SP, dev)}
    phase("sharded_form", note=out["steps_form"])
    errs = {name: 0.0 for name in SHARD_SOURCES}

    # -- the per-shard entries against their plain versions ----------------
    def check_shards(label, graph, sp):
        (plan,) = shard_plans(mesh(sp), graph, "kernels")

        def vec(*shape):
            return torch.from_numpy(rng.uniform(
                0.0, 1.0, shape).astype(np.float32)).to(dev)

        u, h, m, a_ex, e = (vec(graph.n_pad) for _ in range(5))
        for k in range(sp):
            base = k * graph.block
            a_raw = vec(graph.block)
            runs = {
                "seg_up_step": (
                    lambda: up_seg_step_shard(u, h, decay, plan.up[k], base),
                    lambda: up_seg_step_shard_plain(u, h, decay, plan.up[k],
                                                    base)),
                "seg_down_step": (
                    lambda: down_seg_step_shard(m, a_ex, decay, plan.dn[k]),
                    lambda: down_seg_step_shard_plain(m, a_ex, decay,
                                                      plan.dn[k])),
                "seg_contrast_step": (
                    lambda: seg_contrast_step_shard(a_raw, e, weight,
                                                    plan.up[k], base),
                    lambda: seg_contrast_step_shard_plain(
                        a_raw, e, weight, plan.up[k], base)),
            }
            for name, (kernel, plain) in runs.items():
                k1, k2, want = kernel(), kernel(), plain()
                torch.cuda.synchronize()
                if not torch.equal(k1, k2):
                    fail(f"{name} (shard) not deterministic ({label}, "
                         f"shard {k})")
                if name != "seg_down_step" and not torch.equal(k1, want):
                    fail(f"{name} (shard) not bitwise its plain version "
                         f"({label}, shard {k})")
                if not torch.allclose(k1, want, rtol=1e-5, atol=1e-6):
                    fail(f"{name} (shard) disagrees with plain ({label}, "
                         f"shard {k})")
                errs[name] = max(errs[name], float((k1 - want).abs().max()))
        longest = {d: int(max((p.offsets[1:] - p.offsets[:-1]).max()
                              for p in getattr(plan, d)))
                   for d in ("up", "dn")}
        phase("sharded_check", layout=label, sp=sp, n_pad=graph.n_pad,
              block=graph.block, longest_up_segment=longest["up"],
              longest_down_segment=longest["dn"],
              max_abs_err=dict(errs))
        return plan

    # -- the front over every shard of the card, against the per-shard
    #    composition (the row pass and the contrast kernels a shard around
    #    the e gather, as the step form runs them) and the plain version --
    def check_front(label, graph, sp, plan, lanes):
        block, n_pad = plan.block, graph.n_pad
        shape = (n_pad, C) if lanes == 1 else (lanes, n_pad, C)
        f = np.zeros(shape, np.float32)
        hot = rng.random(shape[:-1]) < 0.3
        f[hot] = rng.uniform(-0.2, 1.2, (int(hot.sum()), C)).astype(
            np.float32)
        f[..., SvcF.ERROR_RATE] = np.where(
            rng.random(shape[:-1]) < 0.5, rng.uniform(0, 1, shape[:-1]), 0.0)
        # NaN / Inf rows in the last lane, one on a shard boundary
        last = f if lanes == 1 else f[-1]
        last[[7, block, n_pad - 5], [2, 6, 11]] = (np.nan, np.inf, -np.inf)
        if lanes == 1:
            # the resident sessions' [block + 1, C] buffers read through
            # their first block rows; every other one one row in, at a
            # base whose tiles take plain loads
            f_blks = []
            for k in range(sp):
                buf = torch.zeros((block + 2, C), device=dev)
                lo = k % 2
                buf[lo:lo + block] = torch.from_numpy(
                    f[k * block:(k + 1) * block]).to(dev)
                f_blks.append(buf[lo:lo + block])
        else:
            f_blks = [torch.from_numpy(np.ascontiguousarray(
                f[:, k * block:(k + 1) * block])).to(dev) for k in range(sp)]
        for w in (0.0, weight):
            k1, k2 = (evidence_front_shard(f_blks, aw_d, hw_d, w, plan.up,
                                           plan.grid) for _ in range(2))
            want = evidence_front_shard_plain(
                f_blks, aw_d, hw_d, w, plan.up, rows=evidence_front_rows,
                contrast=seg_contrast_step_shard)
            ref = evidence_front_shard_plain(f_blks, aw_d, hw_d, w, plan.up)
            torch.cuda.synchronize()
            case_ = f"({label}, {lanes} lanes, weight {w})"
            for part, got, again, comp, plain in zip("ah", k1, k2, want, ref):
                if not torch.equal(_bits(got), _bits(again)):
                    fail(f"evidence_front_shard {part} not deterministic "
                         f"{case_}")
                if not torch.equal(_bits(got), _bits(comp)):
                    fail(f"evidence_front_shard {part} not bitwise the "
                         f"per-shard composition {case_}")
                if not torch.equal(_bits(got), _bits(plain)):
                    fail(f"evidence_front_shard {part} not bitwise its "
                         f"plain version {case_}")
                if not torch.isfinite(got).all():
                    fail(f"evidence_front_shard {part} not finite {case_}")
                errs["evidence_front_shard"] = max(
                    errs["evidence_front_shard"],
                    float((got - plain).abs().max()))

    # -- the recursions over every shard of the card, against the per-step
    #    composition (the per-shard kernels between the collectives, as
    #    the step form runs them) and through it the plain version -------
    rec_cases = []

    def check_recursions(label, graph, sp, lanes_list=SHARD_LANES):
        (plan,) = shard_plans(mesh(sp), graph, "kernels")
        if plan.steps_form != "shard_grid" or plan.grid is None:
            fail(f"the plan over {sp} logical shards says "
                 f"{plan.steps_form!r} ({label})")
        block = plan.block
        for lanes in lanes_list:
            check_front(label, graph, sp, plan, lanes)
        real = graph.mask > 0
        deg = np.bincount(graph.dst_global[real], minlength=graph.n_pad)
        inv = torch.from_numpy((1.0 / np.maximum(deg, 1)).astype(
            np.float32)).to(dev)
        inv_blk = [inv[k * block:(k + 1) * block] for k in range(sp)]
        for lanes in lanes_list:
            shape = (graph.n_pad,) if lanes == 1 else (lanes, graph.n_pad)
            h = rng.uniform(0.0, 1.0, shape).astype(np.float32)
            a_ex = rng.uniform(0.0, 1.0, shape).astype(np.float32)
            # the background excess leaves most entries at 0; the last
            # lane of a batch carries a NaN and an Inf
            a_ex[..., rng.random(graph.n_pad) < 0.6] = 0.0
            if lanes > 1:
                h[-1, 11], a_ex[-1, 13], a_ex[-1, 17] = np.nan, np.nan, np.inf
            h, a_ex = (torch.from_numpy(x).to(dev) for x in (h, a_ex))
            for steps in CHECK_STEPS:
                runs = {
                    "seg_up_steps_shard": (
                        lambda: up_seg_steps_shard(h, decay, steps, plan.up,
                                                   plan.grid),
                        lambda: torch.cat(up_shard_recursion(
                            [h] * sp, decay, steps, plan.up,
                            up_seg_step_shard), dim=-1),
                        lambda: up_seg_steps_shard_plain(h, decay, steps,
                                                         plan.up)),
                    "seg_down_steps_shard": (
                        lambda: down_seg_steps_shard(a_ex, decay, steps,
                                                     plan.dn, plan.grid, inv),
                        lambda: torch.cat(down_shard_recursion(
                            [a_ex] * sp, decay, steps, plan.dn, inv_blk,
                            down_seg_step_shard), dim=-1),
                        lambda: down_seg_steps_shard_plain(
                            a_ex, decay, steps, plan.dn, inv)),
                }
                for name, (kernel, composed, plain) in runs.items():
                    k1, k2, want, ref = kernel(), kernel(), composed(), plain()
                    torch.cuda.synchronize()
                    case_ = f"({label}, {lanes} lanes, {steps} steps)"
                    if not torch.equal(_bits(k1), _bits(k2)):
                        fail(f"{name} not deterministic {case_}")
                    if not torch.equal(_bits(k1), _bits(want)):
                        fail(f"{name} not bitwise the per-step composition "
                             f"{case_}")
                    # the plain version on the finite lanes: on NaN and
                    # Inf the kernels' fmaxf / sums and the plain scan's
                    # torch.maximum / masked products part ways (the
                    # engine's inputs are sanitized, so finite)
                    if lanes > 1:
                        k1, want, ref = k1[:-1], want[:-1], ref[:-1]
                    if name == "seg_up_steps_shard" and not torch.equal(
                            _bits(want), _bits(ref)):
                        fail(f"{name}: the composition not bitwise the "
                             f"plain version {case_}")
                    if not torch.allclose(want, ref, rtol=1e-5, atol=1e-6):
                        fail(f"{name}: the composition disagrees with the "
                             f"plain version {case_}")
                    if ref.numel():
                        errs[name] = max(errs[name], float(
                            (k1 - ref).abs().max()))
        rec_cases.append(label)
        phase("sharded_recursions", layout=label, sp=sp, n_pad=graph.n_pad,
              block=block, pairs=plan.grid.pairs,
              up_long=plan.grid.up_n_long, down_long=plan.grid.dn_n_long,
              down_big=plan.grid.dn_n_big, lanes=list(lanes_list),
              steps=list(CHECK_STEPS), runs_each=2,
              max_abs_err={k: errs[k] for k in SHARD_KERNELS})

    eng4 = ShardedGraphEngine(mesh=mesh(SHARD_SP), resident=False)
    plans = {}
    for n in cases:
        g = eng4._shard(n, cases[n].dep_src, cases[n].dep_dst)
        plans[n] = (g, check_shards(f"{n} services", g, SHARD_SP))
        check_recursions(f"{n} services", g, SHARD_SP)
    g = ShardedGraphEngine(mesh=mesh(8), resident=False)._shard(
        49999, cases[49999].dep_src, cases[49999].dep_dst)
    check_recursions("49999 services", g, 8)
    # the dp = 2 x sp = 2 batch's rows: 4 of its 8 lanes on 2 shards each
    g = ShardedGraphEngine(mesh=mesh(2, dp=2), resident=False)._shard(
        2047, cases[2047].dep_src, cases[2047].dep_dst)
    check_recursions("2047 services, a dp = 2 row", g, 2, (4, BATCH))
    g = eng4._shard(2047, *_star_case(2047, 3))
    check_shards("star split across 4 shards", g, SHARD_SP)
    check_recursions("star split across 4 shards", g, SHARD_SP)
    block = eng4._shard(2047, np.zeros(0, np.int32),
                        np.zeros(0, np.int32)).block
    g = eng4._shard(2047, *_hub_case(2047, block, 4))
    check_shards("hub cut by the boundary of shards 0 and 1", g, SHARD_SP)
    check_recursions("hub cut by the boundary of shards 0 and 1", g,
                     SHARD_SP)
    out["recursion_checks"] = {"layouts": rec_cases,
                               "lanes": list(SHARD_LANES),
                               "steps": list(CHECK_STEPS)}

    # -- the engine against the dense engine on the card -------------------
    dense = GraphEngine(resident=False)
    configs = [(2047, 4), (49999, 4), (49999, 8)]
    out["engine"] = []
    counted = {}
    dense_runs = {}   # (services, input): the dense analysis, run once
    for n, sp in configs:
        case = cases[n]
        eng = ShardedGraphEngine(mesh=mesh(sp), resident=False)
        res = ShardedGraphEngine(mesh=mesh(sp))
        graph = eng._shard(n, case.dep_src, case.dep_dst)
        bad = case.features.copy()
        bad[[5, 77, 901], [1, 4, 12]] = (np.nan, np.inf, -np.inf)
        for label, feats in (("clean", case.features), ("nan_inf", bad)):
            if (n, label) not in dense_runs:
                dense_runs[n, label] = dense.analyze_arrays(
                    feats, case.dep_src, case.dep_dst, case.names)
            want = dense_runs[n, label]
            # the counted run: launches and collective bytes of one analysis
            eng.analyze_arrays(feats, case.dep_src, case.dep_dst, case.names)
            torch.cuda.synchronize()
            reset_launches()
            collectives.reset_collectives()
            got = eng.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                     case.names)
            launches, shard_l = dict(LAUNCHES), dict(SHARD_LAUNCHES)
            cbytes = dict(collectives.COLLECTIVE_BYTES)
            ccalls = dict(collectives.COLLECTIVE_CALLS)
            if launches != _shard_launches(sp):
                fail(f"sharded launches at {n}, sp {sp}: {launches}")
            if shard_l != {name: launches[name] for name in SHARD_SOURCES}:
                fail(f"per-shard launches at {n}, sp {sp}: {shard_l}")
            # the step form (the per-step composition) in the same run:
            # its launches and collectives, and the same bits
            with _step_form():
                eng.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                   case.names)
                torch.cuda.synchronize()
                reset_launches()
                collectives.reset_collectives()
                stepped = eng.analyze_arrays(feats, case.dep_src,
                                             case.dep_dst, case.names)
                step_l = dict(LAUNCHES)
                step_calls = dict(collectives.COLLECTIVE_CALLS)
                step_bytes = dict(collectives.COLLECTIVE_BYTES)
            if step_l != _shard_launches(sp, "step"):
                fail(f"step-form launches at {n}, sp {sp}: {step_l}")
            if not np.array_equal(_f32bits(stepped.full_diagnostics()),
                                  _f32bits(got.full_diagnostics())):
                fail(f"shard_grid not bitwise the step form at {n}, sp "
                     f"{sp} ({label})")
            counted[(n, sp)] = {"shard": shard_l, "all": launches,
                                "step_form": step_l}
            # per call (sp - 1) * block * 4 bytes through every shard:
            # shard_grid moves the degree once (the front's one launch
            # writes the joined a and h), the step form also e, h and a
            # once, u and m each step and the contributions
            per_call = (sp - 1) * graph.block * 4
            for form, calls, moved, (n_ag, n_rs) in (
                    ("shard_grid", ccalls, cbytes, (0, 1)),
                    ("step", step_calls, step_bytes, (19, 9))):
                budget = {"all_gather": n_ag * sp * per_call,
                          "reduce_scatter": n_rs * sp * per_call}
                if calls["all_gather"] != n_ag or \
                        calls["reduce_scatter"] != n_rs or any(
                            moved[kind] != budget[kind] for kind in budget):
                    fail(f"{form} collectives at {n}, sp {sp}: {calls} "
                         f"{moved}, budget {budget}")
            again = eng.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                       case.names)
            resident = [res.analyze_arrays(feats, case.dep_src,
                                           case.dep_dst, case.names)
                        for _ in range(2)]
            gs, ds = got.full_diagnostics(), want.full_diagnostics()
            if not all(np.array_equal(_f32bits(gs), _f32bits(
                    r.full_diagnostics())) for r in [again, *resident]):
                fail(f"sharded runs differ at {n}, sp {sp} ({label})")
            if not (np.array_equal(gs[0][:n], ds[0][:n])
                    and np.array_equal(gs[1][:n], ds[1][:n])):
                fail(f"sharded a / u not bitwise dense at {n}, sp {sp}")
            if not (np.allclose(gs[2][:n], ds[2][:n], rtol=1e-5, atol=1e-6)
                    and np.allclose(gs[3][:n], ds[3][:n], rtol=1e-5,
                                    atol=1e-6)):
                fail(f"sharded m / score disagree with dense at {n}, sp {sp}")
            if got.top_components()[:3] != want.top_components()[:3]:
                fail(f"sharded top-3 {got.top_components()[:3]} vs dense "
                     f"{want.top_components()[:3]} at {n}, sp {sp}")
            if got.sanitized_rows != want.sanitized_rows or \
                    any(r.sanitized_rows != got.sanitized_rows
                        for r in resident):
                fail(f"sharded sanitized_rows {got.sanitized_rows} vs "
                     f"{want.sanitized_rows} at {n}, sp {sp}")
            if not np.isfinite(gs).all():
                fail(f"non-finite sharded diagnostics at {n}, sp {sp}")
            # h: the dense front's and the shards' row passes, bitwise
            f = np.zeros((graph.n_pad, C), np.float32)
            f[:n] = np.where(np.isfinite(feats).all(1, keepdims=True),
                             feats, 0.0)
            ft = torch.from_numpy(f).to(dev)
            aw, hw = (torch.from_numpy(np.asarray(w)).to(dev)
                      for w in params.weight_arrays())
            h_dense = evidence_front_rows(ft, aw, hw)[1]
            h_shards = torch.cat([evidence_front_rows(
                ft[k * graph.block:(k + 1) * graph.block], aw, hw)[1]
                for k in range(sp)])
            if not torch.equal(h_dense, h_shards):
                fail(f"sharded h not bitwise dense at {n}, sp {sp}")
            row = {"services": n, "sp": sp, "input": label,
                   "n_pad": graph.n_pad, "block": graph.block,
                   "e_pad_per_shard": int(graph.src_local.shape[1]),
                   "launches": launches, "shard_launches": shard_l,
                   "step_form_launches": step_l,
                   "collective_calls": ccalls,
                   "collective_bytes": cbytes,
                   "step_form_collective_calls": step_calls,
                   "step_form_collective_bytes": step_bytes,
                   "step_form_bitwise": True,
                   "bytes_per_call_per_shard": per_call,
                   "top": got.top_components()[:3],
                   "top_k_identical": got.top_components()
                   == want.top_components(),
                   "sanitized_rows": got.sanitized_rows,
                   "score_max_abs_err": float(np.abs(gs[3][:n]
                                                     - ds[3][:n]).max()),
                   "m_max_abs_err": float(np.abs(gs[2][:n]
                                                 - ds[2][:n]).max())}
            out["engine"].append(row)
            phase("sharded_engine", **row)
        # resident: the seeded request sequence, bitwise restaged
        seq = _resident_requests(case, graph.n_pad,
                                 np.random.default_rng(170 + n))
        for label, f in seq:
            reset_launches()
            a = res.analyze_arrays(f, case.dep_src, case.dep_dst, case.names)
            if dict(LAUNCHES) != _shard_launches(sp):
                fail(f"sharded resident {label} at {n}: {dict(LAUNCHES)}")
            b = eng.analyze_arrays(f, case.dep_src, case.dep_dst, case.names)
            if not np.array_equal(_f32bits(a.full_diagnostics()),
                                  _f32bits(b.full_diagnostics())) or \
                    a.ranked != b.ranked or \
                    a.sanitized_rows != b.sanitized_rows:
                fail(f"sharded resident {label} at {n}, sp {sp} is not "
                     f"bitwise restaging")
        phase("sharded_resident", services=n, sp=sp, requests=len(seq),
              bitwise=True, stats=res._resident_cache.stats())

    # -- the hypothesis batch over dp = 2, sp = 2 --------------------------
    case = cases[2047]
    batch = np.repeat(case.features[None], 8, axis=0)
    for b in range(1, 8):
        batch[b, rng.choice(case.n, 12, replace=False)] = 0.0
    batch[3, 40, 2] = np.nan
    beng = ShardedGraphEngine(mesh=mesh(2, dp=2))
    beng.analyze_batch(batch, case.dep_src, case.dep_dst, case.names)
    torch.cuda.synchronize()
    reset_launches()
    got = beng.analyze_batch(batch, case.dep_src, case.dep_dst, case.names)
    batch_l = dict(LAUNCHES)
    # each recursion once a dp row: both rows' shards share the card
    if batch_l != _shard_launches(2, dp=2):
        fail(f"sharded batch launches on dp = 2, sp = 2: {batch_l}")
    with _step_form():
        stepped = ShardedGraphEngine(mesh=mesh(2, dp=2)).analyze_batch(
            batch, case.dep_src, case.dep_dst, case.names)
    want = dense.analyze_batch(batch, case.dep_src, case.dep_dst, case.names)
    for b, (g_b, w_b) in enumerate(zip(got, want)):
        if g_b.top_components()[:3] != w_b.top_components()[:3] or \
                not np.allclose(g_b.score, w_b.score, rtol=1e-5, atol=1e-6) \
                or not np.array_equal(g_b.upstream, w_b.upstream):
            fail(f"sharded batch lane {b} disagrees with the dense lane")
        if not np.array_equal(_f32bits(g_b.score),
                              _f32bits(stepped[b].score)):
            fail(f"sharded batch lane {b}: shard_grid not bitwise the step "
                 f"form")
    out["batch"] = {"lanes": 8, "dp": 2, "sp": 2, "services": 2047,
                    "engine": got[0].engine, "launches": batch_l,
                    "step_form_bitwise": True}
    phase("sharded_batch", **out["batch"])

    # -- the streaming session at 10,000 services ---------------------------
    n = 10000
    big = _generated("arrays", n, 3, 0)
    names = [f"svc-{i}" for i in range(n)]
    seng = ShardedGraphEngine(mesh=mesh(SHARD_SP))
    sharded_s = ShardedStreamingSession(names, big.dep_src, big.dep_dst, C,
                                        engine=seng, k=5)
    twin = ShardedStreamingSession(names, big.dep_src, big.dep_dst, C,
                                   engine=seng, k=5)
    twin.use_torch_row()
    dense_s = StreamingSession(names, big.dep_src, big.dep_dst, C,
                               engine=GraphEngine(), k=5)
    start = big.features.copy()
    start[rng.choice(n, 4, replace=False)] = np.nan
    for s_ in (sharded_s, twin, dense_s):
        s_.set_all(start)
    tick_launches = {}
    for t in range(30):
        if t % 3 != 2:
            idx = rng.choice(n, 8, replace=False)
            rows = rng.uniform(0, 1, (8, C)).astype(np.float32)
            if t % 5 == 1:
                rows[0, 3] = np.nan
            for s_ in (sharded_s, twin, dense_s):
                s_.update_rows(idx, rows)
        kind = "delta" if t % 3 != 2 else "quiet"
        reset_launches()
        got = sharded_s.fetch(_no_sync(sharded_s.dispatch))
        launches = dict(LAUNCHES)
        if launches != _shard_launches(SHARD_SP):
            fail(f"sharded tick {t}: launches {launches}")
        tick_launches.setdefault(kind, launches)
        want, plain = dense_s.tick(), twin.tick()
        if [r["component"] for r in got["ranked"]] != \
                [r["component"] for r in want["ranked"]] or \
                not np.allclose([r["score"] for r in got["ranked"]],
                                [r["score"] for r in want["ranked"]],
                                rtol=1e-5, atol=1e-6):
            fail(f"sharded tick {t}: ranking differs from the dense session")
        if got["upload_rows"] != want["upload_rows"]:
            fail(f"sharded tick {t}: upload_rows {got['upload_rows']} vs "
                 f"{want['upload_rows']}")
        if not all(torch.equal(_bits(a), _bits(b)) for a, b in
                   zip(sharded_s.blocks(), twin.blocks())):
            fail(f"sharded tick {t}: the blocks are not bitwise the "
                 f"torch-row twin's")
        if [r["component"] for r in got["ranked"]] != \
                [r["component"] for r in plain["ranked"]] or \
                not np.allclose([r["score"] for r in got["ranked"]],
                                [r["score"] for r in plain["ranked"]],
                                rtol=1e-5, atol=1e-6):
            fail(f"sharded tick {t}: ranking differs from the torch-row "
                 f"twin")
    behind = []
    for staged in (True, False):
        if staged:
            sharded_s.update_rows(rng.choice(n, 8, replace=False),
                                  rng.uniform(0, 1, (8, C)).astype(
                                      np.float32))
        torch.cuda._sleep(int(0.2 * 2e9))
        t0 = time.perf_counter()
        handle = _no_sync(sharded_s.dispatch)
        ms = (time.perf_counter() - t0) * 1e3
        pending = not handle.result.ready.query()
        sharded_s.fetch(handle)
        if not pending or ms > 150:
            fail(f"sharded dispatch waited for the card ({ms:.1f} ms, "
                 f"pending {pending})")
        behind.append(ms)

    sh_walls = _tick_walls(sharded_s, rng)
    de_walls = _tick_walls(dense_s, rng)
    out["stream"] = {
        "services": n, "sp": SHARD_SP, "ticks": 30,
        "tick_launches": tick_launches, "sync_free_dispatches": 32,
        "dispatch_behind_sleep_ms": behind,
        "tick_wall_ms": float(np.median(sh_walls)),
        "tick_wall_ms_range": [min(sh_walls), max(sh_walls)],
        "dense_tick_wall_ms": float(np.median(de_walls))}

    # -- the live session on a sharded engine --------------------------------
    def fixture():
        return synthetic_cascade_world(50, n_roots=1, seed=7,
                                       namespace="synthetic")

    world, dworld = fixture(), fixture()
    roots = world.ground_truth["fault_roots"]
    live = LiveStreamingSession(MockClusterClient(world), "synthetic", k=3,
                                engine=ShardedGraphEngine(mesh=mesh(SHARD_SP)),
                                topology_check_every=7)
    dlive = LiveStreamingSession(MockClusterClient(dworld), "synthetic", k=3,
                                 engine=GraphEngine(),
                                 topology_check_every=7)
    if type(live.session) is not ShardedStreamingSession:
        fail(f"live session on a sharded engine: {type(live.session)}")
    for t in range(20):
        if t % 2:
            for w in (world, dworld):
                pods = w.pods["synthetic"]
                w.touch("pod", "synthetic",
                        pods[(7 * t) % len(pods)]["metadata"]["name"])
        got, want = live.poll(), dlive.poll()
        if got["degraded"] or got["health"]["kernel_path"] != "kernels":
            fail(f"sharded live poll {t}: degraded {got['degraded']}, "
                 f"kernel_path {got['health']['kernel_path']}")
        if [r["component"] for r in got["ranked"]] != \
                [r["component"] for r in want["ranked"]]:
            fail(f"sharded live poll {t}: ranking differs from dense")
    if got["ranked"][0]["component"] not in roots:
        fail(f"sharded live top-1 {got['ranked'][0]['component']} is not "
             f"the root {roots}")
    real = ShardedStreamingSession.dispatch

    def broken(self):
        raise RuntimeError("injected sharded dispatch failure")

    ShardedStreamingSession.dispatch = broken
    try:
        stepped = live.poll()
    finally:
        ShardedStreamingSession.dispatch = real
    if stepped["health"]["degradation_rung"] != "single-device" or \
            type(live.engine) is not GraphEngine or \
            type(live.session) is not StreamingSession or \
            live.engine.device != dev or \
            live.session.kernel_path != "kernels" or not stepped["ranked"]:
        fail(f"sharded live ladder: rung "
             f"{stepped['health']['degradation_rung']}, engine "
             f"{type(live.engine).__name__}, session "
             f"{type(live.session).__name__}")
    out["live"] = {"polls": 20, "top": got["ranked"][0]["component"],
                   "roots": roots,
                   "ladder": {"rung": "single-device",
                              "faults": [f["op"] for f in
                                         stepped["health"]["faults"]],
                              "engine": type(live.engine).__name__}}
    phase("sharded_stream", **out["stream"])
    phase("sharded_live", **out["live"])

    # -- distinct cards, or the peer recursions rehearsed on one -------------
    if torch.cuda.device_count() >= 2:
        out["multi_card"] = multi_card_phase(cases, big, dense)
        out["peer"] = {key: out["multi_card"][key]
                       for key in ("times", "errs", "checks")}
    else:
        out["multi_card"] = {"cards": 1, "collectives": "device-local",
                             "note": "one card: every shard on cuda:0, the "
                                     "collectives are copies on its "
                                     "stream; the peer recursions rehearsed "
                                     "as two ranks of cuda:0"}
        phase("sharded_multi_card", **out["multi_card"])
        out["peer"] = _peer_rehearsal_join(
            rehearsal or _peer_rehearsal_start(cases))

    # -- times ---------------------------------------------------------------
    times = {}
    for n in cases:
        case = cases[n]
        sh = ShardedGraphEngine(mesh=mesh(SHARD_SP), resident=False)

        def sharded_call():
            sh.analyze_arrays(case.features, case.dep_src, case.dep_dst,
                              case.names)

        def dense_call():
            dense.analyze_arrays(case.features, case.dep_src, case.dep_dst,
                                 case.names)

        # the sharded analysis at sp 4 in both forms beside the dense one,
        # in turns: dense, step, shard_grid, shard_grid, step, dense
        walls = {"dense": [], "step": [], "shard_grid": []}
        for form in ("dense", "step", "shard_grid", "shard_grid", "step",
                     "dense"):
            ctx = _step_form() if form == "step" else contextlib.nullcontext()
            with ctx:
                walls[form].append(host_ms(
                    dense_call if form == "dense" else sharded_call,
                    reps=10))
        t = {"walls_ms": walls,
             "analyze_arrays_ms": float(np.mean(walls["shard_grid"])),
             "dense_analyze_arrays_ms": float(np.mean(walls["dense"]))}
        # launches, device time and busy share of one analysis: the dense
        # engine's and the sharded one's in both forms
        for label, fn, wall in (
                ("sharded", sharded_call, t["analyze_arrays_ms"]),
                ("dense", dense_call, t["dense_analyze_arrays_ms"]),
                ("step_form", sharded_call, float(np.mean(walls["step"])))):
            ctx = (_step_form() if label == "step_form"
                   else contextlib.nullcontext())
            with ctx:
                p = device_profile(fn, wall, out_dir if profile_it else None,
                                   f"{label}_{n}", calls=3, warm=2)
            t[f"{label}_device_us"] = p["device_us_per_call"]
            t[f"{label}_busy_share"] = p["device_busy_share"]
            t[f"{label}_launches_per_call"] = p["launches_per_call"]
        graph, plan = plans[n]
        e_real = [int(m.sum()) for m in graph.mask]
        k = int(np.argmax(e_real))      # the shard with the most edges
        base = k * graph.block
        vec = {name: torch.from_numpy(rng.uniform(0, 1, graph.n_pad).astype(
            np.float32)).to(dev) for name in ("u", "h", "m", "a_ex", "e")}
        a_raw = torch.from_numpy(rng.uniform(0, 1, graph.block).astype(
            np.float32)).to(dev)
        up_out = torch.empty(graph.block, device=dev)
        dn_out = torch.empty(graph.n_pad, device=dev)
        e_k, b_k, np_k = e_real[k], graph.block, graph.n_pad
        # the tier's own rows, sanitized and padded, as the engine stages
        f_tier = np.zeros((graph.n_pad, C), np.float32)
        f_tier[:n] = np.where(np.isfinite(case.features).all(
            1, keepdims=True), case.features, 0.0)
        f_own = torch.from_numpy(f_tier[base:base + b_k]).to(dev)
        # the bounds count each entry a step must read once, for this
        # shard's real edges: the CSR (endpoints, offsets, segment order),
        # the gathered vectors at the edges' distinct destinations (up,
        # contrast; also the node's own entry there) or distinct sources
        # (down: its own block only), the output once
        real = graph.mask[k] > 0
        dsts = graph.dst_global[k][real]
        n_dst = len(np.unique(dsts))
        n_dst_own = len(np.union1d(dsts, np.arange(base, base + b_k)))
        n_src = len(np.unique(graph.src_global[k][real]))
        runs = {
            "evidence_front": (
                lambda: evidence_front_rows(f_own, aw_d, hw_d),
                lambda: evidence_front_rows_plain(f_own, aw_d, hw_d),
                bound(cost.front_rows(b_k))),
            "seg_up_step": (
                lambda: up_seg_step_shard(vec["u"], vec["h"], decay,
                                          plan.up[k], base, out=up_out),
                lambda: up_seg_step_shard_plain(vec["u"], vec["h"], decay,
                                                plan.up[k], base),
                bound(cost.up_step_shard(e_k, b_k, n_dst, n_dst_own))),
            "seg_down_step": (
                lambda: down_seg_step_shard(vec["m"], vec["a_ex"], decay,
                                            plan.dn[k], out=dn_out),
                lambda: down_seg_step_shard_plain(vec["m"], vec["a_ex"],
                                                  decay, plan.dn[k]),
                bound(cost.down_step_shard(e_k, np_k, n_src))),
            "seg_contrast_step": (
                lambda: seg_contrast_step_shard(a_raw, vec["e"], weight,
                                                plan.up[k], base),
                lambda: seg_contrast_step_shard_plain(
                    a_raw, vec["e"], weight, plan.up[k], base),
                bound(cost.contrast_shard(e_k, b_k, n_dst_own))),
        }
        for name, (kernel, plain, limit) in runs.items():
            # the plain steps are host-bound (0.2-1 ms a call): a few
            # samples of 2 calls time them as well as 20 of 10
            t[name] = {"shard": k, "edges": e_k, "distinct_dst": n_dst,
                       "distinct_src": n_src, "ms": cuda_ms(kernel),
                       "call_ms": cuda_ms(kernel, queued=False),
                       "plain_ms": cuda_ms(plain, reps=5, inner=2),
                       "library_ms": None, "bound": limit}
        t.update(_time_shard_recursions(graph, SHARD_SP, rng, decay))
        t.update(_time_shard_front(graph, SHARD_SP, f_tier, aw_d, hw_d,
                                   weight))
        if n == 49999:
            # 8 shards: the recursions (no plain version: the sp 4 rows
            # time it) and an analysis's launches and device time in
            # both forms
            g8 = ShardedGraphEngine(mesh=mesh(8), resident=False)._shard(
                n, case.dep_src, case.dep_dst)
            for name, row in _time_shard_recursions(g8, 8, rng, decay,
                                                    plain=False).items():
                t[name]["at_sp8"] = row
            t["evidence_front_shard"]["at_sp8"] = _time_shard_front(
                g8, 8, f_tier, aw_d, hw_d, weight,
                plain=False)["evidence_front_shard"]
            sh8 = ShardedGraphEngine(mesh=mesh(8), resident=False)

            def sp8_call():
                sh8.analyze_arrays(case.features, case.dep_src,
                                   case.dep_dst, case.names)

            t["sp8_profiles"] = {}
            for form in ("shard_grid", "step"):
                ctx = (_step_form() if form == "step"
                       else contextlib.nullcontext())
                with ctx:
                    p = device_profile(sp8_call, host_ms(sp8_call, reps=5),
                                       None, f"sharded_sp8_{form}", calls=3,
                                       warm=2)
                t["sp8_profiles"][form] = {
                    key: p[key] for key in ("device_us_per_call",
                                            "launches_per_call",
                                            "device_busy_share")}
        times[n] = t
        phase("sharded_times", services=n, sp=SHARD_SP, **t)
    # the allocator's peak over a 16-lane batch at 49,999 services on 8
    # logical shards in each form, the per-stream scratch made anew
    case = cases[49999]
    lanes16 = np.repeat(case.features[None], 16, axis=0)
    peaks = {}
    for form in ("step", "shard_grid"):
        segscan._GRID_SCRATCH.clear()
        eng16 = ShardedGraphEngine(mesh=mesh(8), resident=False)
        ctx = _step_form() if form == "step" else contextlib.nullcontext()
        with ctx:
            eng16.analyze_batch(lanes16, case.dep_src, case.dep_dst,
                                case.names)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            eng16.analyze_batch(lanes16, case.dep_src, case.dep_dst,
                                case.names)
            torch.cuda.synchronize()
        peaks[form] = {"peak_bytes": torch.cuda.max_memory_allocated(),
                       "resident_bytes": base}
    g8 = ShardedGraphEngine(mesh=mesh(8), resident=False)._shard(
        49999, case.dep_src, case.dep_dst)
    (plan8,) = shard_plans(mesh(8), g8, "kernels")
    peaks["scratch_floats"] = {
        "up": 2 * 16 * g8.n_pad,
        "down": 16 * (g8.n_pad + plan8.grid.pairs)}
    out["peak_memory_16_lanes_sp8"] = peaks
    phase("sharded_peak", services=49999, sp=8, lanes=16, **peaks)
    out["times"] = {str(n): t for n, t in times.items()}
    out["errs"] = errs
    out["launches"] = {f"{n}x{sp}": v["shard"]
                       for (n, sp), v in counted.items()}
    out["all_launches"] = {f"{n}x{sp}": v["all"]
                           for (n, sp), v in counted.items()}
    out["step_form_launches"] = {f"{n}x{sp}": v["step_form"]
                                 for (n, sp), v in counted.items()}
    return out


def _time_shard_recursions(graph, sp: int, rng, decay: float,
                           plain: bool = True) -> dict:
    """The two shard recursions over ``sp`` logical shards of ``cuda:0``
    at one lane and 8 steps, as a sharded analysis runs them: card and call
    ms beside the per-step composition they replace (the per-shard kernels
    between the collectives, the same call), the plain version (``plain``)
    and the bound of the function over this graph's real edges (the
    dense recursions' model, the pairs' adds for down)."""
    import numpy as np
    import torch
    from rca_tpu_torch.engine.segscan import (
        down_seg_step_shard,
        down_seg_steps_shard,
        down_seg_steps_shard_plain,
        down_shard_recursion,
        up_seg_step_shard,
        up_seg_steps_shard,
        up_seg_steps_shard_plain,
        up_shard_recursion,
    )
    from rca_tpu_torch.kernels import cost
    from rca_tpu_torch.parallel.mesh import make_mesh
    from rca_tpu_torch.parallel.sharded import shard_plans

    dev = torch.device("cuda", 0)
    (plan,) = shard_plans(make_mesh([("dp", 1), ("sp", sp)], [dev] * sp),
                          graph, "kernels")
    block, n_pad, e = plan.block, graph.n_pad, int(graph.mask.sum())
    h, a_ex = (torch.from_numpy(rng.uniform(0, 1, n_pad).astype(
        np.float32)).to(dev) for _ in range(2))
    real = graph.mask > 0
    inv = torch.from_numpy((1.0 / np.maximum(np.bincount(
        graph.dst_global[real], minlength=n_pad), 1)).astype(
        np.float32)).to(dev)
    inv_blk = [inv[k * block:(k + 1) * block] for k in range(sp)]
    u_out, m_out = torch.empty_like(h), torch.empty_like(a_ex)
    runs = {
        "seg_up_steps_shard": (
            lambda: up_seg_steps_shard(h, decay, 8, plan.up, plan.grid,
                                       out=u_out),
            lambda: up_shard_recursion([h] * sp, decay, 8, plan.up,
                                       up_seg_step_shard),
            lambda: up_seg_steps_shard_plain(h, decay, 8, plan.up),
            bound(cost.up_steps(n_pad, e, 0))),
        "seg_down_steps_shard": (
            lambda: down_seg_steps_shard(a_ex, decay, 8, plan.dn, plan.grid,
                                         inv, out=m_out),
            lambda: down_shard_recursion([a_ex] * sp, decay, 8, plan.dn,
                                         inv_blk, down_seg_step_shard),
            lambda: down_seg_steps_shard_plain(a_ex, decay, 8, plan.dn, inv),
            bound(cost.down_steps(n_pad, e, 0,
                                  pairs=plan.grid.pairs))),
    }
    out = {}
    for name, (kernel, composed, plain_fn, limit) in runs.items():
        # in turns: the composition, the kernel, the kernel, the
        # composition; 2 compositions a sample, so the ~250 launches of
        # one at sp 8 stay inside the device's launch queue while the
        # sleep kernel holds the card (10 of them at a time would block
        # the host and time it); the plain version, host-bound at 65-160
        # ms a call, over 3 single calls
        comp = [cuda_ms(composed, reps=10, inner=2)]
        ms = [cuda_ms(kernel), cuda_ms(kernel)]
        comp.append(cuda_ms(composed, reps=10, inner=2))
        out[name] = {"sp": sp, "edges": e, "pairs": plan.grid.pairs,
                     "ms": min(ms), "ms_runs": ms,
                     "call_ms": cuda_ms(kernel, queued=False),
                     "composition_ms": min(comp), "composition_runs": comp,
                     "composition_call_ms": cuda_ms(composed, reps=10,
                                                    inner=2, queued=False),
                     "plain_ms": (cuda_ms(plain_fn, reps=3, inner=1)
                                  if plain else None),
                     "library_ms": None, "bound": limit}
    return out


def _time_shard_front(graph, sp: int, f_tier, aw, hw, weight: float,
                      plain: bool = True) -> dict:
    """The sharded front over ``sp`` logical shards of ``cuda:0`` on the
    tier's own padded rows ``f_tier`` at one lane and the contrast weight
    ``weight``, as a sharded analysis runs it: card and call ms beside the
    per-shard composition it replaces (the row pass and the contrast
    kernels a shard around the ``e`` gather; in turns in the same call),
    the dense fused front over the same rows and the real edges (the
    target), the plain version (``plain``) and the bound of the function
    (``cost.front_shard``)."""
    import numpy as np
    import torch
    from rca_tpu_torch.engine.evidence import (
        evidence_front,
        evidence_front_rows,
        evidence_front_shard,
        evidence_front_shard_plain,
        seg_contrast_step_shard,
    )
    from rca_tpu_torch.engine.segscan import build_seg_layouts
    from rca_tpu_torch.kernels import cost
    from rca_tpu_torch.parallel.mesh import make_mesh
    from rca_tpu_torch.parallel.sharded import shard_plans

    dev = torch.device("cuda", 0)
    (plan,) = shard_plans(make_mesh([("dp", 1), ("sp", sp)], [dev] * sp),
                          graph, "kernels")
    block, n_pad = plan.block, graph.n_pad
    real = graph.mask > 0
    e = int(real.sum())
    ft = torch.from_numpy(f_tier).to(dev)
    f_blks = [ft[k * block:(k + 1) * block].clone() for k in range(sp)]
    _, up = build_seg_layouts(n_pad, e, graph.src_global[real],
                              graph.dst_global[real], device=dev)

    def kernel():
        evidence_front_shard(f_blks, aw, hw, weight, plan.up, plan.grid)

    def composed():
        evidence_front_shard_plain(f_blks, aw, hw, weight, plan.up,
                                   rows=evidence_front_rows,
                                   contrast=seg_contrast_step_shard)

    def dense():
        evidence_front(ft, aw, hw, weight, up)

    # in turns: the composition, the kernel, the kernel, the composition
    # (2 compositions a sample: 2 sp + 2 launches each)
    comp = [cuda_ms(composed, reps=10, inner=2)]
    ms = [cuda_ms(kernel), cuda_ms(kernel)]
    comp.append(cuda_ms(composed, reps=10, inner=2))
    return {"evidence_front_shard": {
        "sp": sp, "edges": e, "ms": min(ms), "ms_runs": ms,
        "call_ms": cuda_ms(kernel, queued=False),
        "composition_ms": min(comp), "composition_runs": comp,
        "composition_call_ms": cuda_ms(composed, reps=10, inner=2,
                                       queued=False),
        "dense_fused_ms": cuda_ms(dense),
        "dense_fused_call_ms": cuda_ms(dense, queued=False),
        "plain_ms": (cuda_ms(lambda: evidence_front_shard_plain(
            f_blks, aw, hw, weight, plan.up), reps=5, inner=2)
            if plain else None),
        "library_ms": None, "bound": bound(cost.front_shard(n_pad, e))}}


FED_WORKERS = 3
FED_BIG_REQUESTS = 4
#: the load legs' worker environment: the kernels row forced, so a kernel
#: fault fails loudly instead of electing plain ops, and the dense engine
#: pinned on worker and oracle alike
FED_ENV = {"RCA_KERNEL": "kernels", "RCA_SHARD": "0"}


def _fed_e2e(reqs, resps) -> dict:
    """Submit → completion p50 / p99 in ms (nearest rank) over a load, from
    the plane's own stamps (admission ``enqueued_at``, the sink's
    ``completed_at``)."""
    import numpy as np

    walls = [1e3 * (resp.completed_at - req.enqueued_at)
             for req, resp in zip(reqs, resps)]
    return {"e2e_ms_p50": float(np.percentile(walls, 50, method="nearest")),
            "e2e_ms_p99": float(np.percentile(walls, 99, method="nearest"))}


def _fed_parity(oracle, items, resps) -> tuple:
    """How many ok answers were checked against a solo analysis in this
    process, and whether every one was bitwise equal."""
    checked, same = 0, True
    for (case, f), resp in zip(items, resps):
        if resp.status != "ok":
            continue
        solo = oracle.analyze_arrays(f, case.dep_src, case.dep_dst,
                                     case.names, k=SERVE_K)
        checked += 1
        same = same and [dict(r) for r in solo.ranked] == resp.ranked
    return checked, same


def _fed_hellos(plane) -> dict:
    with plane._lock:
        return {str(wid): {key: w.hello.get(key) for key in (
            "pid", "role", "engine", "local_devices", "process_count",
            "registry", "headroom")}
            for wid, w in sorted(plane.workers.items())}


def _compute_apps() -> list:
    """The contexts ``nvidia-smi`` lists on the card, as ``pid, memory``
    lines (a container may show every pid as 1: count them, do not match
    them)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def _fed_codec(case, f, reps: int) -> dict:
    """Host ms (median of ``reps``) of one request's trip through the
    federation's frame codec: the coordinator's ``encode_request`` and
    ``json.dumps`` (the router thread), the worker's ``json.loads`` and
    ``decode_request_kwargs`` (its read thread), and the frame's bytes."""
    import numpy as np
    from rca_tpu_torch.serve import ServeRequest
    from rca_tpu_torch.serve.fedwire import (
        decode_request_kwargs,
        encode_request,
    )

    req = ServeRequest("t", f, case.dep_src, case.dep_dst, names=case.names,
                       k=SERVE_K)
    enc, dec = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        payload = json.dumps(encode_request(req), separators=(",", ":"))
        t1 = time.perf_counter()
        ServeRequest(**decode_request_kwargs(json.loads(payload)))
        t2 = time.perf_counter()
        enc.append((t1 - t0) * 1e3)
        dec.append((t2 - t1) * 1e3)
    return {"encode_ms": float(np.median(enc)),
            "decode_ms": float(np.median(dec)),
            "frame_bytes": len(payload.encode("utf-8")), "reps": reps}


def _fed_heartbeats(plane) -> dict:
    """Each worker's heartbeat timing over its lease (the plane's worker
    table): the longest gap between two heartbeats it sent, between two
    read in this process, and from a send to its reading."""
    return {str(row["worker_id"]): {k: row[k] for k in (
        "lease_renewals", "hb_send_gap_max_s", "hb_recv_gap_max_s",
        "hb_lag_max_s")} for row in plane.worker_table()}


@contextlib.contextmanager
def _gc_pauses():
    """The longest garbage collection of this process inside the block,
    in ms (``{"max_ms": ...}``, filled on exit): a collection holds every
    thread here, the federation's readers and lease monitor among them."""
    import gc

    out, started = {"max_ms": 0.0, "count": 0}, [0.0]

    def note(stage, _info):
        if stage == "start":
            started[0] = time.perf_counter()
        else:
            out["count"] += 1
            out["max_ms"] = max(out["max_ms"],
                                1e3 * (time.perf_counter() - started[0]))

    gc.callbacks.append(note)
    try:
        yield out
    finally:
        gc.callbacks.remove(note)


def _fed_load_leg(n, case, feats, device, smi, heartbeat_s=None,
                  lease_misses=None, ingest: bool = False) -> dict:
    """One load leg: ``FED_WORKERS`` worker processes under a
    ``FederationPlane`` (``FED_ENV``), ``feats`` over ``case``'s graph
    submitted by 4 threads as 4 tenants, in turns with the same load on an
    in-process ``ServePool`` of as many dense replicas (federation, pool,
    pool, federation); every ok answer bitwise its solo analysis in this
    process; then each worker drained, its launch counters (a fresh
    process: counted from 0) read from its report.  The leases are the
    plane's defaults unless ``heartbeat_s`` / ``lease_misses`` say
    otherwise, and each worker's heartbeat timing is printed.  ``ingest``
    also joins an ingest worker and checks it never made a CUDA context:
    its hello reports no devices and no headroom, and the card's count of
    contexts does not grow while it joins and ticks."""
    from rca_tpu_torch.config import ServeConfig
    from rca_tpu_torch.engine import GraphEngine
    from rca_tpu_torch.parallel.mesh import visible_devices
    from rca_tpu_torch.serve import ServePool
    from rca_tpu_torch.serve.federation import FederationPlane

    items = [(case, f) for f in feats]
    env = {**FED_ENV, "RCA_KERNEL_CACHE": os.environ.get(
        "RCA_KERNEL_CACHE", "off")}
    config = ServeConfig(max_batch=16, queue_cap=4 * SERVE_REQUESTS)
    out = {"services": n, "requests": len(feats), "rounds": []}
    with mock.patch.dict(os.environ, FED_ENV):
        oracle = GraphEngine(device=device)
        plane = FederationPlane(
            workers=FED_WORKERS, config=config, device=device,
            worker_env=env, heartbeat_s=heartbeat_s,
            lease_misses=lease_misses)
        t0 = time.perf_counter()
        plane.start()
        try:
            if not plane.wait_ready(FED_WORKERS, timeout_s=300.0):
                fail(f"federation at {n}: {plane.worker_table()}; "
                     + "; ".join(w.proc.output()[1][-1500:]
                                 for w in plane.workers.values() if w.proc))
            out["startup_s"] = time.perf_counter() - t0
            spawned = {e["worker_id"]: e["t"] for e in plane.events
                       if e["event"] == "worker_spawned"}
            out["worker_startup_s"] = {
                str(e["worker_id"]): e["t"] - spawned[e["worker_id"]]
                for e in plane.events if e["event"] == "worker_joined"}
            out["hellos"] = _fed_hellos(plane)
            out["lease_ttl_s"] = plane.leases.ttl_s
            gc_fed = {"max_ms": 0.0, "count": 0}
            for label in ("federation", "pool", "pool", "federation"):
                if label == "federation":
                    with _gc_pauses() as gc_round:
                        reqs, resps, wall_s = _submit_load(plane, items)
                    gc_fed["count"] += gc_round["count"]
                    gc_fed["max_ms"] = max(gc_fed["max_ms"],
                                           gc_round["max_ms"])
                else:
                    pool = ServePool(config=ServeConfig(
                        max_batch=16, queue_cap=4 * SERVE_REQUESTS,
                        replicas=FED_WORKERS),
                        devices=visible_devices(device))
                    with pool:
                        reqs, resps, wall_s = _submit_load(pool, items)
                checked, same = _fed_parity(oracle, items, resps)
                by_status: dict = {}
                for r in resps:
                    by_status[r.status] = by_status.get(r.status, 0) + 1
                row = {"plane": label, "wall_s": wall_s,
                       "analyses_per_s": by_status.get("ok", 0) / wall_s,
                       **_fed_e2e(reqs, resps), "by_status": by_status,
                       "parity_checked": checked, "parity_ok": same}
                if by_status != {"ok": len(items)} or not same:
                    fail(f"federation at {n}, {label}: {row}")
                out["rounds"].append(row)
                phase("federation", leg=f"load {n}", **row, smi=smi)
            out["heartbeats"] = _fed_heartbeats(plane)
            out["stall_max_s"] = plane.stall_max_s
            out["gc_pauses"] = gc_fed
            if ingest:
                apps_before = _compute_apps()
                plane.spawn_worker(FED_WORKERS, role="ingest")
                if not plane.wait_ready(FED_WORKERS + 1, timeout_s=300.0):
                    fail(f"federation: the ingest worker never joined: "
                         f"{plane.worker_table()}")
                plane.register_clusters({
                    f"c{j}": {"digest": f"smoke-{j}", "services": 20,
                              "seed": j, "namespace": "synthetic"}
                    for j in range(2)})
                t_end = time.perf_counter() + 120.0
                while time.perf_counter() < t_end and min(
                        c["ticks"] for c in plane.ingest_status().values()
                ) < 3:
                    time.sleep(0.05)
                apps = _compute_apps()
                hello = _fed_hellos(plane)[str(FED_WORKERS)]
                status = plane.ingest_status()
                out["ingest"] = {
                    "hello": hello, "clusters": status,
                    "compute_apps_before": len(apps_before),
                    "compute_apps_after": len(apps),
                    "compute_apps": apps}
                # this process and its serve workers hold a context each;
                # a listing that shows fewer could not see the ingest
                # worker's either
                if (hello["local_devices"] is not None
                        or hello["headroom"] is not None
                        or len(apps_before) < FED_WORKERS + 1
                        or len(apps) > len(apps_before)
                        or min(c["ticks"] for c in status.values()) < 3):
                    fail(f"federation: the ingest worker touched the card "
                         f"or never ticked: {out['ingest']}")
                phase("federation", leg=f"ingest worker beside {n}",
                      **out["ingest"])
            out["double_completions"] = plane.sink.double_completions
            out["stale_responses"] = plane.stale_responses
            out["reroutes"] = plane.reroutes
            out["fault_classes"] = plane.fault_classes_observed()
            t1 = time.perf_counter()
            reports = plane.drain_all(timeout_s=120.0)
            out["drain_s"] = time.perf_counter() - t1
        finally:
            plane.stop()
    serve_reports = {wid: r for wid, r in reports.items()
                     if wid < FED_WORKERS}
    if sorted(serve_reports) != list(range(FED_WORKERS)):
        fail(f"federation at {n}: drain reports {sorted(reports)}")
    if (out["double_completions"] or out["stale_responses"]
            or out["reroutes"] or out["fault_classes"]):
        fail(f"federation at {n}: a fault in a clean load: "
             f"{out['double_completions']} double completions, "
             f"{out['stale_responses']} stale, {out['reroutes']} reroutes, "
             f"{out['fault_classes']}; lease {out['lease_ttl_s']} s, "
             f"heartbeats {out['heartbeats']}, this process's longest "
             f"stall {out['stall_max_s']} s, collections {out['gc_pauses']}"
             )
    batches = sum(r["device_batches"] for r in serve_reports.values())
    launches = {k: sum(r["launches"][k] for r in serve_reports.values())
                for k in next(iter(serve_reports.values()))["launches"]}
    want = main_launches(n, batches)
    if launches != want or not batches:
        fail(f"federation at {n}: the workers launched {launches} over "
             f"{batches} device batches, not {want}")
    out.update(device_batches=batches, launches=launches,
               persist_launches={k: sum(r["persist_launches"][k]
                                        for r in serve_reports.values())
                                 for k in ("evidence_front",
                                           "evidence_front_fused")},
               workers={str(wid): {
                   "served": r["served"],
                   "device_batches": r["device_batches"],
                   "rows": [row for row in r["kernel_rows"]
                            if row["variant"] == "dense"]}
                   for wid, r in sorted(serve_reports.items())})
    rows = [row for w in out["workers"].values() for row in w["rows"]]
    if not rows or any(row["winner"] != "kernels" for row in rows):
        fail(f"federation at {n}: a worker served without the kernels "
             f"row: {out['workers']}")
    out["frame_codec"] = _fed_codec(case, feats[0], 5 if n <= 2047 else 3)
    phase("federation", leg=f"load {n} workers",
          frame_codec=out["frame_codec"], startup_s=out["startup_s"],
          worker_startup_s=out["worker_startup_s"], hellos=out["hellos"],
          lease_ttl_s=out["lease_ttl_s"], heartbeats=out["heartbeats"],
          stall_max_s=out["stall_max_s"], gc_pauses=out["gc_pauses"],
          workers=out["workers"], device_batches=batches,
          launches={k: v for k, v in launches.items() if v},
          double_completions=0, stale_responses=0, reroutes=0, smi=smi)
    return out


def _fed_kill_wave(device, smi) -> dict:
    """``federation_selftest(workers=3, kill_worker=True)`` at 2047
    services: one worker SIGKILLed mid-wave.  The workers carry no
    ``RCA_KERNEL``: they inherit ``RCA_KERNEL_CACHE`` and read the row this
    process elected for the shape, so no worker races it again."""
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.engine import GraphEngine
    from rca_tpu_torch.engine.registry import KernelRegistry
    from rca_tpu_torch.serve.federation import federation_selftest

    cache = os.environ.get("RCA_KERNEL_CACHE", "off")
    case = synthetic_cascade_arrays(2047, n_roots=1, seed=0)
    f, s, _ = GraphEngine(device="cpu")._pad(case.features, case.dep_src,
                                             case.dep_dst)
    # the election, once, in this process: a fresh registry reads the
    # shape's row from the cache file or times it and writes it there
    elected = KernelRegistry().resolve(f.shape[0], len(s), device=device)
    t0 = time.perf_counter()
    out = federation_selftest(
        workers=FED_WORKERS, n_requests=36, seed=0, kill_worker=True,
        services=(2047,), device=device, heartbeat_s=0.5,
        worker_env={"RCA_KERNEL_CACHE": cache}, ready_timeout_s=300.0,
        timeout_s=300.0)
    out["seconds"] = time.perf_counter() - t0
    out["elected"] = {"n_pad": elected.n_pad, "e_pad": elected.e_pad,
                      "winner": elected.winner, "source": elected.source}
    statuses = set(out["by_status"])
    rows = [row for r in out["drain_reports"].values()
            for row in r.get("kernel_rows", [])
            if row["variant"] == "dense"]
    if (not out["ok"] or not out["parity_ok"] or statuses - {"ok", "shed"}
            or out["double_completions"] or out.get("recovery_ms") is None
            or "process_kill" not in out["fault_classes_observed"]
            or len(out["drain_reports"]) != FED_WORKERS - 1):
        fail("federation kill wave: " + json.dumps(
            {k: v for k, v in out.items() if k != "worker_table"},
            default=str))
    if device != "cpu" and (elected.winner != "kernels" or not rows or any(
            (row["winner"], row["source"]) != ("kernels", "cache")
            for row in rows)):
        fail(f"federation kill wave: a worker elected its own row: "
             f"{rows} (this process elected {out['elected']})")
    keep = ("ok", "workers", "requests", "startup_s", "by_status",
            "parity_checked", "parity_ok", "double_completions",
            "stale_responses", "reroutes", "fault_classes_observed",
            "killed_worker", "recovery_ms", "detect_ms", "seconds",
            "elected", "hellos")
    summary = {k: out[k] for k in keep if k in out}
    summary["worker_rows"] = {wid: [
        {k: row[k] for k in ("n_pad", "e_pad", "winner", "source")}
        for row in r.get("kernel_rows", []) if row["variant"] == "dense"]
        for wid, r in out["drain_reports"].items()}
    summary["worker_launches"] = {
        wid: {k: v for k, v in r["launches"].items() if v}
        for wid, r in out["drain_reports"].items()}
    phase("federation", leg="kill wave 2047", **summary, smi=smi)
    return summary


def _fed_commands(case, device, smi, cli=(), chaos: bool = True) -> dict:
    """The federation's commands as subprocesses on the card, the
    workers under ``RCA_KERNEL=kernels``: ``serve --federation 3
    --kill-worker``, ``ingest`` and ``serve --listen --federation 2``
    (a few requests over the wire, each bitwise its solo analysis, and
    ``fleet URL`` against it) together; then, with ``chaos``, ``chaos
    --ticks 200 --no-autoscale`` alone, whose federation and ingest legs
    must observe ``process_kill``, ``worker_hang``,
    ``coordinator_partition`` and ``ingest_death`` (the full run leaves
    it to the autoscale phase's ``chaos --ticks 200``, which runs the
    same legs and the storm)."""
    import signal

    import numpy as np
    from rca_tpu_torch.engine import GraphEngine
    from rca_tpu_torch.gateway import GatewayClient
    from rca_tpu_torch.util.threads import make_thread

    cmd = [sys.executable, "-m", "rca_tpu_torch"]
    env = {**os.environ, **FED_ENV}
    out = {}
    t0 = time.perf_counter()
    procs, listen = {}, None
    try:
        # ``ingest`` takes no --device: its workers never touch the card
        for label, argv in (
                ("serve_federation_kill", ["serve", "--federation", "3",
                                           "--kill-worker", "--compact",
                                           *cli]),
                ("ingest", ["ingest", "--workers", "2", "--clusters", "3",
                            "--duration", "3", "--compact"])):
            procs[label] = subprocess.Popen(
                [*cmd, *argv], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        listen = subprocess.Popen(
            [*cmd, "serve", "--listen", "127.0.0.1:0", "--federation", "2",
             *cli], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        banner: list = []
        reader = make_thread(lambda: banner.append(listen.stdout.readline()),
                             name="smoke-federation-banner", daemon=True)
        reader.start()
        reader.join(300)
        if not banner or not banner[0]:
            err = listen.communicate(timeout=60)[1] \
                if listen.poll() is not None else ""
            fail(f"serve --listen --federation 2 printed no banner in 300 s "
                 f"(exit {listen.poll()}): {err[-2000:]}")
        info = json.loads(banner[0])
        if info.get("workers") != 2 or "control" not in info:
            fail(f"serve --listen --federation 2 banner: {info}")
        host, port = info["listening"].rsplit(":", 1)
        client = GatewayClient(host, int(port), timeout_s=300)
        with mock.patch.dict(os.environ, FED_ENV):
            oracle = GraphEngine(device=device)
            rng = np.random.default_rng(18)
            wire = []
            for i, f in enumerate(_serve_features(case, rng, 4)):
                code, body, _ = client.analyze(
                    f, case.dep_src, case.dep_dst, names=case.names,
                    tenant=f"t{i}", k=SERVE_K)
                want = oracle.analyze_arrays(f, case.dep_src, case.dep_dst,
                                             case.names, k=SERVE_K).ranked
                _wire_ok(f"serve --listen --federation 2, request {i}",
                         code, body, want)
                wire.append(code)
        fleet = subprocess.run([*cmd, "fleet", f"http://{host}:{port}"],
                               capture_output=True, text=True, timeout=120)
        rows = fleet.stdout.splitlines()
        if fleet.returncode != 0 or len(rows) < 4 or [
                r.split()[1] for r in rows[1:3]] != ["live", "live"]:
            fail(f"fleet exited {fleet.returncode}: {fleet.stdout[-1500:]}"
                 f"{fleet.stderr[-1500:]}")
        listen.send_signal(signal.SIGTERM)
        _, err = listen.communicate(timeout=120)
        if listen.returncode != 0:
            fail(f"serve --listen --federation 2 exited "
                 f"{listen.returncode}: {err[-2000:]}")
        out["serve_listen_federation"] = {
            "exit": 0, "wire_codes": wire, "fleet_rows": rows[:3],
            "fleet_line": json.loads(rows[-1])}
        for label, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            if p.returncode != 0:
                fail(f"{label} exited {p.returncode}: {stderr[-2000:]}")
            body = json.loads(stdout.strip().splitlines()[-1])
            if not body["ok"]:
                fail(f"{label}: {body}")
            if label == "ingest":
                out[label] = {"exit": 0, "clusters": {
                    c: {k: v[k] for k in ("owner", "epoch", "ticks",
                                          "double_applied")}
                    for c, v in body["clusters"].items()},
                    "double_applied": body["double_applied"]}
            else:
                out[label] = {"exit": 0, **{k: body.get(k) for k in (
                    "by_status", "parity_checked", "parity_ok",
                    "double_completions", "stale_responses", "reroutes",
                    "fault_classes_observed", "recovery_ms",
                    "startup_s")}}
    finally:
        for p in [*procs.values(), listen]:
            if p is not None and p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    out["together_s"] = time.perf_counter() - t0
    phase("federation", leg="commands", **out, smi=smi)
    if chaos:
        out["chaos"] = _chaos_command(env, smi, "federation",
                                      ["--no-autoscale", *cli])
    return out


#: what ``chaos --ticks 200`` must observe, without and with its
#: ``scaling_storm`` leg
CHAOS_CLASSES = ("process_kill", "worker_hang", "coordinator_partition",
                 "ingest_death")


def _chaos_command(env, smi, label: str, argv) -> dict:
    """``chaos --ticks 200`` as a subprocess (``argv`` adds its flags):
    exit 0, every fault class of its legs observed (``scaling_storm``
    too unless ``--no-autoscale``); a failure names each gate."""
    return _chaos_finish(_chaos_start(env, argv), smi, label)


def _chaos_start(env, argv) -> dict:
    """Start ``chaos --ticks 200`` (``argv`` adds its flags), its output to
    files; :func:`_chaos_finish` holds it to its gates."""
    handle = _side_start("-m", "rca_tpu_torch", "chaos", "--ticks", "200",
                         "--compact", *argv, env=env, script=False)
    handle["argv"] = list(argv)
    return handle


def _chaos_finish(handle, smi, label: str) -> dict:
    """The started ``chaos --ticks 200``'s gates (:func:`_chaos_command`),
    ``seconds`` from its start."""
    argv = handle["argv"]
    code, stdout, stderr = _side_wait(handle, timeout=900)
    try:
        report = json.loads(stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        report = {}
    legs = [leg for leg in ("federation", "autoscale", "ingest")
            if leg in report]
    gates = {
        "exit": code,
        "uncaught_exceptions": report.get("uncaught_exceptions"),
        "parity_ok": report.get("parity_ok"),
        "all_classes_observed": report.get("all_classes_observed"),
        "recompiles_post_warm": report.get("kernelscope", {}).get(
            "recompiles_post_warm"),
        "memory_gate": report.get("kernelscope", {}).get("memory_gate"),
        **{f"{leg}_ok": report[leg].get("ok") for leg in legs}}
    classes = sorted({c for leg in legs
                      for c in report[leg].get("fault_classes_observed", [])})
    want = set(CHAOS_CLASSES) | (
        set() if "--no-autoscale" in argv else {"scaling_storm"})
    if code != 0 or not want <= set(classes):
        fail(f"chaos --ticks 200 {' '.join(argv)} ({label}): {gates}, "
             f"observed {classes}; "
             + "; ".join(f"{leg}: {json.dumps(report[leg], default=str)[:1200]}"
                         for leg in legs if not report[leg].get("ok"))
             + f" {stderr[-1500:]}")
    out = {
        **gates, "seconds": handle["seconds"],
        "fault_classes_observed": classes,
        "federation": {k: report["federation"][k] for k in (
            "requests", "by_status", "double_completions",
            "stale_responses", "reroutes", "rejoins",
            "detect_lag_ms_max", "phases")},
        "ingest": {k: report["ingest"][k] for k in (
            "victim", "victim_clusters", "double_applied",
            "stale_stats_dropped")}}
    if "autoscale" in report:
        out["autoscale"] = {k: report["autoscale"][k] for k in (
            "ok", "requests", "by_status", "double_completions",
            "stale_responses", "stale_bound", "reroutes", "phases")}
    phase(label, leg="chaos", **out, smi=smi)
    return out


def _fed_nccl(device, smi) -> dict:
    """``initialize_distributed`` with a named coordinator, world size 1,
    NCCL on the card (gloo for ``device="cpu"``): its dict, one
    all-reduce, then the group destroyed."""
    import socket

    import torch
    import torch.distributed as dist
    from rca_tpu_torch.parallel.distributed import (
        initialize_distributed,
        shutdown_distributed,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    info = initialize_distributed(f"127.0.0.1:{port}", num_processes=1,
                                  process_id=0, device=device)
    backend = dist.get_backend()
    x = torch.ones(4, device=device)
    dist.all_reduce(x)
    total = float(x.sum().item())
    shutdown_distributed()
    out = {"info": info, "backend": backend, "all_reduce_sum": total,
           "destroyed": not dist.is_initialized(),
           "seconds": time.perf_counter() - t0}
    want = "gloo" if device == "cpu" else "nccl"
    if (backend != want or not info["initialized"] or total != 4.0
            or info["process_count"] != 1 or not out["destroyed"]):
        fail(f"initialize_distributed: {out}")
    phase("federation", leg="initialize_distributed", **out, smi=smi)
    return out


def federation_phase(cases, smi: str, device="cuda", cli=(),
                     chaos: bool = True) -> dict:
    """The cross-process serve plane on the card: the load legs (3 worker
    processes, ``RCA_KERNEL=kernels``) at 2047 services (the serve cell's
    64-request mix) and at 49,999 (4 requests, 15 MB bodies), each in
    turns with an in-process pool; the kill wave; the commands (``chaos``
    also ``chaos --ticks 200 --no-autoscale``); the NCCL bootstrap."""
    import numpy as np

    t_phase = time.perf_counter()
    out = {}
    rng = np.random.default_rng(18)
    small, big = TIERS[0][0], TIERS[-1][0]
    # 2047 runs on the plane's default lease, so a worker declared dead
    # under ordinary load fails here; at 49,999 a 15 MB body holds the
    # interpreter lock for ~0.5 s on either side, and that leg's leases
    # get room (5 s)
    out[str(small)] = _fed_load_leg(
        small, cases[small], _serve_features(cases[small], rng), device, smi,
        ingest=True)
    out[str(big)] = _fed_load_leg(
        big, cases[big], _serve_features(cases[big], rng,
                                         FED_BIG_REQUESTS),
        device, smi, heartbeat_s=1.0, lease_misses=5)
    out["kill_wave"] = _fed_kill_wave(device, smi)
    out["commands"] = _fed_commands(cases[small], device, smi, cli, chaos)
    out["nccl"] = _fed_nccl(device, smi)
    out["seconds"] = time.perf_counter() - t_phase
    phase("federation", seconds=out["seconds"], smi=smi)
    return out


AUTOSCALE_SERVICES = 2047
#: the process leg's fleet bounds and closed-loop submitters
AUTOSCALE_PROC = (2, 4)
AUTOSCALE_THREADS = 12


def _main_path_per_batch(launches: dict, batches: int, label: str) -> None:
    """Fail unless ``launches`` over ``batches`` device batches are
    exactly the main path's at 2047 services (1 / 1 / 1 a batch)."""
    want = main_launches(AUTOSCALE_SERVICES, batches)
    if launches != want or not batches:
        fail(f"autoscale ({label}): {launches} over {batches} device "
             f"batches, not {want}")


def _kept_parity(oracle, kept, label: str) -> int:
    """Every terminal, every ok answer bitwise its solo analysis here."""
    checked = 0
    for req in kept:
        if not req.done():
            fail(f"autoscale ({label}): request {req.request_id} never "
                 f"completed")
        resp = req.response
        if resp.status != "ok":
            continue
        want = oracle.analyze_arrays(req.features, req.dep_src, req.dep_dst,
                                     req.names, k=req.k).ranked
        if resp.ranked != [dict(r) for r in want]:
            fail(f"autoscale ({label}): request {req.request_id} differs "
                 f"from its solo analysis")
        checked += 1
    return checked


@contextlib.contextmanager
def _plane_tables(tables: list):
    """Keep each ``FederationPlane``'s worker table and events as it
    stops (the soaks build their own planes)."""
    from rca_tpu_torch.serve.federation import FederationPlane

    stop = FederationPlane.stop

    def keep(self, *args, **kwargs):
        tables.append({"workers": self.worker_table(),
                       "events": list(self.events),
                       "stall_max_s": self.stall_max_s})
        return stop(self, *args, **kwargs)

    with mock.patch.object(FederationPlane, "stop", keep):
        yield


def _autoscale_thread_leg(device, smi) -> dict:
    """``run_scale_ramp_soak(seed=0, min_workers=2, max_workers=8)`` at
    2047 services on the card (``FED_ENV``): the reference's gates, every
    ok answer bitwise its solo analysis here, no double completion, and
    the launches over the soak exactly the main path's per device batch
    of the thread fleet (one engine, the counters of this process)."""
    from rca_tpu_torch.engine import GraphEngine
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches
    from rca_tpu_torch.serve import autoscale
    from rca_tpu_torch.serve.federation import FederationPlane

    kept, members, tables = [], [], []
    submit = FederationPlane.submit

    def keep(self, req):
        kept.append(req)
        return submit(self, req)

    class Member(autoscale.ThreadWorker):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            members.append(self)

    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, FED_ENV), \
            mock.patch.object(FederationPlane, "submit", keep), \
            mock.patch.object(autoscale, "ThreadWorker", Member), \
            _plane_tables(tables):
        oracle = GraphEngine(device=device)
        reset_launches()
        out = autoscale.run_scale_ramp_soak(
            seed=0, min_workers=2, max_workers=8,
            services=(AUTOSCALE_SERVICES,), device=device)
        launches = dict(LAUNCHES)
        batches = sum(m.loop.device_batches for m in members)
        checked = _kept_parity(oracle, kept, "thread soak")
    out["seconds"] = time.perf_counter() - t0
    if not out["ok"] or out["double_completions"] or not checked:
        fail("autoscale (thread soak): " + json.dumps(out, default=str))
    _main_path_per_batch(launches, batches, "thread soak")
    table = tables[-1]
    keys = ("ok", "requests", "by_status", "ramp_up_s", "ramp_down_s",
            "scale_ups", "scale_downs", "request_ms_p50", "request_ms_p99",
            "queue_ms_p99_after_up", "queue_ms_p99_final",
            "scale_decision_ms_p50", "placement", "placement_hit_rate",
            "double_completions", "stale_responses", "reroutes", "seconds")
    leg = {**{k: out[k] for k in keys}, "members": len(members),
           "parity_checked": checked, "device_batches": batches,
           "launches": launches,
           "worker_downs": [e for e in table["events"]
                            if e["event"] == "worker_down"],
           "heartbeats": {str(w["worker_id"]): w["hb_send_gap_max_s"]
                          for w in table["workers"]},
           "stall_max_s": table["stall_max_s"]}
    phase("autoscale", leg="thread 2->8->2 at 2047", **{
        k: v for k, v in leg.items() if k != "launches"},
        launches={k: v for k, v in launches.items() if v}, smi=smi)
    return leg


def _autoscale_process_leg(case, device, smi) -> dict:
    """A ``FederationPlane(workers=2)`` of worker processes at 2047 on the
    default lease, an ``AutoscaleController`` on the plane's own
    ``spawn_worker`` with the soak's fast table inside 2..4, and a
    closed-loop load (``AUTOSCALE_THREADS`` submitters until the fleet
    peaks, then one trickle until it is back at 2): every request
    terminal and every ok answer bitwise solo here, no double completion,
    reroute or ``worker_down``, each worker reading the row this process
    elected from ``RCA_KERNEL_CACHE``, ``nvidia-smi``'s contexts two more
    at the peak and back at the end, and the launches summed over the
    four drain reports the main path's per device batch."""
    import threading

    import numpy as np
    from rca_tpu_torch.config import ServeConfig
    from rca_tpu_torch.engine import GraphEngine
    from rca_tpu_torch.engine.registry import KernelRegistry
    from rca_tpu_torch.serve.autoscale import (
        AutoscaleController,
        ScaleRule,
        ScaleRuleSet,
    )
    from rca_tpu_torch.serve.federation import FederationPlane
    from rca_tpu_torch.serve.request import ServeRequest
    from rca_tpu_torch.util.threads import make_lock, make_thread

    lo, hi = AUTOSCALE_PROC
    cache = os.environ.get("RCA_KERNEL_CACHE", "off")
    # the soak's table (rca_tpu_torch/serve/autoscale.py,
    # run_scale_ramp_soak)
    rules = ScaleRuleSet(rules=(
        ScaleRule("soak-depth", "queue_depth", ">", 4.0, 0.10, "up", 2),
        ScaleRule("soak-occupancy", "occupancy", ">", 0.85, 0.15, "up", 2),
        ScaleRule("soak-idle", "occupancy", "<", 0.20, 0.70, "down", 2),
    ))
    f, s, _ = GraphEngine(device="cpu")._pad(case.features, case.dep_src,
                                             case.dep_dst)
    out = {"services": AUTOSCALE_SERVICES, "bounds": f"{lo}:{hi}"}
    kept, lock = [], make_lock("smoke.autoscale.kept")
    rng = np.random.default_rng(19)
    surge, stop = threading.Event(), threading.Event()

    def one() -> ServeRequest:
        with lock:
            feats = np.clip(case.features + rng.uniform(
                0, 0.05, case.features.shape), 0, 1).astype(np.float32)
        req = ServeRequest(tenant=f"as-{len(kept) % 3}", features=feats,
                           dep_src=case.dep_src, dep_dst=case.dep_dst,
                           names=case.names, k=3)
        with lock:
            kept.append(req)
        return req

    def closed_loop(trickle: bool) -> None:
        while not stop.is_set() and (trickle or not surge.is_set()):
            req = one()
            plane.submit(req)
            try:
                req.result(120.0)
            except TimeoutError:
                pass
            if trickle:
                stop.wait(0.05)

    with mock.patch.dict(os.environ, {"RCA_SHARD": "0"}):
        elected = KernelRegistry().resolve(f.shape[0], len(s), device=device)
        oracle = GraphEngine(device=device)
        plane = FederationPlane(
            workers=lo, config=ServeConfig(max_batch=16, queue_cap=1024),
            device=device, window=4,
            worker_env={"RCA_KERNEL_CACHE": cache, "RCA_SHARD": "0"})
        controller = AutoscaleController(
            plane, min_workers=lo, max_workers=hi, rules=rules,
            cooldown_s=0.35, interval_s=0.05)
        plane.start()
        threads = []
        try:
            if not plane.wait_ready(lo, timeout_s=300.0):
                fail(f"autoscale (process): {plane.worker_table()}")
            apps_before = _compute_apps()
            controller.start(spawn_min=False)
            t0 = time.perf_counter()
            threads = [make_thread(closed_loop, name=f"smoke-as-{i}",
                                   daemon=True, args=(False,))
                       for i in range(AUTOSCALE_THREADS)]
            for t in threads:
                t.start()
            t_end = t0 + 300.0
            while (time.perf_counter() < t_end
                   and len(plane.scale_status()["live"]) < hi):
                time.sleep(0.05)
            out["ramp_up_s"] = time.perf_counter() - t0
            out["peaked"] = len(plane.scale_status()["live"]) >= hi
            apps_peak = _compute_apps()
            surge.set()
            for t in threads:
                t.join(180.0)
            trickle = make_thread(closed_loop, name="smoke-as-trickle",
                                  daemon=True, args=(True,))
            threads.append(trickle)
            t1 = time.perf_counter()
            trickle.start()
            t_end = t1 + 120.0
            while (time.perf_counter() < t_end
                   and len(plane.scale_status()["live"]) > lo):
                time.sleep(0.05)
            out["ramp_down_s"] = time.perf_counter() - t1
            out["shrunk"] = len(plane.scale_status()["live"]) <= lo
            stop.set()
            trickle.join(180.0)
            controller.stop()
            # the drained workers' processes end; their contexts with them
            t_end = time.perf_counter() + 60.0
            apps_end = _compute_apps()
            while (len(apps_end) > len(apps_before)
                   and time.perf_counter() < t_end):
                time.sleep(0.5)
                apps_end = _compute_apps()
            resps = [r.result(120.0) for r in kept]
            out["heartbeats"] = _fed_heartbeats(plane)
            out["stall_max_s"] = plane.stall_max_s
            out["double_completions"] = plane.sink.double_completions
            out["stale_responses"] = plane.stale_responses
            out["reroutes"] = plane.reroutes
            out["fault_classes"] = plane.fault_classes_observed()
            out["decisions"] = [
                {k: d.get(k) for k in ("rule", "action", "from", "to",
                                       "spawning", "workers", "decision_ms")}
                for d in controller.decisions if d["action"] in ("up",
                                                                 "down")]
            out["clamps_while_spawning"] = sum(
                1 for d in controller.decisions
                if d["action"] == "clamped" and d.get("spawning"))
            events = list(plane.events)
            reports = plane.drain_all(timeout_s=120.0)
        finally:
            stop.set()
            surge.set()
            controller.stop()
            for t in threads:
                t.join(30.0)
            plane.stop()
    for e in events + list(plane.events):
        if e["event"] == "worker_drained" and e["worker_id"] not in reports:
            reports[e["worker_id"]] = {k: v for k, v in e.items()
                                       if k not in ("event", "worker_id",
                                                    "t")}
    spawned = {e["worker_id"]: e["t"] for e in events
               if e["event"] == "worker_spawned"}
    out["spawn_to_lease_s"] = {
        str(e["worker_id"]): e["t"] - spawned[e["worker_id"]]
        for e in events if e["event"] == "worker_joined"
        and e["worker_id"] in spawned}
    out["scale_ups"] = sum(e["event"] == "scale_up" for e in events)
    out["scale_downs"] = sum(e["event"] == "scale_down" for e in events)
    by_status: dict = {}
    for r in resps:
        by_status[r.status] = by_status.get(r.status, 0) + 1
    out.update(requests=len(kept), by_status=by_status,
               parity_checked=_kept_parity(oracle, kept, "process"),
               compute_apps_before=len(apps_before),
               compute_apps_peak=len(apps_peak),
               compute_apps_end=len(apps_end), compute_apps=apps_peak,
               elected={"winner": elected.winner, "source": elected.source})
    walls = sorted(1e3 * (r.completed_at - q.enqueued_at)
                   for q, r in zip(kept, resps) if r.status == "ok")
    if walls:
        out["e2e_ms_p50"] = walls[len(walls) // 2]
        out["e2e_ms_p99"] = walls[min(len(walls) - 1,
                                      int(len(walls) * 0.99))]
    rows = {wid: [(row["winner"], row["source"])
                  for row in r.get("kernel_rows", [])
                  if row["variant"] == "dense"]
            for wid, r in reports.items()}
    out["worker_rows"] = {str(w): v for w, v in sorted(rows.items())}
    batches = sum(r.get("device_batches", 0) for r in reports.values())
    launches = {k: sum(r["launches"][k] for r in reports.values())
                for k in next(iter(reports.values()))["launches"]} \
        if reports else {}
    out.update(device_batches=batches, launches=launches,
               drain_reports=sorted(reports))
    phase("autoscale", leg="process 2->4->2 at 2047", **{
        k: v for k, v in out.items() if k != "launches"},
        launches={k: v for k, v in launches.items() if v}, smi=smi)
    problems = []
    if not (out["peaked"] and out["shrunk"]):
        problems.append("the fleet did not walk 2->4->2")
    if by_status != {"ok": len(kept)}:
        problems.append(f"statuses {by_status}")
    if (out["double_completions"] or out["reroutes"]
            or out["fault_classes"]):
        problems.append("a fault in a clean leg")
    if sorted(reports) != list(range(hi)):
        problems.append(f"drain reports {sorted(reports)}")
    if device != "cpu" and (elected.winner != "kernels" or any(
            v != [("kernels", "cache")] for v in rows.values())):
        problems.append(f"a worker did not read the elected row: {rows}")
    if not (len(apps_peak) == len(apps_before) + hi - lo
            and len(apps_end) == len(apps_before)):
        problems.append("the contexts did not follow the fleet")
    if problems:
        fail(f"autoscale (process): {problems}")
    _main_path_per_batch(launches, batches, "process")
    return out


#: the plane events a storm's fault timeline keeps
TIMELINE_EVENTS = ("worker_joined", "rejoin", "worker_down",
                   "partition_start", "stale_lease_rejected",
                   "drain_started", "worker_scaled_down")


def _fault_timeline(events) -> list:
    """The plane's fault events, ms from the first: joins, rejoins, downs
    (with their class and detection lag), partitions, stale leases and
    drains — what it takes to read a storm that downs a worker twice."""
    kept = [e for e in events if e["event"] in TIMELINE_EVENTS]
    t0 = kept[0]["t"] if kept else 0.0
    return [[round((e["t"] - t0) * 1e3, 1), e["event"], e["worker_id"],
             e.get("class"), e.get("detect_lag_ms")] for e in kept]


def _autoscale_storms(device, smi) -> dict:
    """``run_scaling_storm(seed=7)`` in thread mode, then over worker
    processes (``FED_ENV``): each ``ok``, ``scaling_storm`` observed, no
    double completion, stale drops within their bound, and no worker
    down but the three the races kill, hang and partition; over
    processes ``nvidia-smi``'s contexts back to their count before the
    storm once it ends (its first race SIGKILLs a worker the moment it
    joins, its context freshly built)."""
    from rca_tpu_torch.serve.autoscale import run_scaling_storm

    out = {}
    for mode in ("thread", "process"):
        tables = []
        apps_before = _compute_apps()
        t0 = time.perf_counter()
        with mock.patch.dict(os.environ, FED_ENV), _plane_tables(tables):
            res = run_scaling_storm(seed=7, worker_mode=mode, device=device)
        res["seconds"] = time.perf_counter() - t0
        t_end = time.perf_counter() + 60.0
        apps = _compute_apps()
        while len(apps) > len(apps_before) and time.perf_counter() < t_end:
            time.sleep(0.5)
            apps = _compute_apps()
        res["compute_apps_before"] = len(apps_before)
        res["compute_apps_after"] = len(apps)
        downs = sorted((e["worker_id"], e.get("class"))
                       for e in tables[-1]["events"]
                       if e["event"] == "worker_down")
        ph = res["phases"]
        want = sorted([(ph[0]["worker"], "process_kill"),
                       (ph[1]["worker"], "worker_hang"),
                       (ph[2]["partitioned"], "coordinator_partition")])
        res["worker_downs"] = downs
        res["heartbeats"] = {str(w["worker_id"]): w["hb_send_gap_max_s"]
                             for w in tables[-1]["workers"]}
        res["stall_max_s"] = tables[-1]["stall_max_s"]
        res["timeline"] = _fault_timeline(tables[-1]["events"])
        phase("autoscale", leg=f"scaling_storm {mode}", **res, smi=smi)
        if (not res["ok"] or "scaling_storm"
                not in res["fault_classes_observed"]
                or res["double_completions"]
                or res["stale_responses"] > res["stale_bound"]
                or downs != want or len(apps) != len(apps_before)):
            fail(f"autoscale (storm, {mode}): downs {downs}, want {want}, "
                 f"contexts {len(apps_before)} before, {len(apps)} after; "
                 f"timeline {res['timeline']}")
        out[mode] = res
    return out


def _autoscale_commands(case, device, smi, cli=()) -> dict:
    """``serve --autoscale 2:4`` and ``serve --listen 127.0.0.1:0
    --federation 2 --autoscale 2:4`` (4 wire requests at 2047, each
    bitwise its solo analysis; ``fleet URL`` showing the bounds ``2:4``
    and a running controller) as subprocesses at once, then ``chaos
    --ticks 200`` without ``--no-autoscale``, which must observe
    ``process_kill``, ``worker_hang``, ``coordinator_partition``,
    ``ingest_death`` and ``scaling_storm``."""
    import signal

    import numpy as np
    from rca_tpu_torch.engine import GraphEngine
    from rca_tpu_torch.gateway import GatewayClient
    from rca_tpu_torch.util.threads import make_thread

    cmd = [sys.executable, "-m", "rca_tpu_torch"]
    env = {**os.environ, **FED_ENV}
    out = {}
    soak = listen = None
    t0 = time.perf_counter()
    try:
        soak = subprocess.Popen(
            [*cmd, "serve", "--autoscale", "2:4", "--compact", *cli],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        listen = subprocess.Popen(
            [*cmd, "serve", "--listen", "127.0.0.1:0", "--federation", "2",
             "--autoscale", "2:4", *cli], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        banner: list = []
        reader = make_thread(lambda: banner.append(listen.stdout.readline()),
                             name="smoke-autoscale-banner", daemon=True)
        reader.start()
        reader.join(300)
        if not banner or not banner[0]:
            fail("serve --listen --federation 2 --autoscale 2:4 printed no "
                 "banner in 300 s")
        info = json.loads(banner[0])
        if info.get("autoscale") != "2:4" or info.get("workers") != 2:
            fail(f"serve --listen --autoscale banner: {info}")
        host, port = info["listening"].rsplit(":", 1)
        client = GatewayClient(host, int(port), timeout_s=300)
        with mock.patch.dict(os.environ, FED_ENV):
            oracle = GraphEngine(device=device)
            rng = np.random.default_rng(20)
            for i, f in enumerate(_serve_features(case, rng, 4)):
                code, body, _ = client.analyze(
                    f, case.dep_src, case.dep_dst, names=case.names,
                    tenant=f"t{i}", k=SERVE_K)
                want = oracle.analyze_arrays(f, case.dep_src, case.dep_dst,
                                             case.names, k=SERVE_K).ranked
                _wire_ok(f"serve --listen --autoscale, request {i}", code,
                         body, want)
        fleet = subprocess.run([*cmd, "fleet", f"http://{host}:{port}"],
                               capture_output=True, text=True, timeout=120)
        rows = fleet.stdout.splitlines()
        line = json.loads(rows[-1]) if rows else {}
        auto = line.get("autoscale") or {}
        if (fleet.returncode != 0 or auto.get("bounds") != "2:4"
                or auto.get("running") is not True):
            fail(f"fleet exited {fleet.returncode}: {fleet.stdout[-1500:]}"
                 f"{fleet.stderr[-1500:]}")
        listen.send_signal(signal.SIGTERM)
        _, err = listen.communicate(timeout=120)
        if listen.returncode != 0:
            fail(f"serve --listen --autoscale exited {listen.returncode}: "
                 f"{err[-2000:]}")
        out["serve_listen_autoscale"] = {"exit": 0, "banner": info,
                                         "fleet_rows": rows[:3],
                                         "fleet_line": line}
        stdout, stderr = soak.communicate(timeout=600)
        if soak.returncode != 0:
            fail(f"serve --autoscale 2:4 exited {soak.returncode}: "
                 f"{stdout[-1500:]} {stderr[-1500:]}")
        body = json.loads(stdout.strip().splitlines()[-1])
        out["serve_autoscale"] = {"exit": 0, **{k: body[k] for k in (
            "ok", "requests", "by_status", "ramp_up_s", "ramp_down_s",
            "request_ms_p50", "request_ms_p99", "scale_decision_ms_p50",
            "placement_hit_rate", "double_completions")}}
    finally:
        for p in (soak, listen):
            if p is not None and p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    out["together_s"] = time.perf_counter() - t0
    phase("autoscale", leg="commands", **out, smi=smi)
    return out


def autoscale_phase(cases, smi: str, device="cuda", cli=(),
                    chaos_beside: bool = False) -> dict:
    """The elastic fleet on the card: the thread soak 2→8→2 and the
    process fleet 2→4→2 at 2047, both storms, the commands, then ``chaos
    --ticks 200`` (which counts no context: with ``chaos_beside`` it is
    only started, ``out["chaos"]`` its handle, and the caller holds it to
    its gates with :func:`_chaos_finish` after the phases it runs
    beside)."""
    t_phase = time.perf_counter()
    case = cases[AUTOSCALE_SERVICES]
    out = {"thread": _autoscale_thread_leg(device, smi),
           "process": _autoscale_process_leg(case, device, smi),
           "storm": _autoscale_storms(device, smi),
           "commands": _autoscale_commands(case, device, smi, cli)}
    chaos = _chaos_start({**os.environ, **FED_ENV}, list(cli))
    if chaos_beside:
        out["chaos"] = chaos
    else:
        out["commands"]["chaos"] = _chaos_finish(chaos, smi, "autoscale")
    out["seconds"] = time.perf_counter() - t_phase
    phase("autoscale", seconds=out["seconds"], smi=smi)
    return out


LINT_SIZES = (2047, 49999)
#: graftspec's static rules: the lint's 15 rules must include them
GRAFTSPEC_RULES = ("dtype-discipline", "shape-contract")
#: the rsan leg: the cross-check's chaos soak, and the sanitized pool's
#: submitters and requests each at 2047 services
RSAN_SOAK_TICKS = 40
RSAN_SOAK_SERVICES = 20
RSAN_POOL_THREADS = 8
RSAN_POOL_EACH = 8


def _lint_launches(launches: dict) -> None:
    """The main path's kernels in specsan's legs: the fused front and the
    one-CTA recursions at 2047 and in the serve leg (the selftest's
    graphs are smaller), the front and one grid launch of each recursion
    a front above; the per-step kernels nowhere."""
    for leg, counts in launches.items():
        front = counts["evidence_front_fused"]
        if front < 1:
            fail(f"lint: no evidence_front_fused launch in {leg}: {counts}")
        if counts["seg_down_step"] or counts["seg_up_step"]:
            fail(f"lint: per-step launches in {leg}: {counts}")
        if leg in ("session@2047", "serve"):
            if counts["seg_down_steps"] < 1 or counts["seg_up_steps"] < 1:
                fail(f"lint: the fused recursions did not run in {leg}: "
                     f"{counts}")
        elif (counts["seg_down_steps_grid"], counts["seg_up_steps_grid"]) \
                != (front, front) or counts["seg_down_steps"] \
                or counts["seg_up_steps"]:
            fail(f"lint: {leg} is not 1 + 1 grid launches a front: "
                 f"{counts}")


def _rsan_soak(smi: str, device="cuda") -> dict:
    """``run_rsan_crosscheck(seed=7, soak_ticks=40, device="cuda")`` on
    the ``kernels`` row, every live poll of its soak counted from 0: ok,
    no contradiction and no observed race, at least 2 locks taken from
    at least 2 threads, 40 ticks with no uncaught exception, each tick
    the main path's launches (a degraded tick none or those), and the
    sanitizer off again after."""
    from rca_tpu_torch.analysis.concurrency import rsan
    from rca_tpu_torch.analysis.concurrency.crosscheck import (
        run_rsan_crosscheck,
    )
    from rca_tpu_torch.engine.live import LiveStreamingSession
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches

    polls = []
    real = LiveStreamingSession.poll

    def poll(self):
        reset_launches()
        out = real(self)
        polls.append({"launches": dict(LAUNCHES),
                      "degraded": bool(out.get("degraded"))})
        return out

    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, {"RCA_KERNEL": "kernels"}), \
            mock.patch.object(LiveStreamingSession, "poll", poll):
        report = run_rsan_crosscheck(seed=7, soak_ticks=RSAN_SOAK_TICKS,
                                     device=device)
    seconds = time.perf_counter() - t0
    soak = report["soak"] or {}
    if not report["ok"] or report["contradictions"] or \
            report["races_observed"] or len(
                report["multi_thread_locks"]) < 2 or soak.get(
                "ticks") != RSAN_SOAK_TICKS or soak.get(
                "uncaught_exceptions") or soak.get("kernel_paths") != {
                "kernels": RSAN_SOAK_TICKS} or rsan.enabled():
        fail("rsan cross-check: " + json.dumps({k: report[k] for k in (
            "ok", "contradictions", "races_observed", "multi_thread_locks",
            "stress", "soak")}, default=str))
    # the first poll is the soak's fault-free baseline session's
    want = main_launches(RSAN_SOAK_SERVICES)
    ticks = polls[1:]
    if len(polls) != RSAN_SOAK_TICKS + 1:
        fail(f"rsan soak: {len(polls)} polls, want {RSAN_SOAK_TICKS + 1}")
    for i, tick in enumerate(polls):
        if tick["launches"] != want and not (
                tick["degraded"] and not any(tick["launches"].values())):
            fail(f"rsan soak: poll {i} launched {tick['launches']} "
                 f"(degraded {tick['degraded']}), want {want}")
    totals = {k: sum(t["launches"][k] for t in ticks) for k in want}
    out = {"ok": True, "acquires": report["acquires"],
           "locks_observed": report["locks_observed"],
           "multi_thread_locks": report["multi_thread_locks"],
           "observed_edges": report["observed_edges"],
           "static_edges": len(report["static_edges"]),
           "stress": report["stress"], "soak_ticks": RSAN_SOAK_TICKS,
           "degraded_ticks": sum(t["degraded"] for t in ticks),
           "launches": totals, "per_tick": want,
           "crosscheck_ms": report["wall_ms"], "seconds": seconds}
    phase("lint", leg="rsan cross-check", **{
        k: v for k, v in out.items() if k not in ("launches", "per_tick")},
        launches={k: v for k, v in totals.items() if v}, smi=smi)
    return out


def _rsan_pool(case, smi: str, device="cuda") -> dict:
    """A started two-replica ``ServePool`` on the card at 2047 services
    with every lock sanitized (:func:`_pool_load` from 8 submitter
    threads, 64 requests over 4 tenants, replica 0 killed after its first
    device batch).  Every ok answer bitwise its solo analysis, no double
    completion, no observed race and no contradiction against the port's
    static order graph, the pool's, the queue's, the replicas' and the
    sink's locks taken from at least 2 threads, each device batch the
    main path's launches."""
    import numpy as np
    from rca_tpu_torch.analysis.concurrency import model_for, rsan
    from rca_tpu_torch.analysis.concurrency.crosscheck import (
        order_contradictions,
    )
    from rca_tpu_torch.analysis.core import repo_root
    from rca_tpu_torch.engine import GraphEngine

    t0 = time.perf_counter()
    total = RSAN_POOL_THREADS * RSAN_POOL_EACH
    feats = _serve_features(case, np.random.default_rng(211), total)
    oracle = GraphEngine(device=device)
    was = rsan.enabled()
    rsan.enable()
    rsan.RSAN.reset()
    try:
        # the pool is built with the sanitizer on: its locks are shims
        got = _pool_load(oracle, [(case, f) for f in feats], (case, case),
                         "", True, threads=RSAN_POOL_THREADS)
        edges = rsan.RSAN.order_edges()
        lock_threads = rsan.RSAN.lock_threads()
        races = rsan.RSAN.races_observed()
        acquires = rsan.RSAN.acquires
    finally:
        rsan.RSAN.reset()
        if not was:
            rsan.disable()
    contradictions = order_contradictions(
        model_for(repo_root()).static_order_edges(), edges)
    resps = got["responses"]
    bad = [r.status for r in resps if r.status not in ("ok", "degraded",
                                                        "error")]
    if bad or got["double_completions"] or races or contradictions or \
            got["breaker_state"]["0"] != "dead":
        fail(f"rsan pool: statuses {bad}, double completions "
             f"{got['double_completions']}, races {races}, contradictions "
             f"{contradictions}, breakers {got['breaker_state']}")
    oks = 0
    for i, r in enumerate(resps):
        if r.status != "ok":
            continue
        solo = oracle.analyze_arrays(feats[i], case.dep_src, case.dep_dst,
                                     case.names, k=SERVE_K)
        if not _same_as_solo(r.result, solo):
            fail(f"rsan pool: request {i} differs from its solo analysis")
        oks += 1
    if not oks:
        fail("rsan pool: no request answered ok")
    contended = ("ServePool._route_lock", "RequestQueue._cond",
                 "ReplicaWorker._lock", "CompletionSink._lock")
    for name in contended:
        if len(lock_threads.get(name, ())) < 2:
            fail(f"rsan pool: {name} taken from "
                 f"{lock_threads.get(name)} only")
    want = main_launches(case.n)
    for e in got["log"]:
        if e["launches"] != want:
            fail(f"rsan pool: replica {e['replica']} launched "
                 f"{e['launches']} for a batch of {e['width']}, want {want}")
    out = {"ok": True, "services": case.n, "requests": total,
           "threads": RSAN_POOL_THREADS,
           "by_status": {s: sum(r.status == s for r in resps)
                         for s in sorted({r.status for r in resps})},
           "parity_checked": oks, "double_completions": 0,
           "device_batches": got["device_batches"],
           "replica_batches": got["replica_batches"],
           "acquires": acquires, "order_edges": sorted(map(list, edges)),
           "lock_threads": {k: len(lock_threads[k]) for k in contended},
           "launches": {k: sum(e["launches"][k] for e in got["log"])
                        for k in want},
           "per_batch": want, "wall_s": got["wall_s"],
           "seconds": time.perf_counter() - t0}
    phase("lint", leg="rsan pool at 2047", **{
        k: v for k, v in out.items() if k not in ("launches", "per_batch")},
        launches={k: v for k, v in out["launches"].items() if v}, smi=smi)
    return out


def lint_phase(cases, smi: str, device="cuda", cli=()) -> dict:
    """The analysis plane on the card: the lint and the CLI's runtime
    checks as one subprocess while specsan, then rsan, run here (the
    module docstring, item 24).  ``device`` / ``cli`` rehearse it on the
    CPU (``"cpu"``, ``("--device", "cpu")``)."""
    from rca_tpu_torch.analysis.core import (
        default_baseline_path,
        load_baseline,
    )
    from rca_tpu_torch.analysis.dataplane.contracts import FETCH_BUDGETS
    from rca_tpu_torch.analysis.dataplane.specsan import (
        SHARDED_SURFACES,
        run_legs,
        run_specsan,
    )

    t_phase = time.perf_counter()
    print(smi, flush=True)
    # one interpreter, one torch import, one CUDA context and one parse of
    # the tree for the rules, tracecheck, rsan and specsan
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "rca_tpu_torch", "lint", "--all", "--json",
         *cli],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # the legs uncaptured first: they elect every shape's row, and
        # the captured run must equal them bitwise
        plain = run_legs(None, seed=0, services=LINT_SIZES, device=device)
        t1 = time.perf_counter()
        report = run_specsan(seed=0, services=LINT_SIZES, device=device)
        specsan_s = time.perf_counter() - t1
        # rsan is process-global: its legs run after specsan, never beside
        rsan_soak = _rsan_soak(smi, device)
        rsan_pool = _rsan_pool(cases[2047], smi, device)
        out, err = proc.communicate(timeout=600)
        process_s = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)

    # the CLI: exit 0, no finding, an empty baseline, every check ok
    try:
        lint = json.loads(out)
    except ValueError:
        fail(f"lint --all --json printed no JSON (exit {proc.returncode})"
             f": {out[-500:]} {err[-1500:]}")
    baseline = load_baseline(default_baseline_path())
    if proc.returncode != 0 or lint["findings"] or baseline \
            or lint["baselined"] or not lint["clean"]:
        fail(f"lint --all: exit {proc.returncode}, findings "
             f"{lint['findings'][:5]}, baseline {baseline[:5]}: "
             f"{err[-1500:]}")
    # the port's 15 rules, graftspec's static two among them
    per_rule = lint["per_rule_ms"]
    if len(per_rule) != 15 or not set(GRAFTSPEC_RULES) <= set(per_rule):
        fail(f"lint --all ran {sorted(per_rule)}, want 15 rules with "
             f"{GRAFTSPEC_RULES}")
    cli_rsan = lint["rsan"]
    if not (lint["tracecheck"]["ok"] and lint["specsan"]["ok"]
            and cli_rsan["ok"]) or cli_rsan["contradictions"] or \
            cli_rsan["races_observed"]:
        fail("lint --all: " + json.dumps({
            "tracecheck": lint["tracecheck"]["ok"],
            "specsan": lint["specsan"]["ok"], "rsan": cli_rsan},
            default=str)[:3000])
    phase("lint", leg="lint --all", exit=0,
          files_scanned=lint["files_scanned"], wall_ms=lint["wall_ms"],
          rules=len(per_rule),
          graftspec_ms={r: per_rule[r] for r in GRAFTSPEC_RULES},
          process_s=process_s, findings=0, baseline_entries=0,
          tracecheck=[e["entry"] for e in lint["tracecheck"]["entries"]],
          specsan_fetches=lint["specsan"]["fetches"],
          rsan={k: cli_rsan[k] for k in (
              "acquires", "locks_observed", "multi_thread_locks")},
          smi=smi)

    # specsan here: ok, no violation, the dense path's surfaces confirmed
    if not report["ok"] or report["violations"]:
        fail(f"specsan: ok {report['ok']}, violations "
             f"{report['violations'][:5]}, serve {report['serve']}")
    budgeted = {f"{p}::{f}" for p, f in FETCH_BUDGETS}
    if set(report["surfaces_confirmed"]) != budgeted - SHARDED_SURFACES:
        fail(f"specsan: confirmed {report['surfaces_confirmed']}, want "
             f"{sorted(budgeted - SHARDED_SURFACES)}")
    if any(plain["sessions"][n][key] != report["sessions"][n][key]
           for n in plain["sessions"]
           for key in ("rankings", "one_shot_top1", "batch_lanes")) or any(
            plain["serve"][k] != report["serve"][k]
            for k in ("ok", "parity_ok", "by_status")):
        fail("specsan: a captured leg differs from its uncaptured run")
    _lint_launches(report["launches"])
    for leg, surfaces in report["legs"].items():
        phase("lint", leg=f"specsan {leg}", surfaces={
            name: {"calls": row["calls"], "max_bytes": row["max_nbytes"],
                   "budget_bytes": row.get("budget_bytes"),
                   "bulk": FETCH_BUDGETS[tuple(name.split("::"))].bulk}
            for name, row in surfaces.items()},
            launches={k: v for k, v in report["launches"][leg].items()
                      if v})
    phase("lint", leg="specsan", ok=True, violations=0,
          fetches=report["fetches"],
          confirmed=len(report["surfaces_confirmed"]),
          unexercised=report["surfaces_unexercised"],
          seconds=specsan_s, serve=report["serve"],
          bitwise_uncaptured=True, smi=smi)
    seconds = time.perf_counter() - t_phase
    phase("lint", seconds=seconds, smi=smi)
    return {"files_scanned": lint["files_scanned"],
            "lint_wall_ms": lint["wall_ms"], "process_s": process_s,
            "rules": sorted(per_rule),
            "graftspec_ms": {r: per_rule[r] for r in GRAFTSPEC_RULES},
            "cli_rsan": {k: cli_rsan[k] for k in (
                "acquires", "locks_observed", "multi_thread_locks",
                "wall_ms")},
            "specsan_s": specsan_s, "fetches": report["fetches"],
            "legs": report["legs"], "launches": report["launches"],
            "unexercised": report["surfaces_unexercised"],
            "rsan": {"soak": rsan_soak, "pool": rsan_pool},
            "seconds": seconds}


def _no_sync(fn):
    """``fn()`` with any host sync on the card raising."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _tick_walls(session, rng):
    """Host walls of 20 serial ticks (8-row deltas) after 3 warm ones."""
    import numpy as np

    walls = []
    for _ in range(23):
        session.update_rows(rng.choice(session._n, 8, replace=False),
                            rng.uniform(0, 1, (8, C)).astype(np.float32))
        t0 = time.perf_counter()
        session.tick()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls[3:]


#: the peer rehearsal's bound of one barrier wait when rank 0 launches
#: alone: the launch must trap past it
PEER_TRAP_NS = 200_000_000


def _sync_all(devices) -> None:
    import torch

    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)


def _peer_plan(graph, devices):
    """The ``peer`` plan of ``graph``'s one ``dp`` row over ``devices``,
    whatever form the devices elect: one shard a card elects it; two
    ranks of one card (the rehearsal) take it here, the peer state
    digest-cached with the graph's layouts as the election caches it,
    each rank on a stream of its own."""
    from rca_tpu_torch.parallel.mesh import make_mesh
    from rca_tpu_torch.parallel.sharded import (
        _cache_entry,
        _peer_on,
        shard_plans,
    )

    (plan,) = shard_plans(make_mesh([("dp", 1), ("sp", len(devices))],
                                    devices), graph, "kernels")
    if plan.peer is not None:
        return plan
    peer = _peer_on(_cache_entry(graph), devices)
    _rehearsal_streams(peer.group)
    return plan._replace(grid=None, peer=peer)


def _rehearsal_streams(group) -> None:
    """Ranks that share a card (the rehearsal) each launch on a stream of
    their own: on the card's one peer stream the second rank's grid
    would queue behind the first's, which waits for it."""
    import torch

    if len(set(group.devices)) < len(group.devices) and \
            len({id(s) for s in group.streams}) < len(group.streams):
        group.streams = [torch.cuda.Stream(device=d) for d in group.devices]


def _peer_inputs(graph, devices, rng, lanes: int, poison: bool):
    """Each card's full ``h`` and ``a_ex`` (the same values on every card,
    as the gathers hand them; ``poison``: a NaN and an Inf in the last
    lane) and its ``inv_deg`` block, the graph's own degrees."""
    import numpy as np
    import torch

    n_pad, block = graph.n_pad, graph.block
    shape = (n_pad,) if lanes == 1 else (lanes, n_pad)
    h = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    a_ex = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    a_ex[..., rng.random(n_pad) < 0.6] = 0.0
    if poison and lanes > 1:
        h[-1, 11], a_ex[-1, 13], a_ex[-1, 17] = np.nan, np.nan, np.inf
    real = graph.mask > 0
    inv = (1.0 / np.maximum(np.bincount(graph.dst_global[real],
                                        minlength=n_pad), 1)).astype(
        np.float32)
    h, a_ex, inv = (torch.from_numpy(x) for x in (h, a_ex, inv))
    return ([h.to(d) for d in devices], [a_ex.to(d) for d in devices],
            [inv[k * block:(k + 1) * block].to(d)
             for k, d in enumerate(devices)])


def _check_peer_recursions(label, graph, devices, rng, decay: float,
                           lanes_list, steps_list, errs: dict) -> dict:
    """The two peer recursions over ``devices`` (one shard a rank) against
    the per-step composition they replace (the per-shard kernels between
    the collectives, on the same cards) bitwise, twice each, and through
    it the plain version on the finite lanes (``u`` bitwise, ``m`` at rtol
    1e-5 / atol 1e-6)."""
    import torch
    from rca_tpu_torch.engine.segscan import (
        down_seg_step_shard,
        down_seg_steps_peer,
        down_seg_steps_peer_plain,
        down_shard_recursion,
        up_seg_step_shard,
        up_seg_steps_peer,
        up_seg_steps_peer_plain,
        up_shard_recursion,
    )

    plan = _peer_plan(graph, devices)
    for lanes in lanes_list:
        h_full, a_full, inv_blk = _peer_inputs(graph, devices, rng, lanes,
                                               poison=True)
        for steps in steps_list:
            runs = {
                "seg_up_steps_peer": (
                    lambda: up_seg_steps_peer(h_full, decay, steps, plan),
                    lambda: up_shard_recursion(h_full, decay, steps,
                                               plan.up, up_seg_step_shard),
                    lambda: up_seg_steps_peer_plain(h_full, decay, steps,
                                                    plan)),
                "seg_down_steps_peer": (
                    lambda: down_seg_steps_peer(a_full, decay, steps, plan,
                                                inv_blk),
                    lambda: down_shard_recursion(a_full, decay, steps,
                                                 plan.dn, inv_blk,
                                                 down_seg_step_shard),
                    lambda: down_seg_steps_peer_plain(a_full, decay, steps,
                                                      plan, inv_blk)),
            }
            for name, (kernel, composed, plain) in runs.items():
                got = [kernel(), kernel(), composed(), plain()]
                _sync_all(devices)
                k1, k2, want, ref = (torch.cat([b.to(devices[0]) for b in x],
                                               dim=-1) for x in got)
                case_ = f"({label}, {lanes} lanes, {steps} steps)"
                if not torch.equal(_bits(k1), _bits(k2)):
                    fail(f"{name} not deterministic {case_}")
                if not torch.equal(_bits(k1), _bits(want)):
                    fail(f"{name} not bitwise the per-step composition "
                         f"{case_}")
                if lanes > 1:
                    k1, ref = k1[:-1], ref[:-1]
                if name == "seg_up_steps_peer" and not torch.equal(
                        _bits(k1), _bits(ref)):
                    fail(f"{name} not bitwise its plain version {case_}")
                if not torch.allclose(k1, ref, rtol=1e-5, atol=1e-6):
                    fail(f"{name} disagrees with its plain version {case_}")
                if ref.numel():
                    errs[name] = max(errs[name], float(
                        (k1 - ref).abs().max()))
    row = {"layout": label, "ranks": [str(d) for d in devices],
           "n_pad": graph.n_pad, "block": graph.block,
           "pairs": [seg.n_seg for seg in plan.peer.dn],
           "lanes": list(lanes_list), "steps": list(steps_list),
           "runs_each": 2, "max_abs_err": dict(errs)}
    phase("peer_recursions", **row)
    return row


def _peer_bound(graph, plan, link_rate) -> dict:
    """Each peer recursion's bound over ``plan``'s ranks at one lane and 8
    steps: the slowest card's (``cost.up_steps_peer`` /
    ``down_steps_peer``), its pushes over ``link_rate``; ranks that share
    a card (the rehearsal) add their bytes, the pushes landing in its own
    memory."""
    from rca_tpu_torch.kernels import cost

    sp = len(plan.devices)
    work = {"seg_up_steps_peer": [
        cost.up_steps_peer(graph.n_pad, sp, int(graph.mask[k].sum()))
        for k in range(sp)],
        "seg_down_steps_peer": [
        cost.down_steps_peer(graph.n_pad, sp, int(graph.mask[k].sum()),
                             plan.peer.dn[k].n_seg) for k in range(sp)]}
    if len(set(plan.devices)) == 1:
        return {name: (*cost.bound_ms(sum(w[0] + w[1] for w in rows),
                                      sum(w[2] for w in rows)),
                       sum(w[0] + w[1] for w in rows))
                for name, rows in work.items()}
    return {name: max((*cost.bound_peer_ms(*w, link_rate=link_rate), w[1])
                      for w in rows) for name, rows in work.items()}


def _time_peer_recursions(graph, devices, rng, decay: float, link_rate,
                          plain: bool = True) -> dict:
    """The two peer recursions over ``devices`` at one lane and 8 steps:
    card ms (:func:`cards_ms`: a sleep on every card, the slowest card's
    span, ``cuda:0``'s beside it) and call ms beside the per-step
    composition on the same cards, timed alike (in turns: composition,
    kernel, kernel, composition), the plain version (``plain``) and the
    bound (:func:`_peer_bound`)."""
    from rca_tpu_torch.engine.segscan import (
        down_seg_step_shard,
        down_seg_steps_peer,
        down_seg_steps_peer_plain,
        down_shard_recursion,
        up_seg_step_shard,
        up_seg_steps_peer,
        up_seg_steps_peer_plain,
        up_shard_recursion,
    )

    plan = _peer_plan(graph, devices)
    h_full, a_full, inv_blk = _peer_inputs(graph, devices, rng, 1,
                                           poison=False)
    bounds = _peer_bound(graph, plan, link_rate)
    runs = {
        "seg_up_steps_peer": (
            lambda: up_seg_steps_peer(h_full, decay, 8, plan),
            lambda: up_shard_recursion(h_full, decay, 8, plan.up,
                                       up_seg_step_shard),
            lambda: up_seg_steps_peer_plain(h_full, decay, 8, plan)),
        "seg_down_steps_peer": (
            lambda: down_seg_steps_peer(a_full, decay, 8, plan, inv_blk),
            lambda: down_shard_recursion(a_full, decay, 8, plan.dn, inv_blk,
                                         down_seg_step_shard),
            lambda: down_seg_steps_peer_plain(a_full, decay, 8, plan,
                                              inv_blk)),
    }
    out = {}
    for name, (kernel, composed, plain_fn) in runs.items():
        comp = [cards_ms(composed, devices, reps=10, inner=2)]
        ms = [cards_ms(kernel, devices), cards_ms(kernel, devices)]
        comp.append(cards_ms(composed, devices, reps=10, inner=2))
        out[name] = {"ranks": [str(d) for d in devices],
                     "edges": int(graph.mask.sum()),
                     "pairs": [seg.n_seg for seg in plan.peer.dn],
                     "ms": min(m[0] for m in ms),
                     "ms_cuda0": min(m[1] for m in ms),
                     "ms_runs": [m[0] for m in ms],
                     "call_ms": cuda_ms(kernel, queued=False),
                     "composition_ms": min(c[0] for c in comp),
                     "composition_cuda0_ms": min(c[1] for c in comp),
                     "composition_runs": [c[0] for c in comp],
                     "composition_call_ms": cuda_ms(composed, reps=10,
                                                    inner=2, queued=False),
                     "plain_ms": (cuda_ms(plain_fn, reps=3, inner=1)
                                  if plain else None),
                     "library_ms": None, "bound": bounds[name]}
    return out


def _check_peer_widths(graphs, devices, rng, decay: float) -> dict:
    """Peer launches of one kind back to back at different widths and over
    two graphs on the same cards, enqueued with no sync between them: up
    at 16 lanes then 1 on each graph, the same for down, then up / up /
    down / down alternating the graphs as two serve threads would
    interleave them; each result bitwise the per-step composition of its
    own inputs.  The exchange buffers' halves sit at the group's
    capacity, so a narrow launch's first push cannot land in what a
    slower card still reads of the wide one before it."""
    import torch
    from rca_tpu_torch.engine.segscan import (
        down_seg_step_shard,
        down_seg_steps_peer,
        down_shard_recursion,
        up_seg_step_shard,
        up_seg_steps_peer,
        up_shard_recursion,
    )

    plans = [_peer_plan(g, devices) for g in graphs]
    order = [("up", 0, 16), ("up", 0, 1), ("up", 1, 16), ("up", 1, 1),
             ("down", 0, 16), ("down", 0, 1), ("down", 1, 16),
             ("down", 1, 1),
             ("up", 0, 16), ("up", 1, 1), ("down", 0, 16), ("down", 1, 1)]
    inputs = [_peer_inputs(graphs[gi], devices, rng, lanes, poison=True)
              for _, gi, lanes in order]
    _sync_all(devices)
    got = []
    for (kind, gi, _), (h, a, inv) in zip(order, inputs):
        got.append(up_seg_steps_peer(h, decay, 8, plans[gi]) if kind == "up"
                   else down_seg_steps_peer(a, decay, 8, plans[gi], inv))
    _sync_all(devices)
    for (kind, gi, lanes), (h, a, inv), blocks in zip(order, inputs, got):
        want = (up_shard_recursion(h, decay, 8, plans[gi].up,
                                   up_seg_step_shard) if kind == "up"
                else down_shard_recursion(a, decay, 8, plans[gi].dn, inv,
                                          down_seg_step_shard))
        k1, w = (torch.cat([b.to(devices[0]) for b in x], dim=-1)
                 for x in (blocks, want))
        if not torch.equal(_bits(k1), _bits(w)):
            fail(f"seg_{kind}_steps_peer at {lanes} lanes on graph {gi} "
                 f"({graphs[gi].n_pad} nodes), launched back to back with "
                 f"other widths, is not bitwise the composition")
    row = {"ranks": [str(d) for d in devices],
           "n_pad": [g.n_pad for g in graphs],
           "order": [f"{k}:{gi}:{lanes}" for k, gi, lanes in order],
           "bitwise": True}
    phase("peer_widths", **row)
    return row


def _peer_trap(plan) -> dict:
    """Rank 0 of ``plan``'s up recursion launched alone (the wrapper's own
    arguments, :func:`up_peer_args`), its barrier numbered past every flag
    its peer can store, with the wait bounded at ``PEER_TRAP_NS``: the
    launch must fail, its stream's synchronize raise, within a few
    bounds.  The context is lost after it."""
    import torch
    from rca_tpu_torch.engine.segscan import (
        grid_items,
        peer_cap,
        steps_grid,
        up_peer_args,
    )
    from rca_tpu_torch.kernels.build import library

    peer, dev = plan.peer, plan.devices[0]
    seg, group = peer.up[0], peer.group
    h = torch.rand(plan.n_pad, device=dev)
    out = torch.empty(plan.block, device=dev)
    stream = group.streams[0]
    grid = steps_grid(max(1, grid_items(seg.n_seg, seg.n_long, seg.n_big)),
                      1, peer_cap(dev.index, False))
    group.ensure(plan.n_pad)
    args = up_peer_args(plan, [h] * len(plan.devices), 0.7, 2, 1,
                        wait_ns=PEER_TRAP_NS)(
        0, (group.epoch + (1 << 20)) & 0xFFFFFFFF, 0)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    err = library().rca_seg_up_steps_peer(*args, out.data_ptr(), *grid,
                                          stream.cuda_stream)
    raised = None
    try:
        stream.synchronize()
    except RuntimeError as exc:
        raised = str(exc).splitlines()[0]
    return {"launch_error": err, "raised": raised,
            "wall_s": time.perf_counter() - t0,
            "wait_bound_s": PEER_TRAP_NS / 1e9}


def peer_rehearsal(edges_path: str) -> dict:
    """Both peer recursions on one card: two ranks of ``cuda:0``, one
    launch a rank on a stream of its own, each grid capped at half the
    card's co-resident CTAs (``peer_cap`` halved in this process), the
    bounded wait armed; over the tiers' edges (``edges_path``, an
    ``.npz`` of ``src_<n>`` / ``dst_<n>``), checked bitwise the per-step
    composition and the plain version at 1 / 8 / 16 lanes (at 2047 also 0
    / 1 / 13 steps), twice each, and timed beside the composition; then
    launches of one kind at different widths over both graphs back to
    back (:func:`_check_peer_widths`); then rank 0 alone must trap
    (:func:`_peer_trap`).  Runs in a process of its own: the trap loses
    the context."""
    import numpy as np
    import torch
    from rca_tpu_torch.engine import GraphEngine, ShardedGraphEngine, segscan
    from rca_tpu_torch.kernels import LAUNCHES, build, cost, reset_launches
    from rca_tpu_torch.parallel.mesh import make_mesh

    build.library()
    dev = torch.device("cuda", 0)
    ranks = [dev, dev]
    decay = GraphEngine(device="cpu").params.decay
    edges = np.load(edges_path)
    rng = np.random.default_rng(313)
    errs = dict.fromkeys(PEER_KERNELS, 0.0)
    out = {"ranks": 2, "checks": [], "times": {}, "seconds": {}}
    full_cap = segscan.peer_cap
    with mock.patch.object(segscan, "peer_cap",
                           lambda index, down: full_cap(index, down) // 2):
        reset_launches()
        graphs = []
        for n, _, _ in TIERS:
            t0 = time.perf_counter()
            graph = ShardedGraphEngine(mesh=make_mesh(
                [("dp", 1), ("sp", 2)], ranks), resident=False)._shard(
                n, edges[f"src_{n}"], edges[f"dst_{n}"])
            graphs.append(graph)
            out["checks"].append(_check_peer_recursions(
                f"{n} services, 2 ranks of cuda:0", graph, ranks, rng, decay,
                SHARD_LANES, CHECK_STEPS if n == 2047 else (8,), errs))
            t1 = time.perf_counter()
            out["times"][str(n)] = _time_peer_recursions(
                graph, ranks, rng, decay, cost.NVLINK_BYTES_PER_S)
            out["seconds"][str(n)] = {"check": t1 - t0,
                                      "time": time.perf_counter() - t1}
        out["launches"] = {name: LAUNCHES[name] for name in PEER_KERNELS}
        t0 = time.perf_counter()
        out["widths"] = _check_peer_widths(graphs, ranks, rng, decay)
        out["seconds"]["widths"] = time.perf_counter() - t0
        out["errs"] = errs
        out["trap"] = _peer_trap(_peer_plan(graphs[-1], ranks))
    return out


def _peer_rehearsal_start(cases) -> dict:
    """Start :func:`peer_rehearsal` in a process of its own
    (``--peer-rehearsal``) over the tiers' edges; the full run starts it
    beside the capture phase, which leaves the card idle, and the sharded
    phase joins it."""
    import tempfile

    import numpy as np

    tmp = tempfile.mkdtemp(prefix="chip_smoke_peer_")
    path = os.path.join(tmp, "edges.npz")
    np.savez(path, **{f"{k}_{n}": getattr(cases[n], f"dep_{k}")
                      for n, _, _ in TIERS for k in ("src", "dst")})
    return _side_start("--peer-rehearsal", path, tmp=tmp)


def _peer_rehearsal_join(handle) -> dict:
    """The started rehearsal's record, read from its last line: it must
    pass, and rank 0 alone must have trapped within a few bounds."""
    out = _side_join(handle, "peer_rehearsal", timeout=600)
    trap = out["trap"]
    if trap["launch_error"] != 0 or trap["raised"] is None or \
            trap["wall_s"] > 20 * trap["wait_bound_s"]:
        fail(f"rank 0 alone did not trap within its bound: {trap}")
    out["parts_s"] = out.pop("seconds")
    out["seconds"] = handle["seconds"]
    phase("peer_rehearsal", **{k: out[k] for k in (
        "launches", "errs", "trap", "seconds", "parts_s")},
        times={n: {name: {key: t[key] for key in (
            "ms", "ms_cuda0", "composition_ms", "call_ms", "plain_ms")}
            for name, t in row.items()} for n, row in out["times"].items()})
    return out


def _nvlink_rate() -> tuple:
    """``cuda:0``'s NVLink rate in one direction as ``nvidia-smi nvlink
    -s`` reads it (the sum of its links' GB/s, in bytes/s; None where it
    lists none), and the lines it printed."""
    import re

    proc = subprocess.run(["nvidia-smi", "nvlink", "-s", "-i", "0"],
                          capture_output=True, text=True, timeout=60)
    lines = proc.stdout.strip().splitlines()
    rates = [float(m) for m in re.findall(r"Link \d+: ([\d.]+) GB/s",
                                          proc.stdout)]
    return (sum(rates) * 1e9 if rates else None), lines


def _peer_batch(case, lanes: int, rng):
    """``lanes`` lanes of the case's features, every lane but the first
    with 6 rows redrawn."""
    import numpy as np

    batch = np.repeat(case.features[None], lanes, axis=0)
    for b in range(1, lanes):
        batch[b, rng.integers(0, case.n, 6)] = rng.uniform(0, 1, (6, C))
    return batch


def multi_card_phase(cases, big, dense=None) -> dict:
    """The sharded engine over distinct cards (two or more), where the
    plan takes the ``peer`` form (each recursion one cooperative launch a
    card exchanging blocks through peer memory, ``csrc/segpeer.cu``):
    the forms (two logical shards ``shard_grid``, two cards ``peer``, the
    same cards under :func:`_step_form` ``step``); both peer recursions
    bitwise the per-step composition on the same cards and the plain
    version at 2047 and 49,999 services, at sp 2 and over every card, at
    1 / 8 / 16 lanes (at 2047 also 0 / 1 / 13 steps), twice each, and on
    the star and the hub over every card; the engine's full diagnostics
    at the same sizes and lanes bitwise the logical shards' ``shard_grid``
    run and the ``step`` form over the same cards, twice, each analysis's
    launches (sp / sp peer launches, no per-shard step) and collectives,
    and the ``step`` run's own (8 sp / 8 sp per-shard steps, 19 gathers
    and 9 reduce-scatters); launches of one kind back to back at
    different widths over both tiers' graphs (:func:`_check_peer_widths`);
    three sync-free streaming dispatches over two cards; the recursions'
    card, call and plain times beside the composition, and the NVLink
    rate ``nvidia-smi`` reads; then what a multi-card host runs,
    ``make_engine()`` with ``RCA_SHARD`` unset (one shard on every card):
    its ``analyze_arrays`` wall (restaged, median of 20) at each tier and
    its tick wall at 10,000 services (8-row deltas, median of 20), beside
    the same mesh in the ``step`` form, the same shards as logical shards
    of ``cuda:0`` and the dense engine on ``cuda:0``, and a profile of one
    analysis over the cards and on ``cuda:0`` at each tier."""
    import numpy as np
    import torch
    from rca_tpu_torch.engine import GraphEngine, ShardedGraphEngine, make_engine
    from rca_tpu_torch.engine.streaming import StreamingSession
    from rca_tpu_torch.kernels import LAUNCHES, cost, reset_launches
    from rca_tpu_torch.parallel import collectives
    from rca_tpu_torch.parallel.mesh import make_mesh
    from rca_tpu_torch.parallel.sharded import shard_plans
    from rca_tpu_torch.parallel.streaming import ShardedStreamingSession

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        fail(f"the multi-card phase needs two cards or more, found {n_cards}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(909)
    dense = dense or GraphEngine(resident=False)
    decay = dense.params.decay

    def mesh(sp, devices=None):
        return make_mesh([("dp", 1), ("sp", sp)], devices or [dev] * sp)

    cards = [torch.device("cuda", i) for i in range(n_cards)]
    sps = sorted({2, n_cards})
    rate, smi_lines = _nvlink_rate()
    out = {"cards": n_cards, "sps": sps,
           "nvlink": {"bytes_per_s": rate,
                      "model_bytes_per_s": cost.NVLINK_BYTES_PER_S,
                      "nvidia_smi": smi_lines}}
    phase("sharded_multi_card", leg="nvlink", **out["nvlink"])
    link = rate or cost.NVLINK_BYTES_PER_S

    # -- the forms ------------------------------------------------------------
    case = cases[TIERS[-1][0]]
    graph = ShardedGraphEngine(mesh=mesh(2, cards[:2]), resident=False)._shard(
        case.n, case.dep_src, case.dep_dst)
    forms = {label: shard_plans(m, graph, "kernels")[0].steps_form
             for label, m in (("logical", mesh(2)),
                              ("cards", mesh(2, cards[:2])))}
    with _step_form():
        forms["cards_step"] = shard_plans(mesh(2, cards[:2]), graph,
                                          "kernels")[0].steps_form
    if forms != {"logical": "shard_grid", "cards": "peer",
                 "cards_step": "step"}:
        fail(f"the sharded plans' forms: {forms}")
    out["forms"] = forms

    # -- the two kernels against the composition and the plain version --------
    errs = dict.fromkeys(PEER_KERNELS, 0.0)
    out["checks"] = []
    for n in cases:
        for sp in sps:
            g = ShardedGraphEngine(mesh=mesh(sp, cards[:sp]),
                                   resident=False)._shard(
                n, cases[n].dep_src, cases[n].dep_dst)
            out["checks"].append(_check_peer_recursions(
                f"{n} services, {sp} cards", g, cards[:sp], rng, decay,
                SHARD_LANES, CHECK_STEPS if n == 2047 else (8,), errs))
    over_all = ShardedGraphEngine(mesh=mesh(n_cards, cards), resident=False)
    block = over_all._shard(2047, np.zeros(0, np.int32),
                            np.zeros(0, np.int32)).block
    for label, edges in (("star", _star_case(2047, 3)),
                         ("hub", _hub_case(2047, block, 4))):
        out["checks"].append(_check_peer_recursions(
            f"{label}, {n_cards} cards", over_all._shard(2047, *edges),
            cards, rng, decay, (1, 16), (1, 8), errs))
    out["errs"] = errs
    out["widths"] = _check_peer_widths(
        [over_all._shard(n, c.dep_src, c.dep_dst) for n, c in cases.items()],
        cards, rng, decay)

    # -- the engine: bitwise the logical shards and the step form --------------
    out["engine"] = []
    for n, c in cases.items():
        for sp in sps:
            over = ShardedGraphEngine(mesh=mesh(sp, cards[:sp]),
                                      resident=False)
            logical = ShardedGraphEngine(mesh=mesh(sp), resident=False)
            g = over._shard(n, c.dep_src, c.dep_dst)
            for lanes in SHARD_LANES:
                if lanes == 1:
                    def run(e, c=c):
                        return [e.analyze_arrays(c.features, c.dep_src,
                                                 c.dep_dst, c.names)]
                else:
                    batch = _peer_batch(c, lanes, rng)

                    def run(e, c=c, batch=batch):
                        return e.analyze_batch(batch, c.dep_src, c.dep_dst,
                                               c.names)

                run(over)
                _sync_all(cards)
                reset_launches()
                collectives.reset_collectives()
                got = run(over)
                launches = dict(LAUNCHES)
                calls = dict(collectives.COLLECTIVE_CALLS)
                moved = dict(collectives.COLLECTIVE_BYTES)
                if launches != _shard_launches(sp, "peer"):
                    fail(f"peer launches at {n}, sp {sp}, {lanes} lanes: "
                         f"{launches}")
                # 3 gathers (e, h, a) and the degree's reduce-scatter from
                # the host; the recursions' pushes: w 7 blocks a
                # recursion, the contributions 8
                per_call = (sp - 1) * g.block * 4 * lanes
                budget = {"all_gather": (3 + 14) * sp * per_call,
                          "reduce_scatter": sp * (sp - 1) * g.block * 4
                          + 8 * sp * per_call}
                if (calls["all_gather"], calls["reduce_scatter"]) != (3, 1) \
                        or any(moved[k] != budget[k] for k in budget):
                    fail(f"peer collectives at {n}, sp {sp}, {lanes} lanes: "
                         f"{calls} {moved}, budget {budget}")
                again = run(over)
                want = run(logical)
                # the step form over the same cards, its own launches and
                # host collectives counted, so that the twin below is the
                # composition and not the peer kernels again
                reset_launches()
                collectives.reset_collectives()
                with _step_form():
                    stepped = run(over)
                step_launches = dict(LAUNCHES)
                step_calls = dict(collectives.COLLECTIVE_CALLS)
                if step_launches != _shard_launches(sp, "step") or (
                        step_calls["all_gather"],
                        step_calls["reduce_scatter"]) != (19, 9):
                    fail(f"step form over the cards at {n}, sp {sp}, "
                         f"{lanes} lanes: {step_launches} {step_calls}")
                for label, other in (("again", again), ("logical", want),
                                     ("step", stepped)):
                    if not all(np.array_equal(
                            _f32bits(a.full_diagnostics()),
                            _f32bits(b.full_diagnostics()))
                            for a, b in zip(got, other)):
                        fail(f"peer diagnostics at {n}, sp {sp}, {lanes} "
                             f"lanes differ from {label}")
                    if [r.top_components() for r in got] != \
                            [r.top_components() for r in other]:
                        fail(f"peer top-k at {n}, sp {sp}, {lanes} lanes "
                             f"differs from {label}")
                if not all(np.isfinite(r.full_diagnostics()).all()
                           for r in got):
                    fail(f"non-finite peer diagnostics at {n}, sp {sp}")
                row = {"services": n, "sp": sp, "lanes": lanes,
                       "launches": {k: launches[k] for k in (
                           *PEER_KERNELS, *STEP_KERNELS, "evidence_front",
                           "seg_contrast_step")},
                       "collective_calls": calls, "collective_bytes": moved,
                       "step_launches": {k: step_launches[k] for k in (
                           *PEER_KERNELS, *STEP_KERNELS)},
                       "step_collective_calls": step_calls,
                       "bitwise": ["again", "logical", "step"],
                       "top": got[0].top_components()[:3]}
                out["engine"].append(row)
                phase("sharded_multi_card", leg="engine", **row)

    # -- streaming over two cards: sync-free dispatches ------------------------
    n = big.features.shape[0]
    names = [f"svc-{i}" for i in range(n)]

    def session(engine):
        s_ = (StreamingSession if isinstance(engine, GraphEngine)
              else ShardedStreamingSession)(names, big.dep_src, big.dep_dst,
                                            C, engine=engine, k=5)
        s_.set_all(big.features)
        return s_

    ss = session(ShardedGraphEngine(mesh=mesh(2, cards[:2])))
    if ss._plan.steps_form != "peer":
        fail(f"the streaming session over two cards: {ss._plan.steps_form}")
    for _ in range(3):
        ss.update_rows(rng.choice(n, 8, replace=False),
                       rng.uniform(0, 1, (8, C)).astype(np.float32))
        ss.fetch(_no_sync(ss.dispatch))
    out["sync_free_dispatches"] = 3

    # -- the recursions' times over every card, beside the composition ---------
    out["times"] = {}
    for n_, c in cases.items():
        g = over_all._shard(n_, c.dep_src, c.dep_dst)
        out["times"][str(n_)] = _time_peer_recursions(
            g, cards, rng, decay, link, plain=n_ == 2047)
        phase("sharded_multi_card", leg="times", services=n_,
              **out["times"][str(n_)])

    # -- what a multi-card host runs --------------------------------------------
    auto = make_engine()
    over_cards = ShardedGraphEngine(mesh=auto.mesh, resident=False)
    sp = auto.mesh.shape["sp"]
    logical = ShardedGraphEngine(mesh=mesh(sp), resident=False)
    walls = {}
    for n_, c in cases.items():
        def call(e, c=c):
            return e.analyze_arrays(c.features, c.dep_src, c.dep_dst,
                                    c.names)

        walls[str(n_)] = {}
        for label, e in (("cards", over_cards), ("cards_step", over_cards),
                         ("logical", logical), ("dense", dense)):
            ctx = (_step_form() if label == "cards_step"
                   else contextlib.nullcontext())
            with ctx:
                walls[str(n_)][label] = host_ms(lambda e=e: call(e))
    walls["tick_10000"] = {}
    for label, make in (
            ("cards", lambda: ShardedGraphEngine(mesh=auto.mesh)),
            ("cards_step", lambda: ShardedGraphEngine(mesh=auto.mesh)),
            ("logical", lambda: ShardedGraphEngine(mesh=mesh(sp))),
            ("dense", GraphEngine)):
        ctx = (_step_form() if label == "cards_step"
               else contextlib.nullcontext())
        with ctx:
            walls["tick_10000"][label] = float(np.median(_tick_walls(
                session(make()), rng)))
    # where an analysis's wall goes over the cards and on one card
    profiles = {}
    for n_, c in cases.items():
        for label, e in (("cards", over_cards), ("logical", logical)):
            profiles[f"{label}_{n_}"] = device_profile(
                lambda e=e, c=c: e.analyze_arrays(
                    c.features, c.dep_src, c.dep_dst, c.names),
                walls[str(n_)][label], None, f"multi_{label}_{n_}", calls=3,
                warm=2)
    out.update(make_engine=auto.engine_tag,
               mesh=[str(d) for d in auto.mesh.flat], walls_ms=walls,
               profiles=profiles, seconds=time.perf_counter() - t_phase)
    phase("sharded_multi_card", leg="walls", make_engine=auto.engine_tag,
          walls_ms=walls, seconds=out["seconds"])
    return out


def _f32bits(a):
    """A float32 array's bit pattern (NaN-safe bitwise comparisons)."""
    import numpy as np

    return np.ascontiguousarray(a, np.float32).view(np.int32)


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


def device_profile(fn, host_ms_per_call: float, out_dir, name: str,
                   calls: int = 3, warm: int = 1) -> dict:
    """Device time, kernel launches, device kernels and the busy share of
    one ``fn`` call (``torch.profiler`` over ``calls`` calls after ``warm``
    unprofiled ones), the five device ops that take the most time and the
    eight host ops with the most self time (calls and µs a call); the
    table goes to ``out_dir/profile_<name>.txt`` when ``out_dir`` is given.
    The busy share divides the device time of one call by its unprofiled
    host wall time (the profiler's own start-up would swamp a profiled wall
    clock)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device-side events: kernels, copies and memsets; the profiler's own
    # buffer request and the host scopes named by device_annotation
    # (their ranges show on the device timeline too) are left out
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and e.key != "Activity Buffer Request"
                 and not getattr(e, "is_user_annotation", False)
                 and not e.key.startswith("tick.")]

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    device_us = sum(dev_us(e) for e in on_device) / calls
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchCooperativeKernel")) / calls
    kernels = sum(e.count for e in on_device
                  if not e.key.startswith(("Memcpy", "Memset"))) / calls
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
            f.write(events.table(sort_by="self_cuda_time_total",
                                 row_limit=40))
    top = sorted(on_device, key=dev_us, reverse=True)[:5]
    on_host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                     key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    return {"device_us_per_call": device_us,
            "launches_per_call": launches,
            "device_kernels_per_call": kernels,
            "host_ms_per_call": host_ms_per_call,
            "device_busy_share": device_us / 1e3 / host_ms_per_call,
            "top_device_ops": [[e.key[:60], dev_us(e) / calls] for e in top],
            "top_host_ops": [[e.key[:60], e.count / calls,
                              e.self_cpu_time_total / calls]
                             for e in on_host]}


def profile(engine, case, host_ms_per_analysis: float, out=None,
            per_step_host_ms=None) -> dict:
    """Device time by kernel over 5 analyses after 3 warm ones; with
    ``per_step_host_ms`` also the same analysis with its recursions run
    per step, beside it."""
    runs = {"plan": (host_ms_per_analysis, False)}
    if per_step_host_ms is not None:
        runs["per_step"] = (per_step_host_ms, True)
    got = {}
    for label, (host, per_step) in runs.items():
        name = str(case.n) + ("_per_step" if per_step else "")
        with per_step_plans() if per_step else contextlib.nullcontext():
            p = device_profile(lambda: engine.analyze_case(case), host, out,
                               name, calls=5, warm=3)
        got[label] = {"device_us_per_analysis": p["device_us_per_call"],
                      "launches_per_analysis": p["launches_per_call"],
                      "device_kernels_per_analysis":
                          p["device_kernels_per_call"],
                      "host_ms_per_analysis": host,
                      "device_busy_share": p["device_busy_share"]}
        phase("profile", services=case.n, run=label, **got[label])
    return got


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
