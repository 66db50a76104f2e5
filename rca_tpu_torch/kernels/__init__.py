"""The port's hand-written CUDA kernels: build/load (:mod:`.build`) and the
launch counters.

Each kernel wrapper adds one to its entry of :data:`LAUNCHES`
(:func:`count_launch`) where it launches its kernel on the card, and
nowhere else, so a run can show that the main path went through the
kernels (the plain versions used on CPU tensors do not count).  The counts
are taken under a lock: serve threads launch concurrently, and a lost
update would misreport a run.  :data:`PERSIST_LAUNCHES` counts, apart, the
``evidence_front`` and ``evidence_front_fused`` launches that persist the
sanitize into their input,
and :data:`SHARD_LAUNCHES` the launches of the node-sharded engine's
kernels (the seg steps' per-shard entries, and the front and the
recursions over every shard of one card), which count in
:data:`LAUNCHES` too.
"""

from rca_tpu_torch.util.threads import make_lock

LAUNCHES = {"noisy_or_pair": 0, "segscan_sum": 0, "segscan_max": 0,
            "seg_up_step": 0, "seg_down_step": 0, "evidence_front": 0,
            "seg_contrast_step": 0, "seg_up_steps": 0, "seg_down_steps": 0,
            "evidence_front_fused": 0, "seg_up_steps_grid": 0,
            "seg_down_steps_grid": 0, "seg_up_steps_shard": 0,
            "seg_down_steps_shard": 0, "evidence_front_shard": 0,
            "seg_up_steps_peer": 0, "seg_down_steps_peer": 0}
PERSIST_LAUNCHES = {"evidence_front": 0, "evidence_front_fused": 0}
SHARD_LAUNCHES = {"seg_up_step": 0, "seg_down_step": 0,
                  "seg_contrast_step": 0, "seg_up_steps_shard": 0,
                  "seg_down_steps_shard": 0, "evidence_front_shard": 0,
                  "seg_up_steps_peer": 0, "seg_down_steps_peer": 0}


_LOCK = make_lock("kernels._LOCK")


def count_launch(name: str, persist: bool = False,
                 shard: bool = False) -> None:
    """One launch of kernel ``name`` (a persisting front launch or a
    per-shard entry counted apart too)."""
    with _LOCK:
        LAUNCHES[name] += 1
        if persist:
            PERSIST_LAUNCHES[name] += 1
        if shard:
            SHARD_LAUNCHES[name] += 1


def reset_launches() -> None:
    with _LOCK:
        for counts in (LAUNCHES, PERSIST_LAUNCHES, SHARD_LAUNCHES):
            for name in counts:
                counts[name] = 0
