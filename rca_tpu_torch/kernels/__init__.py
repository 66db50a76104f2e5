"""The port's hand-written CUDA kernels: build/load (:mod:`.build`) and the
launch counters.

Each kernel wrapper adds one to its entry of :data:`LAUNCHES` where it
launches its kernel on the card, and nowhere else, so a run can show that
the main path went through the kernels (the plain versions used on CPU
tensors do not count).
"""

LAUNCHES = {"noisy_or_pair": 0, "segscan_sum": 0, "segscan_max": 0,
            "seg_up_step": 0, "seg_down_step": 0, "evidence_front": 0,
            "seg_contrast_step": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
