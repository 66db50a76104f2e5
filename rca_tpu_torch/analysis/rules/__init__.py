"""Bundled graftlint rules of the port: importing this package registers
them all.

One module per rule.  Seven keep the JAX package's meaning with the
port's paths (``env``, ``faults``, ``threads``, ``locks``, ``spans``,
``nondet``, ``dictscan``), and so do gravelock's two (``race-guard`` and
``lock-order``, over the port's own concurrency model); six are
redesigned for torch (``ticksync``, ``residentfetch``,
``kerneldispatch``, ``rng``, and graftspec's static half,
``dtypediscipline`` and ``shapecontract``, over the port's abstract
interpreter of torch ops).  A new invariant is a new module here with a
``@register`` class.
"""

from rca_tpu_torch.analysis.rules import dictscan       # noqa: F401
from rca_tpu_torch.analysis.rules import dtypediscipline  # noqa: F401
from rca_tpu_torch.analysis.rules import env            # noqa: F401
from rca_tpu_torch.analysis.rules import faults         # noqa: F401
from rca_tpu_torch.analysis.rules import gravelock      # noqa: F401
from rca_tpu_torch.analysis.rules import kerneldispatch  # noqa: F401
from rca_tpu_torch.analysis.rules import locks          # noqa: F401
from rca_tpu_torch.analysis.rules import nondet         # noqa: F401
from rca_tpu_torch.analysis.rules import residentfetch  # noqa: F401
from rca_tpu_torch.analysis.rules import rng            # noqa: F401
from rca_tpu_torch.analysis.rules import shapecontract  # noqa: F401
from rca_tpu_torch.analysis.rules import spans          # noqa: F401
from rca_tpu_torch.analysis.rules import threads        # noqa: F401
from rca_tpu_torch.analysis.rules import ticksync       # noqa: F401
