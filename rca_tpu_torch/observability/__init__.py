"""The port's observability: spans and the tracer seam (:mod:`.spans`),
their Chrome trace and NDJSON exports (:mod:`.export`), causelens
provenance (:mod:`.causelens`), kernelscope's watchdogs of the live
health record (:mod:`.kernelscope`) and the ``profile`` capture around a
live session (:mod:`.profile`)."""

from rca_tpu_torch.observability.spans import (  # noqa: F401
    NULL_TRACER,
    Span,
    SpanContext,
    Tracer,
    default_tracer,
    device_annotation,
    set_default_tracer,
)
from rca_tpu_torch.observability.export import (  # noqa: F401
    DURATION_BUCKETS_S,
    LatencyHistogram,
    chrome_trace,
    ndjson_spans,
    recording_trace,
)
from rca_tpu_torch.observability.causelens import (  # noqa: F401
    PROVENANCE_SCHEMA,
    attribution_digest,
    provenance_block,
    render_blame_tree,
)

__all__ = [
    "PROVENANCE_SCHEMA",
    "attribution_digest",
    "provenance_block",
    "render_blame_tree",
    "NULL_TRACER",
    "Span",
    "SpanContext",
    "Tracer",
    "default_tracer",
    "set_default_tracer",
    "device_annotation",
    "DURATION_BUCKETS_S",
    "LatencyHistogram",
    "chrome_trace",
    "ndjson_spans",
    "recording_trace",
]
