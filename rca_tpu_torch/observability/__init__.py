"""The port's observability: causelens provenance, spans and the tracer
seam, and kernelscope's watchdogs of the live health record."""
