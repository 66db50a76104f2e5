"""UI surface: the Streamlit app (thin, ``app.py``; it imports without
streamlit) + pure render helpers."""

from rca_tpu_torch.ui.render import (
    finding_markdown,
    initial_suggestions,
    report_markdown,
    response_markdown,
    root_causes_markdown,
    topology_plot_data,
)

__all__ = [
    "finding_markdown",
    "initial_suggestions",
    "report_markdown",
    "response_markdown",
    "root_causes_markdown",
    "topology_plot_data",
]
