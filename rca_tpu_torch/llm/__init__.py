"""LLM backend: providers, real tool loop, per-signal tool registries."""

from rca_tpu_torch.llm.client import LLMClient, parse_json_response
from rca_tpu_torch.llm.providers import (
    AnthropicProvider,
    LLMQuotaExceeded,
    LLMUnavailable,
    OfflineProvider,
    OpenAIProvider,
    Provider,
    ProviderReply,
    ToolCall,
    make_provider,
)
from rca_tpu_torch.llm.tools import ToolSpec, cluster_toolsets

__all__ = [
    "AnthropicProvider",
    "LLMClient",
    "LLMQuotaExceeded",
    "LLMUnavailable",
    "OfflineProvider",
    "OpenAIProvider",
    "Provider",
    "ProviderReply",
    "ToolCall",
    "ToolSpec",
    "cluster_toolsets",
    "make_provider",
    "parse_json_response",
]
