"""The port's configuration: the dataclass tree (:mod:`.schema`) and the
layered loader (:mod:`.loader`)."""

from audio_rag_tpu_torch.config.loader import (
    apply_env_overrides,
    deep_merge,
    load_config,
    normalize_reference_config,
)
from audio_rag_tpu_torch.config.schema import *  # noqa: F401,F403
from audio_rag_tpu_torch.config.schema import __all__ as _schema_all

__all__ = [*_schema_all, "load_config", "deep_merge", "apply_env_overrides",
           "normalize_reference_config"]
