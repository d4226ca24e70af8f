from audio_rag_tpu_torch.resources.manager import (
    ModelInfo,
    ResourceManager,
    get_resource_manager,
    set_resource_manager,
)

__all__ = ["ModelInfo", "ResourceManager", "get_resource_manager",
           "set_resource_manager"]
