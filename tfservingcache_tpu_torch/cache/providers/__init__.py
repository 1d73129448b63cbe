from tfservingcache_tpu_torch.cache.providers.base import (
    ModelNotFoundError,
    ModelProvider,
    ProviderError,
)


def create_provider(cfg) -> ModelProvider:
    """Provider factory by ``model_provider.type``; the port has ``disk``
    (object-store providers are a later slice)."""
    t = cfg.type.lower()
    if t in ("disk", "diskprovider"):
        from tfservingcache_tpu_torch.cache.providers.disk import DiskModelProvider

        return DiskModelProvider(cfg.base_dir)
    raise ValueError(f"unknown or unported model provider type: {cfg.type!r}")


__all__ = ["ModelNotFoundError", "ModelProvider", "ProviderError", "create_provider"]
