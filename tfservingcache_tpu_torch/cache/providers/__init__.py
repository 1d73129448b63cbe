from tfservingcache_tpu_torch.cache.providers.base import (
    ModelNotFoundError,
    ModelProvider,
    ProviderError,
)


def create_provider(cfg) -> ModelProvider:
    """Provider factory by ``model_provider.type`` (reference
    providers/__init__.py): ``disk``, ``s3``, ``gcs`` or ``azblob``. The
    object-store providers speak their stores' HTTP APIs with the standard
    library only."""
    t = cfg.type.lower()
    if t in ("disk", "diskprovider"):
        from tfservingcache_tpu_torch.cache.providers.disk import DiskModelProvider

        return DiskModelProvider(cfg.base_dir)
    if t in ("s3", "s3provider"):
        from tfservingcache_tpu_torch.cache.providers.s3 import S3ModelProvider

        return S3ModelProvider(bucket=cfg.bucket, base_path=cfg.base_path,
                               region=cfg.region, endpoint=cfg.endpoint)
    if t in ("gcs", "gcsprovider"):
        from tfservingcache_tpu_torch.cache.providers.gcs import GCSModelProvider

        return GCSModelProvider(bucket=cfg.bucket, base_path=cfg.base_path,
                                endpoint=cfg.endpoint)
    if t in ("azblob", "azblobprovider"):
        from tfservingcache_tpu_torch.cache.providers.azblob import AZBlobModelProvider

        return AZBlobModelProvider(account_name=cfg.account_name, account_key=cfg.account_key,
                                   container=cfg.container, base_path=cfg.base_path,
                                   endpoint=cfg.endpoint)
    raise ValueError(f"unknown model provider type: {cfg.type!r}")


__all__ = ["ModelNotFoundError", "ModelProvider", "ProviderError", "create_provider"]
