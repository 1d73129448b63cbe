"""Membership backends (counterpart of
``tfservingcache_tpu/cluster/discovery/__init__.py``)."""

from tfservingcache_tpu_torch.cluster.discovery.base import DiscoveryService

__all__ = ["DiscoveryService", "create_discovery"]


def create_discovery(cfg) -> DiscoveryService:
    """The backend ``cfg.type`` names (a ``DiscoveryConfig``)."""
    from tfservingcache_tpu_torch.config import DiscoveryConfig

    assert isinstance(cfg, DiscoveryConfig)
    t = cfg.type.lower()
    if t == "static":
        from tfservingcache_tpu_torch.cluster.discovery.static import StaticDiscoveryService

        return StaticDiscoveryService(cfg.nodes)
    if t == "file":
        from tfservingcache_tpu_torch.cluster.discovery.filewatch import FileDiscoveryService

        return FileDiscoveryService(cfg.path, poll_interval_s=cfg.poll_interval_s)
    if t in ("kubernetes", "k8s"):
        from tfservingcache_tpu_torch.cluster.discovery.kubernetes import K8sDiscoveryService

        return K8sDiscoveryService(
            service_name=cfg.service_name,
            namespace=cfg.namespace,
            field_selector=cfg.field_selector,
            poll_interval_s=cfg.poll_interval_s,
            api_url=cfg.address,  # "" = the in-cluster environment
        )
    if t == "consul":
        from tfservingcache_tpu_torch.cluster.discovery.consul import ConsulDiscoveryService

        return ConsulDiscoveryService(
            address=cfg.address,
            service_name=cfg.service_name,
            ttl_s=cfg.heartbeat_ttl_s,
            poll_interval_s=cfg.poll_interval_s,
        )
    if t == "etcd":
        from tfservingcache_tpu_torch.cluster.discovery.etcd import EtcdDiscoveryService

        return EtcdDiscoveryService(
            address=cfg.address,
            service_name=cfg.service_name,
            ttl_s=cfg.heartbeat_ttl_s,
        )
    raise ValueError(f"unknown discovery type {cfg.type!r}")
