"""Config for the port's serving path (a subset of
``tfservingcache_tpu/config.py``, same section and field names).

Loaded from a JSON file or a dict; a ``.yaml``/``.yml`` path imports
``yaml`` lazily, so the package needs no YAML library otherwise. Unknown
keys are logged and ignored, as in the reference.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Mapping

log = logging.getLogger("tpusc_torch.config")


@dataclass
class ServingConfig:
    """The in-process PyTorch runtime."""

    max_concurrent_models: int = 16        # models resident on the GPU at once
    # byte budget for resident params (an H100 holds 80 GB; the rest is
    # left for activations and the allocator's cache)
    hbm_capacity_bytes: int = 64 << 30
    # cold-load (fetch + load) deadline; 0 disables
    load_timeout_s: float = 30.0
    # "cuda" (the default) or "cpu"; a missing card with "cuda" raises
    device: str = "cuda"
    # :generate engine: "continuous" runs unseeded requests on the slotted
    # continuous engine (runtime/batcher.py); "coalesce" (the reference's
    # default name) runs every request on the solo path, since the port has
    # no coalescer yet
    generate_engine: str = "coalesce"
    generate_slots: int = 8                # continuous-engine lanes per model
    generate_chunk_tokens: int = 8         # decode steps per scheduler boundary
    # paged KV arena for the continuous engine: 0 = dense per-lane rows;
    # > 0 = pages of this many tokens shared through per-lane block tables
    kv_page_tokens: int = 0
    # usable arena pages; 0 auto-sizes to slots x ceil(max_seq / page_tokens)
    # (int8 arenas grow to the same byte budget)
    kv_arena_pages: int = 0
    # Cross-request shared-prefix KV over the paged arena
    # (runtime/prefix_cache.py PagePrefixIndex): byte budget of arena pages
    # the radix prefix index may hold for reuse. 0 = off (default). > 0 (with
    # kv_page_tokens > 0) makes admission map the longest page-aligned
    # indexed prompt prefix read-only into a new row's block table (no
    # prefill over it, no page copy) and reserve only the private suffix +
    # max_new pages; an exact repeat of an indexed prompt skips the prefill.
    # A page a lane would write into is copied first; index-held pages are
    # reclaimed under admission pressure before a request blocks.
    kv_share_prefix_bytes: int = 0
    # Chunked prefill for generate_engine=continuous over a paged arena:
    # 0 (default) prefills each admitted prompt in one dispatch. > 0 splits
    # a cold prompt longer than this into chunks of this many tokens
    # (clamped up to a power of two), written straight into the lane's pages
    # one chunk per scheduler boundary while the other lanes keep decoding.
    # Shared-prefix hits and engines with a draft attached keep the
    # one-dispatch prefill.
    prefill_chunk_tokens: int = 0
    # Prefix KV cache for the solo :generate path (B = 1 requests):
    # byte budget of device memory for reusable prompt-prefix K/V
    # (runtime/prefix_cache.py PrefixCache). 0 = off (default). A hit
    # prefills only the suffix; each request stores its prompt + completion
    # rows for the next turn. The continuous engine's admission prefill
    # reuses entries too (it never inserts).
    prefix_cache_bytes: int = 0
    # paged decode attention through the CUDA kernel (False = the plain path)
    kv_paged_kernel: bool = True
    # "" = the model dtype; "int8" = quantized pages with per-row f32 scales
    kv_arena_dtype: str = ""
    # In-engine speculative decoding for generate_engine=continuous
    # (runtime/batcher.py): name of the DRAFT model — "name" (highest
    # resident version) or "name@version". "" = off (default). When set,
    # each continuous scheduler attaches the draft to its paged slot state
    # (runtime.slot_attach_draft) and replaces plain decode chunks with
    # draft/verify rounds: the draft proposes spec_tokens greedy tokens per
    # lane, ONE multi-position verify pass scores them, and each lane
    # accepts a variable-length prefix — greedy streams stay identical to
    # spec-off. Admission reserves spec_tokens of extra page headroom per
    # row in BOTH arenas, so requests sized to the exact arena edge may
    # need one more page than without spec. Dense (non-paged) states ignore
    # the knob; lanes with temperature > 0 fall back to single-token
    # emission inside the round.
    spec_draft_model: str = ""
    # Draft tokens proposed per verify round when spec_draft_model is set
    # (clamped to {1, 2, 4, 8} at attach). Also the per-row page headroom
    # reserved at admission. Higher values win only when acceptance is
    # high; the runtime's acceptance health gate (_spec_admit) disables a
    # pair that sustains low acceptance and re-auditions it periodically.
    spec_tokens: int = 4
    # Crash recovery for generate_engine=continuous (runtime/batcher.py): when
    # a scheduler step raises (a device failure, an eviction mid-decode, an
    # injected kill), its in-flight and queued rows move to a fresh
    # scheduler thread instead of failing; admission re-prefills each
    # interrupted row's prompt + the tokens it already emitted, so greedy
    # streams continue token for token. false fails every row, as before.
    generate_recovery: bool = True
    # Crashes a row may survive; it fails on the next one (a prompt that
    # crashes the engine every time must not respawn schedulers forever).
    generate_max_recoveries: int = 2
    # Conversation KV tier for generate_engine=continuous over a paged arena
    # (cache/conversation_kv.py): host-memory byte budget for PARKED decode
    # state. A :generate request carrying a conversation_id copies its lane's
    # live pages (raw arena dtype, int8 with its scales) to host at
    # retirement; the conversation's next turn writes them back into fresh
    # pages and prefills only the suffix. 0 = off (default).
    conversation_kv_bytes: int = 0
    # Disk level under the host budget: the coldest parked conversations
    # spill to conversation_kv_dir instead of being dropped; a resume that
    # finds its turn on disk promotes it back to host. 0 = no spill.
    conversation_kv_disk_bytes: int = 0
    # Directory of spilled conversation blobs (one file per conversation,
    # written to a temporary name and renamed), under the process's temporary
    # directory by default. The tier deletes its own files when it closes,
    # and the directory only when the tier made it and it is left empty.
    conversation_kv_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "tpusc_conv_kv"))


@dataclass
class CacheConfig:
    """Disk artifact cache."""

    base_dir: str = "/tmp/tpusc_models"
    disk_capacity_bytes: int = 10 << 30


@dataclass
class ModelProviderConfig:
    """Where artifacts are fetched from (the port has the disk provider)."""

    type: str = "disk"
    base_dir: str = "./models"


@dataclass
class CacheNodePorts:
    """The cache node's REST port (0 binds an ephemeral port)."""

    rest_port: int = 8094


@dataclass
class MeshConfig:
    """Device groups (the reference's ``mesh`` section). Only the in-process
    group size is ported: with ``chips_per_group > 1`` the node serves from
    one group of that many devices driven by this process (a ``"ring"``
    model splits its sequence over them). The reference's cross-process
    fields (coordinator, num_processes, process_id, worker_addrs) and its
    axis_names/data_parallel are logged as unknown keys and ignored."""

    chips_per_group: int = 1


@dataclass
class Config:
    serving: ServingConfig = field(default_factory=ServingConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    model_provider: ModelProviderConfig = field(default_factory=ModelProviderConfig)
    cache_node: CacheNodePorts = field(default_factory=CacheNodePorts)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def _apply_mapping(cfg: Any, data: Mapping[str, Any], path: str = "") -> None:
    known = {f.name for f in dataclasses.fields(cfg)}
    unknown = set(data) - known
    if unknown:
        log.warning(
            "ignoring unknown config key(s) %s under %r (known: %s)",
            sorted(unknown), path or ".", sorted(known),
        )
    for f in dataclasses.fields(cfg):
        if f.name not in data:
            continue
        val = data[f.name]
        cur = getattr(cfg, f.name)
        if dataclasses.is_dataclass(cur):
            if val is None:
                continue
            if not isinstance(val, Mapping):
                raise ValueError(
                    f"config section {path}{f.name} must be a mapping, got {type(val).__name__}"
                )
            _apply_mapping(cur, val, f"{path}{f.name}.")
        else:
            setattr(cfg, f.name, type(cur)(val))


def config_from_dict(data: Mapping[str, Any] | None) -> Config:
    cfg = Config()
    _apply_mapping(cfg, data or {})
    return cfg


def load_config(path: str | None = None) -> Config:
    """A ``Config`` from a JSON (or YAML) file; defaults without a path."""
    if not path:
        return Config()
    with open(path) as fh:
        if path.endswith((".yaml", ".yml")):
            import yaml

            data = yaml.safe_load(fh) or {}
        else:
            data = json.load(fh)
    return config_from_dict(data)
