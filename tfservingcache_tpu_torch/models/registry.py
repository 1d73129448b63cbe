"""Model family registry + the ``tpusc.v2`` artifact format.

Counterpart of ``tfservingcache_tpu/models/registry.py``; the on-disk format
is the same, so artifacts written by either package load in the other:

    <name>/<version>/
      model.json   — {"format": "tpusc.v2", "family": ..., "config": ...,
                      "params": {"file": "params.bin", "manifest": [...]}}
      params.bin   — raw little-endian leaf bytes, grouped by dtype name,
                     16-byte-aligned offsets per the manifest

Leaves load as torch CPU tensors viewing one byte buffer (optionally in
pinned memory, ready for the host-to-device copy). bf16 leaves need no
``ml_dtypes``: their bytes are viewed as ``torch.bfloat16`` directly.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import numpy as np
import torch

ARTIFACT_FORMAT = "tpusc.v2"
MODEL_JSON = "model.json"
PARAMS_BIN = "params.bin"

_ALIGN = 16  # every leaf offset 16-byte aligned (valid views for any dtype)

# manifest dtype names <-> torch dtypes (names as numpy spells them)
_TORCH_DTYPES: dict[str, torch.dtype] = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ArtifactError(f"unsupported dtype {name!r}") from None


def dtype_name(dtype: torch.dtype) -> str:
    return _DTYPE_NAMES[dtype]


@dataclass(frozen=True)
class TensorSpec:
    """Shape entries are ints (static) or axis-name strings (dynamic); -1 is
    an alias for "batch". Each named axis buckets independently."""

    dtype: str
    shape: tuple[int | str, ...]

    def norm_shape(self) -> tuple[int | str, ...]:
        return tuple("batch" if d == -1 else d for d in self.shape)

    def dynamic_axes(self) -> list[tuple[int, str]]:
        return [(i, d) for i, d in enumerate(self.norm_shape()) if isinstance(d, str)]

    def np_dtype(self) -> np.dtype:
        """The numpy dtype requests are decoded to (bf16 has none here)."""
        return np.dtype(self.dtype)


@dataclass
class ModelDef:
    """A built, servable model family instance.

    ``make_module(params)`` wraps a params tree (tensors in the reference's
    pytree layout, already on their device) in an ``nn.Module`` whose
    ``forward(inputs)`` maps input tensors to output tensors."""

    family: str
    config: dict[str, Any]
    make_module: Callable[[Any], torch.nn.Module]
    init: Callable[[torch.Generator], Any]          # generator -> params tree
    input_spec: dict[str, TensorSpec]
    output_spec: dict[str, TensorSpec]
    method_name: str = "tensorflow/serving/predict"
    # name -> (fn(device_outputs, dyn_sizes), spec): computed on the device
    # after the forward, only when requested
    derived_outputs: dict[str, tuple[Callable[..., Any], TensorSpec]] = field(
        default_factory=dict
    )
    # outputs served when a request names none
    default_outputs: list[str] | None = None
    # float params are cast to this dtype when the artifact is written
    store_param_dtype: str | None = None
    # the reference's mesh-axis partition rules (param path regex -> axes);
    # a rule naming an axis is tensor parallelism, which the port does not
    # have yet: a group runtime refuses such a family
    partition_rules: dict[str, tuple] = field(default_factory=dict)
    # group-aware module factory (the reference's bind_mesh): families whose
    # forward itself needs the serving device group (ring attention) set
    # it, and a group runtime builds ``bind_group(group)(params)`` in place
    # of ``make_module(params)``; None = the family ignores the group
    bind_group: Callable[[tuple[torch.device, ...]], Callable[[Any], torch.nn.Module]] | None = None


_REGISTRY: dict[str, Callable[[dict[str, Any]], ModelDef]] = {}
_DEFAULT_CONFIGS: dict[str, dict[str, Any]] = {}


def register(name: str, default_config: dict[str, Any] | None = None):
    def deco(builder: Callable[[dict[str, Any]], ModelDef]):
        _REGISTRY[name] = builder
        _DEFAULT_CONFIGS[name] = default_config or {}
        return builder

    return deco


def families() -> list[str]:
    _load_builtin_families()
    return sorted(_REGISTRY)


_BUILD_CACHE: dict[str, ModelDef] = {}  # guarded-by: _BUILD_LOCK
_BUILD_LOCK = threading.Lock()


def build(family: str, config: dict[str, Any] | None = None) -> ModelDef:
    """Build (memoized per merged config) a family instance."""
    _load_builtin_families()
    if family not in _REGISTRY:
        raise KeyError(f"unknown model family {family!r}; known: {families()}")
    merged = dict(_DEFAULT_CONFIGS[family])
    merged.update(config or {})
    key = f"{family}|{json.dumps(merged, sort_keys=True, default=str)}"
    with _BUILD_LOCK:
        model = _BUILD_CACHE.get(key)
        if model is None:
            model = _REGISTRY[family](merged)
            _BUILD_CACHE[key] = model
    return model


_BUILTIN_MODULES = ("transformer_lm",)


def _load_builtin_families() -> None:
    import importlib

    for mod in _BUILTIN_MODULES:
        importlib.import_module(f"tfservingcache_tpu_torch.models.{mod}")


# ---------------------------------------------------------------------------
# Artifact IO
# ---------------------------------------------------------------------------

class ArtifactError(Exception):
    pass


def flatten_params(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in the reference's pytree order: dict keys sorted,
    lists by index, paths joined with "/"."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_params(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_params(v, f"{prefix}/{i}" if prefix else str(i))
        return out
    return [(prefix, tree)]


def _tensor_bytes(t: torch.Tensor) -> bytes:
    return t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""


def save_artifact(dest_dir: str, model: ModelDef, params: Any,
                  quantize: str | None = None) -> str:
    """Write ``params`` (a tree of torch tensors, on any device) as a
    ``tpusc.v2`` artifact that both packages load. Float leaves are cast to
    ``model.store_param_dtype``; leaves stream to disk one at a time."""
    if quantize is not None:
        raise ArtifactError("int8 artifacts: later slice of the port")
    os.makedirs(dest_dir, exist_ok=True)
    store = torch_dtype(model.store_param_dtype) if model.store_param_dtype else None
    flat = []
    for i, (path, leaf) in enumerate(flatten_params(params)):
        t = leaf.detach().to("cpu").contiguous()
        if store is not None and t.is_floating_point() and t.dtype != store:
            t = t.to(store)
        flat.append((dtype_name(t.dtype), i, path, t))
    # grouped by dtype NAME, then pytree order — the reference's layout
    flat.sort(key=lambda e: (e[0], e[1]))
    manifest = []
    offset = 0
    with open(os.path.join(dest_dir, PARAMS_BIN), "wb") as f:
        for name, _i, path, t in flat:
            pad = (-offset) % _ALIGN
            if pad:
                f.write(b"\0" * pad)
                offset += pad
            buf = _tensor_bytes(t)
            f.write(buf)
            manifest.append({
                "path": path, "dtype": name, "shape": list(t.shape),
                "offset": offset, "nbytes": len(buf),
            })
            offset += len(buf)
    meta = {
        "format": ARTIFACT_FORMAT,
        "family": model.family,
        "config": model.config,
        "param_dtype": model.store_param_dtype,
        "quantize": None,
        "params": {"file": PARAMS_BIN, "manifest": manifest},
        "signature": {
            "inputs": {k: [v.dtype, list(v.shape)] for k, v in model.input_spec.items()},
            "outputs": {k: [v.dtype, list(v.shape)] for k, v in model.output_spec.items()},
            "method_name": model.method_name,
        },
    }
    # model.json LAST: its presence marks the artifact complete
    with open(os.path.join(dest_dir, MODEL_JSON), "w") as f:
        json.dump(meta, f, indent=1)
    return dest_dir


def load_artifact(path: str, pin_memory: bool = False) -> tuple[ModelDef, Any]:
    """-> (ModelDef, params tree of CPU tensors). ``params.bin`` is read in
    one sequential read into one byte buffer (page-locked when
    ``pin_memory``) and every leaf is a view into it."""
    meta_path = os.path.join(path, MODEL_JSON)
    if not os.path.exists(meta_path):
        raise ArtifactError(f"not a tpusc artifact (no {MODEL_JSON}): {path}")
    with open(meta_path) as f:
        meta = json.load(f)
    fmt = meta.get("format")
    if fmt != ARTIFACT_FORMAT:
        raise ArtifactError(f"unsupported artifact format {fmt!r} in {path}")
    model = build(meta["family"], meta.get("config"))
    spec = meta.get("params") or {}
    bin_path = os.path.join(path, spec.get("file", PARAMS_BIN))
    if spec.get("manifest") is None or not os.path.exists(bin_path):
        raise ArtifactError(f"artifact missing params manifest or {bin_path}")
    size = os.path.getsize(bin_path)
    blob = torch.empty(size, dtype=torch.uint8, pin_memory=pin_memory)
    with open(bin_path, "rb") as f:
        if f.readinto(memoryview(blob.numpy())) != size:
            raise ArtifactError(f"short read of {bin_path}")
    return model, params_from_manifest(meta, blob, src=bin_path)


def params_from_manifest(meta: Mapping[str, Any], blob: Any,
                         src: str = "params blob") -> Any:
    """Rebuild the params tree from a v2 ``model.json`` dict plus the raw
    ``params.bin`` bytes (a uint8 torch tensor or numpy array). Leaves are
    views into ``blob``."""
    manifest = (meta.get("params") or {}).get("manifest")
    if manifest is None:
        raise ArtifactError(f"missing params manifest for {src}")
    if isinstance(blob, np.ndarray):
        blob = torch.from_numpy(blob)
    nested: dict[str, Any] = {}
    for ent in manifest:
        if ent.get("quant") is not None:
            raise ArtifactError(
                f"int8 artifacts: later slice of the port ({ent['path']!r} in {src})"
            )
        dt = torch_dtype(ent["dtype"])
        shape = [int(d) for d in ent["shape"]]
        n = int(np.prod(shape)) if shape else 1
        itemsize = torch.empty((), dtype=dt).element_size()
        off, nbytes = int(ent["offset"]), int(ent["nbytes"])
        if nbytes != n * itemsize or off + nbytes > blob.numel() or off % itemsize:
            raise ArtifactError(f"corrupt manifest entry {ent['path']!r} in {src}")
        raw = blob[off:off + nbytes]
        arr = (raw.view(dt) if n else torch.empty(0, dtype=dt)).reshape(shape)
        if ent["path"] == "":
            return arr  # params was a single bare array
        node = nested
        parts = ent["path"].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return _restore_lists(nested)


def _restore_lists(tree: Any) -> Any:
    """Dicts whose keys are all digits are the reference's lists."""
    if isinstance(tree, dict):
        restored = {k: _restore_lists(v) for k, v in tree.items()}
        if restored and all(k.isdigit() for k in restored):
            return [restored[k] for k in sorted(restored, key=int)]
        return restored
    return tree


def export_artifact(
    family: str,
    base_dir: str,
    name: str | None = None,
    version: int = 1,
    config: dict[str, Any] | None = None,
    seed: int = 0,
    device: str = "cuda",
) -> str:
    """Initialize a family with random params from a seeded
    ``torch.Generator`` on ``device`` (the card unless the caller asks for
    ``"cpu"``) and write ``<base_dir>/<name>/<version>/``."""
    model = build(family, config)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen)
    dest = os.path.join(base_dir, name or family, str(version))
    return save_artifact(dest, model, params)
