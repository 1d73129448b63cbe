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

An int8 artifact (``save_artifact(quantize="int8")``) stores each large
float weight as int8 plus per-output-channel f32 scales: the cold load's
host-to-device copy ships about half the bytes of a bf16 artifact, and the
runtime dequantizes on the device. ``load_artifact(raw_quant=True)`` returns
those weights as ``QuantLeaf`` (what the runtime's packed transfer ships);
the default load dequantizes them on the host.
"""

from __future__ import annotations

import json
import math
import mmap
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

# int8 quantization floor (reference registry.py:204): leaves below this many
# elements (norms, biases, small projections) keep their float dtype
_QUANT_MIN_ELEMS = 65536

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


_BUILTIN_MODULES = ("half_plus_two", "mnist_cnn", "transformer_lm", "moe_lm")


def _load_builtin_families() -> None:
    import importlib

    for mod in _BUILTIN_MODULES:
        importlib.import_module(f"tfservingcache_tpu_torch.models.{mod}")


# ---------------------------------------------------------------------------
# Artifact IO
# ---------------------------------------------------------------------------

class ArtifactError(Exception):
    pass


class QuantLeaf:
    """An int8-shipped weight (reference registry.py:210): ``q`` (int8) and
    the per-output-channel ``scale`` (f32, the last axis kept, every other
    axis 1), dequantized to ``orig_dtype`` on the device after the copy. A
    plain class: ``flatten_params`` and the runtime's packed transfer take
    it as one leaf, whose two tensors ship in the int8 and the f32 group."""

    def __init__(self, q: Any, scale: Any, orig_dtype: str) -> None:
        self.q = q
        self.scale = scale
        self.orig_dtype = orig_dtype

    def dequant_host(self) -> torch.Tensor:
        """``(q as f32 * scale)`` cast to ``orig_dtype`` on the host: the
        reference's ``dequant_host`` bit for bit (one f32 product a
        value, then one rounding)."""
        q, scale = torch.as_tensor(self.q), torch.as_tensor(self.scale)
        return (q.to(torch.float32) * scale).to(torch_dtype(self.orig_dtype))


def _quantize_int8(a: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-channel (last axis) symmetric int8 (reference :256):
    ``scale = max(amax / 127, 1e-12)`` in f32 over every other axis,
    ``q = clip(round_half_even(a / scale), -127, 127)``. It runs in numpy on
    the f32 value of each element (a bf16 weight widened exactly), as the
    reference's ``a.astype(np.float32)`` does, so the bytes are its bytes."""
    af = a.detach().to("cpu", torch.float32).numpy()
    reduce_axes = tuple(range(af.ndim - 1))
    amax = np.max(np.abs(af), axis=reduce_axes, keepdims=True)
    scale = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.round(af / scale), -127, 127).astype(np.int8)
    return q, scale


def _leaf_bytes(t: Any) -> bytes:
    if isinstance(t, np.ndarray):
        return np.ascontiguousarray(t).tobytes()
    return _tensor_bytes(torch.as_tensor(t).detach().to("cpu").contiguous())


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


def unflatten_params(paths: list[str], leaves: list[Any]) -> Any:
    """The tree ``flatten_params`` flattened, from its paths and leaves."""
    if paths == [""]:
        return leaves[0]  # params was a single bare array
    nested: dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = nested
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return _restore_lists(nested)


def _tensor_bytes(t: torch.Tensor) -> bytes:
    return t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""


def save_artifact(dest_dir: str, model: ModelDef, params: Any,
                  quantize: str | None = None) -> str:
    """Write ``params`` (a tree of torch tensors, on any device) as a
    ``tpusc.v2`` artifact that both packages load. Float leaves are cast to
    ``model.store_param_dtype``; leaves stream to disk one at a time.

    ``quantize="int8"`` (reference :268) stores every float leaf of two or
    more axes and at least ``_QUANT_MIN_ELEMS`` elements as int8 plus f32
    scales (``_quantize_int8``). ``QuantLeaf`` inputs (a ``raw_quant``
    load's tree) are written as they are, never quantized again."""
    if quantize not in (None, "int8"):
        raise ArtifactError(f"unsupported quantize scheme {quantize!r}")
    os.makedirs(dest_dir, exist_ok=True)
    store = torch_dtype(model.store_param_dtype) if model.store_param_dtype else None
    flat = []
    for i, (path, leaf) in enumerate(flatten_params(params)):
        if isinstance(leaf, QuantLeaf):
            flat.append(("int8", i, path, leaf))
            continue
        t = leaf.detach().to("cpu").contiguous()
        if store is not None and t.is_floating_point() and t.dtype != store:
            t = t.to(store)
        flat.append((dtype_name(t.dtype), i, path, t))
    # grouped by dtype NAME, then pytree order — the reference's layout. A
    # QuantLeaf sorts as "int8"; a float leaf quantized below keeps its own
    # dtype's name as its key, as in the reference
    flat.sort(key=lambda e: (e[0], e[1]))
    manifest = []
    offset = 0
    with open(os.path.join(dest_dir, PARAMS_BIN), "wb") as f:
        def write_aligned(buf: bytes) -> int:
            nonlocal offset
            pad = (-offset) % _ALIGN
            if pad:
                f.write(b"\0" * pad)
                offset += pad
            start = offset
            f.write(buf)
            offset += len(buf)
            return start

        def write_quant(entry, q, scale, orig_dtype: str) -> None:
            qb, sb = _leaf_bytes(q), _leaf_bytes(scale)
            entry["dtype"] = "int8"
            entry["offset"] = write_aligned(qb)
            entry["nbytes"] = len(qb)
            entry["quant"] = {
                "orig_dtype": orig_dtype,
                "scale_dtype": "float32",
                "scale_shape": list(scale.shape),
                "scale_offset": write_aligned(sb),
                "scale_nbytes": len(sb),
            }

        for name, _i, path, t in flat:
            if isinstance(t, QuantLeaf):
                # the reference's key order for a carried leaf: path, shape, dtype
                entry = {"path": path, "shape": list(t.q.shape)}
                write_quant(entry, t.q, t.scale, t.orig_dtype)
                manifest.append(entry)
                continue
            entry = {"path": path, "dtype": name, "shape": list(t.shape)}
            if (quantize == "int8" and t.is_floating_point() and t.dim() >= 2
                    and t.numel() >= _QUANT_MIN_ELEMS):
                q, scale = _quantize_int8(t)
                write_quant(entry, q, scale, name)
            else:
                buf = _tensor_bytes(t)
                entry["offset"] = write_aligned(buf)
                entry["nbytes"] = len(buf)
            manifest.append(entry)
    meta = {
        "format": ARTIFACT_FORMAT,
        "family": model.family,
        "config": model.config,
        "param_dtype": model.store_param_dtype,
        "quantize": quantize,
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


def load_artifact(path: str, pin_memory: bool = False, map_params: bool = False,
                  raw_quant: bool = False) -> tuple[ModelDef, Any]:
    """-> (ModelDef, params tree of CPU tensors). ``params.bin`` is read in
    one sequential read into one byte buffer (page-locked when
    ``pin_memory``), or with ``map_params`` mapped privately (its pages come
    from the page cache as they are first read, and nothing is
    page-locked: the pipelined load's read); every leaf is a view into the
    buffer. An int8 artifact's quantized leaves come back as ``QuantLeaf``
    views with ``raw_quant`` (what the runtime ships and dequantizes on the
    device), else dequantized on the host."""
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
    if map_params and size:
        with open(bin_path, "rb") as f:
            # private and writable, so that torch may view it; no write
            # ever reaches the file
            mapped = mmap.mmap(f.fileno(), size, flags=mmap.MAP_PRIVATE,
                               prot=mmap.PROT_READ | mmap.PROT_WRITE)
        blob = torch.from_numpy(np.frombuffer(mapped, dtype=np.uint8))
    else:
        blob = torch.empty(size, dtype=torch.uint8, pin_memory=pin_memory)
        with open(bin_path, "rb") as f:
            if f.readinto(memoryview(blob.numpy())) != size:
                raise ArtifactError(f"short read of {bin_path}")
    return model, params_from_manifest(meta, blob, src=bin_path, raw_quant=raw_quant)


def params_from_manifest(meta: Mapping[str, Any], blob: Any,
                         src: str = "params blob", raw_quant: bool = False) -> Any:
    """Rebuild the params tree from a v2 ``model.json`` dict plus the raw
    ``params.bin`` bytes (a uint8 torch tensor or numpy array). Leaves are
    views into ``blob``; a quantized leaf is a ``QuantLeaf`` of two views
    with ``raw_quant``, else its host dequant (reference :437)."""
    manifest = (meta.get("params") or {}).get("manifest")
    if manifest is None:
        raise ArtifactError(f"missing params manifest for {src}")
    if isinstance(blob, np.ndarray):
        blob = torch.from_numpy(blob)
    nested: dict[str, Any] = {}
    for ent in manifest:
        arr = _view(blob, ent["dtype"], ent["shape"], ent["offset"], ent["nbytes"])
        if arr is None:
            raise ArtifactError(f"corrupt manifest entry {ent['path']!r} in {src}")
        quant = ent.get("quant")
        if quant is not None:
            scale = _view(blob, quant.get("scale_dtype", "float32"), quant["scale_shape"],
                          quant["scale_offset"], quant["scale_nbytes"])
            if scale is None:
                raise ArtifactError(f"corrupt quant scales for {ent['path']!r} in {src}")
            ql = QuantLeaf(arr, scale, quant["orig_dtype"])
            arr = ql if raw_quant else ql.dequant_host()
        if ent["path"] == "":
            return arr  # params was a single bare array
        node = nested
        parts = ent["path"].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return _restore_lists(nested)


def _view(blob: torch.Tensor, dtype: str, shape: Any, offset: Any,
          nbytes: Any) -> torch.Tensor | None:
    """The manifest's leaf as a view into ``blob``; None when its byte
    count, range or alignment does not fit."""
    dt = torch_dtype(dtype)
    shape = [int(d) for d in shape]
    n = math.prod(shape)
    itemsize = torch.empty((), dtype=dt).element_size()
    off, nbytes = int(offset), int(nbytes)
    if nbytes != n * itemsize or off + nbytes > blob.numel() or off % itemsize:
        return None
    return (blob[off:off + nbytes].view(dt) if n else torch.empty(0, dtype=dt)).reshape(shape)


def resident_bytes_estimate(path: str) -> int | None:
    """Device bytes of an artifact's params once loaded (None when the
    manifest is unreadable): the manifest's element counts times each
    leaf's dtype size (a quantized leaf's original dtype). The assignment
    warmer sizes its headroom check with it."""
    try:
        with open(os.path.join(path, MODEL_JSON)) as f:
            meta = json.load(f)
        manifest = (meta.get("params") or {}).get("manifest")
        if manifest is None:
            return None
        total = 0
        for ent in manifest:
            n = math.prod(ent["shape"]) if ent["shape"] else 1
            quant = ent.get("quant")
            dt = torch_dtype(quant["orig_dtype"] if quant else ent["dtype"])
            total += n * torch.empty((), dtype=dt).element_size()
        return total
    except Exception:  # noqa: BLE001 - estimate only; callers fall back
        return None


def _restore_lists(tree: Any) -> Any:
    """Dicts whose keys are all digits are the reference's lists."""
    if isinstance(tree, dict):
        restored = {k: _restore_lists(v) for k, v in tree.items()}
        if restored and all(k.isdigit() for k in restored):
            return [restored[k] for k in sorted(restored, key=int)]
        return restored
    return tree


def params_from_jax(tree: Any) -> Any:
    """A params tree the JAX package built or loaded (numpy or jax leaves,
    bf16 ones from ``ml_dtypes``) as CPU tensors in the same layout, which
    is the one every port family's ``make_module`` takes: transformer_lm's
    ``(in, out)`` weights, half_plus_two's scalars, mnist_cnn's flax tree
    with HWIO kernels. A bf16 leaf keeps its bits (no ``ml_dtypes`` needed
    here: its bytes are reinterpreted)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def export_artifact(
    family: str,
    base_dir: str,
    name: str | None = None,
    version: int = 1,
    config: dict[str, Any] | None = None,
    seed: int = 0,
    device: str = "cuda",
    quantize: str | None = None,
) -> str:
    """Initialize a family with random params from a seeded
    ``torch.Generator`` on ``device`` (the card unless the caller asks for
    ``"cpu"``) and write ``<base_dir>/<name>/<version>/`` (int8 with
    ``quantize="int8"``)."""
    if quantize not in (None, "int8"):
        raise ArtifactError(f"unsupported quantize scheme {quantize!r}")
    model = build(family, config)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen)
    dest = os.path.join(base_dir, name or family, str(version))
    return save_artifact(dest, model, params, quantize=quantize)
