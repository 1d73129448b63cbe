"""transformer_lm — the flagship decoder LM family, in PyTorch.

Counterpart of ``tfservingcache_tpu/models/transformer_lm.py`` with the same
arithmetic and rounding points:
  - weights are ``(in, out)`` and used as ``x @ W``, cast to the config dtype
    at use (an artifact already stores them in it);
  - RMSNorm runs in f32, casts to the activation dtype, then multiplies by
    the gain cast to that dtype;
  - RoPE rotates interleaved pairs ``x[..., 0::2]``/``x[..., 1::2]``;
  - attention goes through ``ops.attention.attention`` (the flash kernel on
    CUDA), GQA without repeating K/V; with ``"attention": "ring"`` and a
    bound device group it goes through ``parallel.ring_attention`` (the
    carry kernel on CUDA) where the reference rings;
  - the output projection is the tied ``embed.T``; logits are f32.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn

from tfservingcache_tpu_torch.models.registry import (  # noqa: F401 - params_from_jax re-exported
    ModelDef,
    TensorSpec,
    params_from_jax,
    register,
)
from tfservingcache_tpu_torch.ops.attention import attention
from tfservingcache_tpu_torch.parallel.ring_attention import ring_attention

DEFAULT_CONFIG: dict[str, Any] = {
    "vocab_size": 2048,
    "d_model": 256,
    "n_layers": 4,
    "n_heads": 8,
    "n_kv_heads": 4,       # GQA
    "d_ff": 1024,
    "max_seq": 1024,
    "rope_theta": 10000.0,
    "dtype": "bfloat16",
    # "auto" = flash kernel on CUDA / plain attention elsewhere. "ring" =
    # context parallelism: on a runtime bound to a device group the sequence
    # is split over the group and K/V blocks rotate around it
    # (parallel/ring_attention.py, the carry kernel on CUDA) — for
    # long-context models whose attention working set exceeds one device
    "attention": "auto",
}

# llama-2-7b-class shape
LLAMA7B_CONFIG: dict[str, Any] = {
    "vocab_size": 32000,
    "d_model": 4096,
    "n_layers": 32,
    "n_heads": 32,
    "n_kv_heads": 32,
    "d_ff": 11008,
    "max_seq": 4096,
    "rope_theta": 10000.0,
    "dtype": "bfloat16",
}

AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, bool], torch.Tensor]


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * gain.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over (B, H, S, D), interleaved pairs."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = positions[:, None].float() * freqs[None, :]                  # (S, d/2)
    cos = torch.cos(angles)[None, None]                                   # (1,1,S,d/2)
    sin = torch.sin(angles)[None, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.reshape(x.shape).to(x.dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Attention(nn.Module):
    def __init__(self, p: dict, cfg: dict, group: tuple[torch.device, ...] | None = None) -> None:
        super().__init__()
        self.n_heads, self.n_kv = cfg["n_heads"], cfg["n_kv_heads"]
        self.theta = cfg["rope_theta"]
        self.wq, self.wk = _param(p["wq"]), _param(p["wk"])
        self.wv, self.wo = _param(p["wv"]), _param(p["wo"])
        # the ring's device group: only a "ring" model bound to a group of
        # more than one device rings
        ring = cfg.get("attention") == "ring" and group is not None and len(group) > 1
        self.ring_group = tuple(group) if ring else None

    def forward(self, x: torch.Tensor, attention_fn: AttentionFn) -> torch.Tensor:
        b, s, d_model = x.shape
        hd = d_model // self.n_heads
        dt = x.dtype
        q = (x @ self.wq.to(dt)).reshape(b, s, self.n_heads, hd).transpose(1, 2)
        k = (x @ self.wk.to(dt)).reshape(b, s, self.n_kv, hd).transpose(1, 2)
        v = (x @ self.wv.to(dt)).reshape(b, s, self.n_kv, hd).transpose(1, 2)
        positions = torch.arange(s, device=x.device)
        q = rope(q, positions, self.theta)
        k = rope(k, positions, self.theta)
        if self.ring_group is not None and s % len(self.ring_group) == 0:
            # context parallelism: the sequence split over the group's
            # devices, K/V rotating around it — a bucket the ring does not
            # divide (shorter than the group) falls through to attention_fn
            out = ring_attention(q, k, v, self.ring_group, causal=True)
        else:
            out = attention_fn(q, k, v, True)                            # (b,h,s,hd)
        out = out.transpose(1, 2).reshape(b, s, d_model)
        return out @ self.wo.to(dt)


class MLP(nn.Module):
    def __init__(self, p: dict) -> None:
        super().__init__()
        self.w1, self.w2, self.w3 = _param(p["w1"]), _param(p["w2"]), _param(p["w3"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        gate = F.silu(x @ self.w1.to(dt))
        up = x @ self.w3.to(dt)
        return (gate * up) @ self.w2.to(dt)


class Block(nn.Module):
    def __init__(self, p: dict, cfg: dict, group: tuple[torch.device, ...] | None = None) -> None:
        super().__init__()
        self.attn = Attention(p["attn"], cfg, group)
        self.mlp = MLP(p["mlp"])
        self.ln1, self.ln2 = _param(p["ln1"]), _param(p["ln2"])

    def forward(self, x: torch.Tensor, attention_fn: AttentionFn) -> torch.Tensor:
        x = x + self.attn(rmsnorm(x, self.ln1), attention_fn)
        return x + self.mlp(rmsnorm(x, self.ln2))


class TransformerLM(nn.Module):
    """``forward({"input_ids": (B, S) ints}) -> {"logits": (B, S, V) f32}``.
    ``attention_fn`` swaps the attention op (the plain path for checks).
    ``group`` binds a ``"ring"`` model to a device group (the reference's
    ``make_apply(mesh)``): the weights and everything but attention stay
    where ``params`` lie, each ring hop runs on its shard's device. A
    family that shares the attention half but not the FFN (moe_lm) sets
    ``block_cls``."""

    block_cls: type[nn.Module] = Block

    def __init__(self, params: dict, cfg: dict,
                 group: tuple[torch.device, ...] | None = None) -> None:
        super().__init__()
        self.dtype = getattr(torch, cfg["dtype"])
        self.embed = _param(params["embed"])
        self.layers = nn.ModuleList(self.block_cls(p, cfg, group) for p in params["layers"])
        self.ln_f = _param(params["ln_f"])

    def forward(
        self, inputs: dict[str, torch.Tensor], attention_fn: AttentionFn = attention
    ) -> dict[str, torch.Tensor]:
        # the reference's gather semantics: negative ids wrap, out-of-range
        # ids clamp (an unchecked CUDA index would fault the whole context)
        vocab = self.embed.shape[0]
        ids = inputs["input_ids"].long()
        ids = torch.where(ids < 0, ids + vocab, ids).clamp(0, vocab - 1)
        x = self.embed[ids].to(self.dtype)                              # (b,s,d)
        for layer in self.layers:
            x = layer(x, attention_fn)
        x = rmsnorm(x, self.ln_f)
        # logits in f32 for a stable softmax/argmax downstream
        return {"logits": (x @ self.embed.to(self.dtype).T).float()}


@register("transformer_lm", DEFAULT_CONFIG)
def build(config: dict) -> ModelDef:
    cfg = config
    mode = cfg.get("attention", "auto")
    if mode not in ("auto", "ring"):
        raise ValueError(f"attention={mode!r} is not ported (only 'auto' and 'ring')")
    ring = mode == "ring"
    if ring and cfg["n_heads"] != cfg["n_kv_heads"]:
        raise ValueError(
            "attention='ring' requires n_heads == n_kv_heads (the ring "
            "rotates full K/V blocks; grouped-KV ring is not implemented)"
        )

    def make_module(params: Any) -> nn.Module:
        return TransformerLM(params, cfg)

    def bind_group(group: tuple[torch.device, ...]) -> Callable[[Any], nn.Module]:
        return lambda params: TransformerLM(params, cfg, group)

    def init(gen: torch.Generator) -> dict:
        """Random params in the reference's layout: N(0, 1/fan_in) weights in
        f32, unit norm gains."""
        d, v, ff = cfg["d_model"], cfg["vocab_size"], cfg["d_ff"]
        n_heads, n_kv = cfg["n_heads"], cfg["n_kv_heads"]
        head_dim = d // n_heads
        dev = gen.device

        def dense(fan_in: int, shape: tuple[int, ...]) -> torch.Tensor:
            return torch.randn(shape, generator=gen, device=dev) / math.sqrt(fan_in)

        def ones(n: int) -> torch.Tensor:
            return torch.ones(n, device=dev)

        layers = []
        for _ in range(cfg["n_layers"]):
            layers.append({
                "attn": {
                    "wq": dense(d, (d, n_heads * head_dim)),
                    "wk": dense(d, (d, n_kv * head_dim)),
                    "wv": dense(d, (d, n_kv * head_dim)),
                    "wo": dense(n_heads * head_dim, (n_heads * head_dim, d)),
                },
                "mlp": {
                    "w1": dense(d, (d, ff)),
                    "w2": dense(ff, (ff, d)),
                    "w3": dense(d, (d, ff)),
                },
                "ln1": ones(d),
                "ln2": ones(d),
            })
        return {"embed": dense(d, (v, d)), "layers": layers, "ln_f": ones(d)}

    def last_token_logits(outputs: dict, dyn_sizes: dict) -> torch.Tensor:
        """On-device slice at the last REAL position (the runtime pads seq to
        a bucket): ships (B, V) to the host instead of (B, S, V)."""
        logits = outputs["logits"]
        s = dyn_sizes.get("seq", logits.shape[1])
        b = dyn_sizes.get("batch", logits.shape[0])
        return logits[:b, s - 1, :]

    if ring:
        # context parallelism owns the group for the SEQUENCE; no weight is
        # sharded (the reference replicates them: everything -> ())
        partition_rules: dict[str, tuple] = {r".*": ()}
    else:
        # the reference's Megatron-style tensor parallelism over the "model"
        # axis; the port has no tensor parallelism yet, so a group runtime
        # refuses these rules (runtime/model_runtime.py)
        partition_rules = {
            "embed": (None, "model"),
            r"layers/\d+/attn/w[qkv]": (None, "model"),
            r"layers/\d+/attn/wo": ("model", None),
            r"layers/\d+/mlp/w[13]": (None, "model"),
            r"layers/\d+/mlp/w2": ("model", None),
            r".*ln.*": (None,),
        }

    return ModelDef(
        family="transformer_lm",
        config=cfg,
        make_module=make_module,
        init=init,
        input_spec={"input_ids": TensorSpec("int32", ("batch", "seq"))},
        output_spec={"logits": TensorSpec("float32", ("batch", "seq", cfg["vocab_size"]))},
        derived_outputs={
            "last_token_logits": (
                last_token_logits,
                TensorSpec("float32", ("batch", cfg["vocab_size"])),
            )
        },
        default_outputs=["last_token_logits"],
        store_param_dtype=cfg["dtype"],
        partition_rules=partition_rules,
        # a ring model needs its serving group inside the forward
        bind_group=bind_group if ring else None,
    )
