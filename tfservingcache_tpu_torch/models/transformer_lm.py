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

On a device group of more than one device an ``"auto"`` model is tensor
parallel (``TensorParallelLM``): the reference's Megatron rules cut the
weights over the group (``parallel/sharding.py``), and each shard computes
its heads and its slice of the FFN. On a group that spans processes each
process computes its own members' shards and the partials meet over
``torch.distributed`` (``reduce_partials``).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn

from tfservingcache_tpu_torch.models.registry import (  # noqa: F401 - params_from_jax re-exported
    ModelDef,
    TensorParallelPlan,
    TensorSpec,
    cut_halves,
    params_from_jax,
    register,
)
from tfservingcache_tpu_torch.ops.attention import attention
from tfservingcache_tpu_torch.parallel.mesh import (
    gather_members,
    is_remote,
    local_lead,
    local_members,
    spans_processes,
)
from tfservingcache_tpu_torch.parallel.ring_attention import ring_attention
from tfservingcache_tpu_torch.parallel.sharding import ShardedLeaf

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


def qkv(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor, n_heads: int,
        n_kv: int, head_dim: int, theta: float) -> tuple[torch.Tensor, ...]:
    """The rotated (B, H, S, D) q, k, v of ``x`` (B, S, d), the weights
    cast to x's dtype at use."""
    b, s, _d = x.shape
    dt = x.dtype
    q = (x @ wq.to(dt)).reshape(b, s, n_heads, head_dim).transpose(1, 2)
    k = (x @ wk.to(dt)).reshape(b, s, n_kv, head_dim).transpose(1, 2)
    v = (x @ wv.to(dt)).reshape(b, s, n_kv, head_dim).transpose(1, 2)
    positions = torch.arange(s, device=x.device)
    return rope(q, positions, theta), rope(k, positions, theta), v


def mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gate = F.silu(x @ w1.to(dt))
    up = x @ w3.to(dt)
    return (gate * up) @ w2.to(dt)


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
        q, k, v = qkv(x, self.wq, self.wk, self.wv, self.n_heads, self.n_kv,
                      d_model // self.n_heads, self.theta)
        if self.ring_group is not None and s % len(self.ring_group) == 0:
            # context parallelism: the sequence split over the group's
            # devices, K/V rotating around it — a bucket the ring does not
            # divide (shorter than the group) falls through to attention_fn
            out = ring_attention(q, k, v, self.ring_group, causal=True)
        else:
            out = attention_fn(q, k, v, True)                            # (b,h,s,hd)
        out = out.transpose(1, 2).reshape(b, s, d_model)
        return out @ self.wo.to(x.dtype)


class MLP(nn.Module):
    def __init__(self, p: dict) -> None:
        super().__init__()
        self.w1, self.w2, self.w3 = _param(p["w1"]), _param(p["w2"]), _param(p["w3"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(x, self.w1, self.w2, self.w3)


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


def reduce_partials(parts: list[torch.Tensor], lead: torch.device,
                    devices: tuple[torch.device, ...] | None = None) -> torch.Tensor:
    """The sum of the shards' partial results on ``lead``: each moves there
    with ``.to(lead, non_blocking=True)`` (ordered after the work queued on
    both devices' current streams), the partials add in f32 in shard order,
    and the sum rounds once to their dtype, where the one-device product
    rounds its output. One partial comes back as it is. ``devices`` are the
    half's members: where they span processes, ``parts`` are this process's
    members' partials and every member's comes first through
    ``parallel.mesh.gather_members`` (exact f32 copies), so that each
    process holds the one-process group's sum bit for bit."""
    dtype = parts[0].dtype
    if spans_processes(devices):
        parts = gather_members([p.to(lead, non_blocking=True) for p in parts], devices)
    if len(parts) == 1:
        return parts[0].to(lead, non_blocking=True)
    acc = parts[0].to(lead, non_blocking=True).to(torch.float32, copy=True)
    for part in parts[1:]:
        acc += part.to(lead, non_blocking=True)
    return acc.to(dtype)


def _lead_shard(leaf: ShardedLeaf, group: tuple[torch.device, ...]) -> torch.Tensor:
    """A replicated leaf's copy on this process's leader."""
    return leaf.shards[local_members(group)[0]]


def _half(leaf: ShardedLeaf, group: tuple[torch.device, ...]) -> tuple[torch.device, ...]:
    """The devices a half whose weights are placed like ``leaf`` runs on:
    every member for a cut leaf (those another process owns are skipped at
    run time), this process's leader for a replicated one."""
    return tuple(group) if leaf.dim is not None else (local_lead(group),)


def _shards(leaf: ShardedLeaf, group: tuple[torch.device, ...]) -> nn.ParameterList:
    """A half's weights on ``_half``'s devices: a cut leaf's P shards (meta
    tensors on another process's members), or the leader's copy."""
    if leaf.dim is None:
        return nn.ParameterList([_param(_lead_shard(leaf, group))])
    return nn.ParameterList(_param(t) for t in leaf.shards)


class TPAttention(nn.Module):
    """The attention half on a group: with ``wq``/``wk``/``wv`` cut by
    columns and ``wo`` by rows, shard i computes q, k, v of its
    ``n_heads / P`` query and ``n_kv_heads / P`` KV heads, runs attention on
    them through ``attention_fn`` (the flash kernel on a card) and
    multiplies by its row block of ``wo``; the partials are reduced on the
    leader. Replicated weights (P does not divide ``n_kv_heads``) run the
    whole half on the leader. ``n_heads``/``n_kv`` are one shard's head
    counts. On a group that spans processes the shards of another process's
    members are skipped here and their partials gathered. The cached forward of ``:generate`` (``models/generation.py``)
    runs the same shards, each against its own shard of the KV cache, and
    reduces the same products the same way."""

    def __init__(self, p: dict[str, ShardedLeaf], cfg: dict,
                 group: tuple[torch.device, ...]) -> None:
        super().__init__()
        self.devices = _half(p["wq"], group)
        n = len(self.devices)
        self.n_heads, self.n_kv = cfg["n_heads"] // n, cfg["n_kv_heads"] // n
        self.head_dim = cfg["d_model"] // cfg["n_heads"]
        self.theta = cfg["rope_theta"]
        self.wq, self.wk = _shards(p["wq"], group), _shards(p["wk"], group)
        self.wv, self.wo = _shards(p["wv"], group), _shards(p["wo"], group)

    def forward(self, h: torch.Tensor, attention_fn: AttentionFn) -> torch.Tensor:
        b, s, _d = h.shape
        parts = []
        for i, dev in enumerate(self.devices):
            if is_remote(dev):
                continue
            x = h.to(dev, non_blocking=True)
            q, k, v = qkv(x, self.wq[i], self.wk[i], self.wv[i], self.n_heads, self.n_kv,
                          self.head_dim, self.theta)
            out = attention_fn(q, k, v, True).transpose(1, 2).reshape(b, s, -1)
            parts.append(out @ self.wo[i].to(x.dtype))
        return reduce_partials(parts, h.device, self.devices)


class TPMLP(nn.Module):
    """The FFN half on a group: ``w1``/``w3`` cut by columns, ``w2`` by rows,
    each shard's ``silu(x w1_i) * (x w3_i) @ w2_i`` reduced on the leader;
    replicated (P does not divide ``d_ff``), the whole half on the leader."""

    def __init__(self, p: dict[str, ShardedLeaf], group: tuple[torch.device, ...]) -> None:
        super().__init__()
        self.devices = _half(p["w1"], group)
        self.w1, self.w2 = _shards(p["w1"], group), _shards(p["w2"], group)
        self.w3 = _shards(p["w3"], group)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        parts = [mlp(h.to(dev, non_blocking=True), self.w1[i], self.w2[i], self.w3[i])
                 for i, dev in enumerate(self.devices) if not is_remote(dev)]
        return reduce_partials(parts, h.device, self.devices)


class TPBlock(nn.Module):
    """``Block`` on a group: the norms (replicated) and the residual stream
    on the leader, each half tensor parallel."""

    def __init__(self, p: dict, cfg: dict, group: tuple[torch.device, ...]) -> None:
        super().__init__()
        self.attn = TPAttention(p["attn"], cfg, group)
        self.ffn = TPMLP(p["mlp"], group)
        self.ln1 = _param(_lead_shard(p["ln1"], group))
        self.ln2 = _param(_lead_shard(p["ln2"], group))

    def forward(self, x: torch.Tensor, attention_fn: AttentionFn) -> torch.Tensor:
        x = x + self.attn(rmsnorm(x, self.ln1), attention_fn)
        return x + self.ffn(rmsnorm(x, self.ln2))


class TensorParallelLM(nn.Module):
    """``TransformerLM`` over a tree that ``parallel.sharding.shard_params``
    placed on a device group (Megatron tensor parallelism, the program the
    reference's GSPMD compiles from the same partition rules). The input,
    the residual stream, the norms and the logits live on ``group[0]``, the
    leader. The embedding, cut by its d_model columns, is gathered per
    shard and concatenated on the leader; the tied head contracts each
    shard's column slice and sums the partial logits. Every reduce
    (attention's ``wo``, the FFN's ``w2``, the head) moves the partials to
    the leader and adds them in f32 in shard order, rounding the sum once to
    the activation dtype where the one-device product rounds its output
    (``reduce_partials``); the sum then moves back to each shard for the
    next half-layer. A half whose width the group does not divide is
    replicated and runs whole on the leader (``tensor_parallel_plan``). On a
    group that repeats one device the shards run one after another there;
    each shard is a contiguous tensor of its own and the whole leaf is gone
    once it is cut, so the device holds one copy of the weights. On a group
    that spans processes (``parallel/mesh.py``) the leader is this process's
    first member: each process runs its own members' shards, holds the
    replicated stream, norms and logits, and runs a half the group does not
    cut itself; every reduce and the embedding's concatenation gather the
    members' results over ``torch.distributed``. A family whose FFN differs
    (moe_lm) sets ``block_cls``."""

    block_cls: type[nn.Module] = TPBlock

    def __init__(self, sharded: dict, cfg: dict, group: tuple[torch.device, ...]) -> None:
        super().__init__()
        self.dtype = getattr(torch, cfg["dtype"])
        self.group = tuple(group)
        self.lead = local_lead(self.group)
        embed = sharded["embed"]
        self.embed_devices = _half(embed, self.group)
        self.embed = _shards(embed, self.group)
        self.vocab = embed.shape[0]
        self.layers = nn.ModuleList(self.block_cls(p, cfg, self.group) for p in sharded["layers"])
        self.ln_f = _param(_lead_shard(sharded["ln_f"], self.group))

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """The embedding of ``ids`` on the leader in the model dtype, with
        the reference's gather semantics (negative ids wrap, out-of-range
        ids clamp): each shard gathers its d_model columns, concatenated on
        the leader in shard order (gathered across processes first)."""
        lead = self.lead
        ids = ids.long().to(lead)
        ids = torch.where(ids < 0, ids + self.vocab, ids).clamp(0, self.vocab - 1)
        cols = [e[ids.to(dev, non_blocking=True)].to(lead, non_blocking=True)
                for e, dev in zip(self.embed, self.embed_devices) if not is_remote(dev)]
        if spans_processes(self.embed_devices):
            cols = gather_members(cols, self.embed_devices)
        return torch.cat(cols, dim=-1).to(self.dtype)

    def tied_logits(self, x: torch.Tensor) -> torch.Tensor:
        """The tied head over the normed stream ``x`` on the leader -> f32
        logits: each shard contracts its column slice of ``x`` with its
        slice of the embedding, the partial logits reduced on the leader."""
        width = x.shape[-1] // len(self.embed_devices)
        parts = [x[..., i * width:(i + 1) * width].to(dev, non_blocking=True) @ e.to(self.dtype).T
                 for i, (e, dev) in enumerate(zip(self.embed, self.embed_devices))
                 if not is_remote(dev)]
        return reduce_partials(parts, self.lead, self.embed_devices).float()

    def forward(
        self, inputs: dict[str, torch.Tensor], attention_fn: AttentionFn = attention
    ) -> dict[str, torch.Tensor]:
        x = self.embed_tokens(inputs["input_ids"])
        for layer in self.layers:
            x = layer(x, attention_fn)
        return {"logits": self.tied_logits(rmsnorm(x, self.ln_f))}


# the weights of each half, replicated where the group does not divide it
_TP_HALVES = {
    "attn": r"layers/\d+/attn/w[qkvo]",
    "mlp": r"layers/\d+/mlp/w[123]",
    "embed": r"embed",
}


def tensor_parallel_plan(cfg: dict, rules: dict[str, tuple], group: tuple[torch.device, ...],
                         module_cls: type[nn.Module],
                         halves: tuple[str, ...] = ("attn", "mlp", "embed")) -> TensorParallelPlan:
    """The plan of a group of P devices over the family's ``halves``
    (``registry.cut_halves``): attention is cut where P divides
    ``n_kv_heads`` (then it also divides ``n_heads``), the FFN where P
    divides ``d_ff``, the embedding where P divides ``d_model``."""
    widths = {"attn": cfg["n_kv_heads"], "mlp": cfg["d_ff"], "embed": cfg["d_model"]}
    return cut_halves(rules, group, {half: (_TP_HALVES[half], widths[half]) for half in halves},
                      lambda sharded: module_cls(sharded, cfg, tuple(group)))


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

    def tensor_parallel(group: tuple[torch.device, ...]) -> TensorParallelPlan:
        return tensor_parallel_plan(cfg, partition_rules, group, TensorParallelLM)

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
        # axis: column-parallel QKV/W1/W3, row-parallel WO/W2; a group
        # runtime serves them through TensorParallelLM
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
        tensor_parallel=None if ring else tensor_parallel,
    )
