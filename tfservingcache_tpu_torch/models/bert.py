"""bert — the BERT encoder family (BASELINE.json config #3: 100 per-tenant
fine-tunes served from object storage), in PyTorch (counterpart of
``tfservingcache_tpu/models/bert.py``).

A bidirectional transformer encoder with a pooled classification head. The
params tree is the reference's: ``word_emb``, ``pos_emb``, ``type_emb``,
``emb_ln_{g,b}``, ``layers/i/{wq,bq,wk,bk,wv,bv,wo,bo,w1,b1,w2,b2,ln1_g,
ln1_b,ln2_g,ln2_b}`` with ``(in, out)`` weights, ``pool_{w,b}``,
``cls_{w,b}``. The arithmetic rounds where the reference's does:
  - the three embeddings are summed in the tables' dtype (f32), then cast to
    the compute dtype; layer norm runs in f32 (biased variance, eps 1e-12,
    gain and bias in f32) and rounds once;
  - inside a layer every weight and bias is in the compute dtype, each bias
    added after its product; the four layer-norm vectors stay f32;
  - attention is plain ops, as the reference's is plain jnp: f32 scores (q
    and k upcast before the product) over sqrt(head_dim), an additive f32
    mask bias of -1e30 (not -inf: an all-padding row, as the load's seq-1
    warm-up sends, stays finite), f32 softmax, probabilities cast to the
    compute dtype before the value product; GELU is the tanh form;
  - the head follows jnp's type promotion: ``x[:, 0] @ pool_w`` rounds to
    the compute dtype, adding the f32 ``pool_b`` promotes to f32, so tanh
    and the classifier run in f32.
The module holds the loaded tree's leaves as they are and casts each weight
to the compute dtype inside the forward, as the reference casts inside its
jitted apply: an f32 artifact served in bf16 keeps no second copy of its
weights on the device, and the resident bytes are the tree's bytes.

On a device group ``TensorParallelBert`` runs the reference's Megatron
rules (the program GSPMD compiles from them): ``w[qkv]`` cut by columns,
i.e. by heads, ``wo`` and ``w2`` by rows, ``w1`` by columns, ``word_emb``
over ``hidden``; the position and type tables, the biases, the norms, the
pooler and the classifier replicated. Shard i adds its slice of a
column-cut weight's bias; the partials of ``wo`` and ``w2`` reduce on the
leader in f32 in shard order and round once (``reduce_partials``), where
one device rounds its product, and the bias follows the sum.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from tfservingcache_tpu_torch.models.registry import (
    ModelDef,
    TensorParallelPlan,
    TensorSpec,
    cut_halves,
    register,
)
from tfservingcache_tpu_torch.models.transformer_lm import reduce_partials
from tfservingcache_tpu_torch.parallel.sharding import ShardedLeaf

DEFAULT_CONFIG: dict[str, Any] = {
    "vocab_size": 30522,
    "hidden": 768,
    "n_layers": 12,
    "n_heads": 12,
    "d_ff": 3072,
    "max_seq": 512,
    "type_vocab": 2,
    "num_labels": 2,
    "dtype": "bfloat16",
}

TINY_CONFIG: dict[str, Any] = {
    "vocab_size": 512,
    "hidden": 64,
    "n_layers": 2,
    "n_heads": 4,
    "d_ff": 128,
    "max_seq": 64,
    "type_vocab": 2,
    "num_labels": 3,
    "dtype": "bfloat16",
}

def layernorm(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """The reference's ``_layernorm``: f32 statistics (biased variance), gain
    and bias applied in f32, one rounding to ``x``'s dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gain + bias).to(x.dtype)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class EncoderLayer(nn.Module):
    def __init__(self, p: dict, n_heads: int) -> None:
        super().__init__()
        self.n_heads = n_heads
        for name, t in p.items():
            setattr(self, name, _frozen(t))

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = self.n_heads
        hd = d // h
        dt = x.dtype

        def dense(y: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
            # weight and bias cast to the compute dtype at use (reference :93)
            return y @ w.to(dt) + bias.to(dt)

        def heads(w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
            return dense(x, w, bias).reshape(b, s, h, hd).transpose(1, 2)

        q, k, v = heads(self.wq, self.bq), heads(self.wk, self.bk), heads(self.wv, self.bv)
        # f32 scores from the compute-dtype q and k (products exact in f32)
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(scores + mask_bias, dim=-1).to(dt)
        ctx = (probs @ v).transpose(1, 2).reshape(b, s, d)
        x = layernorm(x + dense(ctx, self.wo, self.bo), self.ln1_g, self.ln1_b)
        ff = F.gelu(dense(x, self.w1, self.b1), approximate="tanh")
        return layernorm(x + dense(ff, self.w2, self.b2), self.ln2_g, self.ln2_b)


class BertEncoder(nn.Module):
    """``forward({"input_ids": (B, S) ints, "attention_mask": (B, S) ints})
    -> {"logits": (B, num_labels) f32, "pooled_output": (B, hidden) f32}``."""

    def __init__(self, params: dict, cfg: dict) -> None:
        super().__init__()
        self.max_seq = cfg["max_seq"]
        self.dtype = getattr(torch, cfg["dtype"])
        for name in ("word_emb", "pos_emb", "type_emb", "emb_ln_g", "emb_ln_b",
                     "pool_w", "pool_b", "cls_w", "cls_b"):
            setattr(self, name, _frozen(params[name]))
        self.layers = nn.ModuleList(EncoderLayer(p, cfg["n_heads"]) for p in params["layers"])

    def forward(self, inputs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        ids = inputs["input_ids"].long()
        s = ids.shape[1]
        if s > self.max_seq:
            # beyond the table a position gather would clamp and return
            # confident garbage (reference :79)
            raise ValueError(f"sequence length {s} exceeds max_seq {self.max_seq}")
        # the reference's gather semantics: negative ids wrap, out-of-range
        # ids clamp (an unchecked CUDA index would fault the whole context)
        vocab = self.word_emb.shape[0]
        ids = torch.where(ids < 0, ids + vocab, ids).clamp(0, vocab - 1)
        x = (self.word_emb[ids] + self.pos_emb[:s][None] + self.type_emb[0]).to(self.dtype)
        x = layernorm(x, self.emb_ln_g, self.emb_ln_b)
        mask = inputs["attention_mask"].long()
        mask_bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e30).float()
        for layer in self.layers:
            x = layer(x, mask_bias)
        # jnp's promotion: a compute-dtype product plus the f32 bias is f32
        pooled = torch.tanh(x[:, 0] @ self.pool_w.to(self.dtype) + self.pool_b)
        head = torch.promote_types(pooled.dtype, self.dtype)
        logits = pooled.to(head) @ self.cls_w.to(self.dtype).to(head) + self.cls_b
        return {"logits": logits.float(), "pooled_output": pooled.float()}


def _cut(leaf: ShardedLeaf, n: int) -> nn.ParameterList:
    """The first ``n`` shards of a placed leaf (a replicated half's one
    whole weight on the leader when ``n`` is 1)."""
    return nn.ParameterList(_frozen(t) for t in leaf.shards[:n])


def _slices(bias: ShardedLeaf, n: int) -> nn.ParameterList:
    """A replicated bias of a column-cut weight as ``n`` slices, the i-th a
    view of the copy on shard i's device."""
    width = bias.shape[0] // n
    return nn.ParameterList(_frozen(bias.shards[i].narrow(0, i * width, width))
                            for i in range(n))


class TPEncoderLayer(nn.Module):
    """``EncoderLayer`` on a group: shard i computes the q, k, v of its
    ``n_heads / P`` heads, their attention and its rows of ``wo``; then its
    columns of ``w1`` and rows of ``w2``. The partials reduce on the leader,
    where the residual stream, the output biases and the norms live. A half
    whose width P does not divide runs whole on the leader."""

    def __init__(self, p: dict[str, ShardedLeaf], n_heads: int,
                 group: tuple[torch.device, ...]) -> None:
        super().__init__()
        self.attn_devices = group if p["wq"].dim is not None else group[:1]
        self.mlp_devices = group if p["w1"].dim is not None else group[:1]
        na, nm = len(self.attn_devices), len(self.mlp_devices)
        self.n_heads = n_heads // na
        self.wq, self.wk, self.wv, self.wo = (_cut(p[w], na) for w in ("wq", "wk", "wv", "wo"))
        self.bq, self.bk, self.bv = (_slices(p[b], na) for b in ("bq", "bk", "bv"))
        self.w1, self.w2 = _cut(p["w1"], nm), _cut(p["w2"], nm)
        self.b1 = _slices(p["b1"], nm)
        for name in ("bo", "b2", "ln1_g", "ln1_b", "ln2_g", "ln2_b"):
            setattr(self, name, _frozen(p[name].shards[0]))

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        dt = x.dtype
        hd = d // (self.n_heads * len(self.attn_devices))
        parts = []
        for i, dev in enumerate(self.attn_devices):
            xi = x.to(dev, non_blocking=True)

            def heads(w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
                y = xi @ w.to(dt) + bias.to(dt)
                return y.reshape(b, s, self.n_heads, hd).transpose(1, 2)

            q, k = heads(self.wq[i], self.bq[i]), heads(self.wk[i], self.bk[i])
            v = heads(self.wv[i], self.bv[i])
            scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
            probs = torch.softmax(scores + mask_bias.to(dev, non_blocking=True), dim=-1).to(dt)
            ctx = (probs @ v).transpose(1, 2).reshape(b, s, -1)
            parts.append(ctx @ self.wo[i].to(dt))
        x = layernorm(x + (reduce_partials(parts, x.device) + self.bo.to(dt)),
                      self.ln1_g, self.ln1_b)
        parts = [F.gelu(x.to(dev, non_blocking=True) @ self.w1[i].to(dt) + self.b1[i].to(dt),
                        approximate="tanh") @ self.w2[i].to(dt)
                 for i, dev in enumerate(self.mlp_devices)]
        return layernorm(x + (reduce_partials(parts, x.device) + self.b2.to(dt)),
                         self.ln2_g, self.ln2_b)


class TensorParallelBert(nn.Module):
    """``BertEncoder`` over a tree that ``parallel.sharding`` placed on a
    device group. The input, the residual stream, the norms and the head
    live on ``group[0]``, the leader. The word embedding, cut over
    ``hidden``, is gathered per shard and joined on the hidden axis on the
    leader before the position and type rows are added, so the embedding
    is one device's exactly. On a group that repeats one device the shards
    run one after another there."""

    def __init__(self, sharded: dict, cfg: dict, group: tuple[torch.device, ...]) -> None:
        super().__init__()
        self.max_seq = cfg["max_seq"]
        self.dtype = getattr(torch, cfg["dtype"])
        self.group = tuple(group)
        word = sharded["word_emb"]
        self.embed_devices = self.group if word.dim is not None else self.group[:1]
        self.word_emb = _cut(word, len(self.embed_devices))
        self.vocab = word.shape[0]
        for name in ("pos_emb", "type_emb", "emb_ln_g", "emb_ln_b",
                     "pool_w", "pool_b", "cls_w", "cls_b"):
            setattr(self, name, _frozen(sharded[name].shards[0]))
        self.layers = nn.ModuleList(TPEncoderLayer(p, cfg["n_heads"], self.group)
                                    for p in sharded["layers"])

    def forward(self, inputs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        lead = self.group[0]
        ids = inputs["input_ids"].long().to(lead)
        s = ids.shape[1]
        if s > self.max_seq:
            raise ValueError(f"sequence length {s} exceeds max_seq {self.max_seq}")
        ids = torch.where(ids < 0, ids + self.vocab, ids).clamp(0, self.vocab - 1)
        words = torch.cat([e[ids.to(dev, non_blocking=True)].to(lead, non_blocking=True)
                           for e, dev in zip(self.word_emb, self.embed_devices)], dim=-1)
        x = (words + self.pos_emb[:s][None] + self.type_emb[0]).to(self.dtype)
        x = layernorm(x, self.emb_ln_g, self.emb_ln_b)
        mask = inputs["attention_mask"].long().to(lead)
        mask_bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e30).float()
        for layer in self.layers:
            x = layer(x, mask_bias)
        pooled = torch.tanh(x[:, 0] @ self.pool_w.to(self.dtype) + self.pool_b)
        head = torch.promote_types(pooled.dtype, self.dtype)
        logits = pooled.to(head) @ self.cls_w.to(self.dtype).to(head) + self.cls_b
        return {"logits": logits.float(), "pooled_output": pooled.float()}


@register("bert", DEFAULT_CONFIG)
def build(config: dict) -> ModelDef:
    cfg = config

    def make_module(params: Any) -> nn.Module:
        return BertEncoder(params, cfg)

    def init(gen: torch.Generator) -> dict:
        """Random params in the reference's layout: N(0, 1/fan_in) weights and
        embeddings in f32, zero biases, unit layer-norm gains."""
        d, ff, v = cfg["hidden"], cfg["d_ff"], cfg["vocab_size"]
        dev = gen.device

        def dense(fan_in: int, shape: tuple[int, ...]) -> torch.Tensor:
            return torch.randn(shape, generator=gen, device=dev) / math.sqrt(fan_in)

        def zeros(n: int) -> torch.Tensor:
            return torch.zeros(n, device=dev)

        def ones(n: int) -> torch.Tensor:
            return torch.ones(n, device=dev)

        layers = [{
            "wq": dense(d, (d, d)), "bq": zeros(d),
            "wk": dense(d, (d, d)), "bk": zeros(d),
            "wv": dense(d, (d, d)), "bv": zeros(d),
            "wo": dense(d, (d, d)), "bo": zeros(d),
            "w1": dense(d, (d, ff)), "b1": zeros(ff),
            "w2": dense(ff, (ff, d)), "b2": zeros(d),
            "ln1_g": ones(d), "ln1_b": zeros(d),
            "ln2_g": ones(d), "ln2_b": zeros(d),
        } for _ in range(cfg["n_layers"])]
        return {
            "word_emb": dense(d, (v, d)),
            "pos_emb": dense(d, (cfg["max_seq"], d)),
            "type_emb": dense(d, (cfg["type_vocab"], d)),
            "emb_ln_g": ones(d), "emb_ln_b": zeros(d),
            "layers": layers,
            "pool_w": dense(d, (d, d)), "pool_b": zeros(d),
            "cls_w": dense(d, (d, cfg["num_labels"])),
            "cls_b": zeros(cfg["num_labels"]),
        }

    def tensor_parallel(group: tuple[torch.device, ...]) -> TensorParallelPlan:
        # attention is cut where P divides the heads, the FFN where it
        # divides d_ff, the word embedding where it divides hidden
        return cut_halves(partition_rules, group, {
            "attn": (r"layers/\d+/w[qkvo]", cfg["n_heads"]),
            "mlp": (r"layers/\d+/w[12]", cfg["d_ff"]),
            "embed": (r"word_emb", cfg["hidden"]),
        }, lambda sharded: TensorParallelBert(sharded, cfg, tuple(group)))

    # the reference's Megatron-style rules over the "model" axis, served on
    # a group by TensorParallelBert
    partition_rules = {
        r"layers/\d+/w[qkv]": (None, "model"),
        r"layers/\d+/wo": ("model", None),
        r"layers/\d+/w1": (None, "model"),
        r"layers/\d+/w2": ("model", None),
        r"word_emb": (None, "model"),
    }

    return ModelDef(
        family="bert",
        config=cfg,
        make_module=make_module,
        init=init,
        input_spec={
            "input_ids": TensorSpec("int32", ("batch", "seq")),
            "attention_mask": TensorSpec("int32", ("batch", "seq")),
        },
        output_spec={
            "logits": TensorSpec("float32", (-1, cfg["num_labels"])),
            "pooled_output": TensorSpec("float32", (-1, cfg["hidden"])),
        },
        partition_rules=partition_rules,
        tensor_parallel=tensor_parallel,
        # the absolute position table bounds the servable sequence: a
        # 300-token request under max_seq 384 pads to 384, not 512
        axis_caps={"seq": cfg["max_seq"]},
    )
