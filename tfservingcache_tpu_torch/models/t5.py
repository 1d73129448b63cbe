"""t5 — the T5-style encoder-decoder family (BASELINE.json config #5 pairs
T5-XL with the multi-chip shard), in PyTorch (counterpart of
``tfservingcache_tpu/models/t5.py``).

RMSNorm, relative-position bias buckets, a GeGLU feed-forward and a tied
embedding head. Serving signature: ``(input_ids, decoder_input_ids) ->
decoder logits``, the predict shape of translation and summarization
fine-tunes. The two sequence axes (``src``, ``tgt``) bucket apart.

The params tree is the reference's: ``embed``, ``enc_rel``, ``dec_rel``,
``enc_layers/i/{attn/{wq,wk,wv,wo}, mlp/{w0,w1,w2}, ln1, ln2}``,
``dec_layers/i/{self_attn, cross_attn, mlp, ln1, ln2, ln3}``, ``enc_ln``,
``dec_ln``, with ``(in, out)`` weights. The arithmetic rounds where the
reference's does:
  - RMSNorm statistics in f32, the normalized x rounded to the compute
    dtype, then times the gain cast to it;
  - attention is plain ops, as the reference's ``_attn`` is plain jnp (no
    kernel of the port): f32 scores from compute-dtype q and k, no
    1/sqrt(head_dim) scale, the f32 relative bias added, then masked
    positions REPLACED by -1e30 (an all-padding source row, as the load's
    (1, 1) warm-up sends, stays finite), f32 softmax, probabilities cast to
    the compute dtype before the value product;
  - the feed-forward is ``gelu_tanh(x @ w0) * (x @ w1) @ w2``;
  - the head divides y by sqrt(d_model) in the compute dtype and multiplies
    by the embedding transposed (a view), then widens to f32.
The module holds the loaded tree's leaves as they are and casts each
weight, norm gain and the embedding to the compute dtype at use, as the
reference's jitted apply does; the two bias tables keep their stored dtype
and widen to f32 at use. The embedding gather casts the gathered rows (a
cast commutes with the gather), the head the whole table. The family's
artifacts store ``cfg["dtype"]``, so for them every cast is the tensor
itself; an f32 artifact served in bf16 keeps no second copy of a weight
either, its copies living for one call.

On a device group ``TensorParallelT5`` runs the reference's Megatron rules:
the encoder's self-attention and the decoder's self- and cross-attention
cut by heads (``w[qkv]`` by columns, ``wo`` by rows), the GeGLU ``w0``/``w1``
by columns and ``w2`` by rows, ``embed`` over ``d_model``; the bias tables
and the norms replicated. The bias tables are indexed by head, so each
shard adds its own heads' rows. With ``embed`` cut, the gather joins the
shards' columns on the leader, and the tied head is a row-parallel product:
each shard's slice of ``y / sqrt(d)`` against its slice of ``embed``. Every
partial reduces on the leader in f32 in shard order and rounds once
(``reduce_partials``), where one device rounds its product.

Relative bucket indices are computed on the host in f32 in the reference's
order of operations (a device ``logf`` one ulp low would move the distances
where the exact value is an integer one bucket down), cached per
``(q_len, k_len, bidirectional)`` and gathered from the bias table on the
device.
"""

from __future__ import annotations

import math
import threading
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
    "vocab_size": 32128,
    "d_model": 512,
    "n_layers": 6,
    "n_heads": 8,
    "d_ff": 1024,
    "rel_buckets": 32,
    "rel_max_dist": 128,
    "dtype": "bfloat16",
}

TINY_CONFIG: dict[str, Any] = {
    "vocab_size": 256,
    "d_model": 64,
    "n_layers": 2,
    "n_heads": 4,
    "d_ff": 128,
    "rel_buckets": 8,
    "rel_max_dist": 32,
    "dtype": "bfloat16",
}

_MASKED = -1e30  # the reference's replacing mask value (not -inf)
_MAX_BUCKET_TABLES = 64  # per module; the runtime's power-of-two buckets stay well below


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's ``_rmsnorm``: f32 statistics, one rounding to ``x``'s
    dtype, then the gain in that dtype."""
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * gain.to(x.dtype)


def rel_bucket(rel_pos: torch.Tensor, bidirectional: bool, num_buckets: int,
               max_dist: int) -> torch.Tensor:
    """The reference's ``_rel_bucket`` on an integer CPU tensor of relative
    positions (key minus query): exact below ``num_buckets // 2`` (halved
    again for the sign when bidirectional), log-spaced beyond, in f32 and in
    the reference's order: ``max(n, 1) / max_exact``, log, divided by
    ``log(max_dist / max_exact)`` rounded to f32, times ``num_buckets -
    max_exact``, truncated, clamped."""
    rel_pos = rel_pos.to(torch.int64)
    ret = torch.zeros_like(rel_pos)
    n = -rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = ret + torch.where(n < 0, num_buckets, 0)
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    ratio = n.clamp(min=1).to(torch.float32) / torch.tensor(max_exact, dtype=torch.float32)
    scaled = (torch.log(ratio) / torch.tensor(math.log(max_dist / max_exact), dtype=torch.float32)
              * torch.tensor(num_buckets - max_exact, dtype=torch.float32))
    large = (max_exact + scaled.to(torch.int32).to(torch.int64)).clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, large)


def bucket_table(q_len: int, k_len: int, bidirectional: bool, num_buckets: int,
                 max_dist: int) -> torch.Tensor:
    """(q_len, k_len) int64 bucket indices of ``pos_k - pos_q`` on the CPU
    (the reference's ``_rel_bias`` positions)."""
    rel = torch.arange(k_len)[None, :] - torch.arange(q_len)[:, None]
    return rel_bucket(rel, bidirectional, num_buckets, max_dist)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _Weights(nn.Module):
    """One subtree of plain weights (an attention's ``wq, wk, wv, wo``, a
    feed-forward's ``w0, w1, w2``), held as loaded and cast at use."""

    def __init__(self, p: dict) -> None:
        super().__init__()
        for name, t in p.items():
            setattr(self, name, _frozen(t))


def attention(p: _Weights, q_in: torch.Tensor, kv_in: torch.Tensor, bias: torch.Tensor | None,
              mask: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The reference's ``_attn``: ``mask`` broadcasts over (b, h, sq, sk),
    True where a key is seen."""
    b, sq, d = q_in.shape
    sk = kv_in.shape[1]
    hd = d // n_heads
    dt = q_in.dtype
    q = (q_in @ p.wq.to(dt)).reshape(b, sq, n_heads, hd).transpose(1, 2)
    k = (kv_in @ p.wk.to(dt)).reshape(b, sk, n_heads, hd).transpose(1, 2)
    v = (kv_in @ p.wv.to(dt)).reshape(b, sk, n_heads, hd).transpose(1, 2)
    # f32 scores from the compute-dtype q and k (products exact in f32)
    scores = q.float() @ k.float().transpose(-1, -2)
    if bias is not None:
        scores = scores + bias
    scores = torch.where(mask, scores, _MASKED)
    probs = torch.softmax(scores, dim=-1).to(dt)
    ctx = (probs @ v).transpose(1, 2).reshape(b, sq, d)
    return ctx @ p.wo.to(dt)


def geglu(p: _Weights, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    return (F.gelu(x @ p.w0.to(dt), approximate="tanh") * (x @ p.w1.to(dt))) @ p.w2.to(dt)


class EncoderLayer(nn.Module):
    def __init__(self, p: dict) -> None:
        super().__init__()
        self.attn = _Weights(p["attn"])
        self.mlp = _Weights(p["mlp"])
        self.ln1 = _frozen(p["ln1"])
        self.ln2 = _frozen(p["ln2"])

    def forward(self, x: torch.Tensor, bias: torch.Tensor, src_valid: torch.Tensor,
                n_heads: int) -> torch.Tensor:
        h = rmsnorm(x, self.ln1)
        x = x + attention(self.attn, h, h, bias, src_valid, n_heads)
        return x + geglu(self.mlp, rmsnorm(x, self.ln2))


class DecoderLayer(nn.Module):
    def __init__(self, p: dict) -> None:
        super().__init__()
        self.self_attn = _Weights(p["self_attn"])
        self.cross_attn = _Weights(p["cross_attn"])
        self.mlp = _Weights(p["mlp"])
        for name in ("ln1", "ln2", "ln3"):
            setattr(self, name, _frozen(p[name]))

    def forward(self, y: torch.Tensor, enc_out: torch.Tensor, bias: torch.Tensor,
                causal: torch.Tensor, src_valid: torch.Tensor, n_heads: int) -> torch.Tensor:
        h = rmsnorm(y, self.ln1)
        y = y + attention(self.self_attn, h, h, bias, causal, n_heads)
        y = y + attention(self.cross_attn, rmsnorm(y, self.ln2), enc_out, None, src_valid,
                          n_heads)
        return y + geglu(self.mlp, rmsnorm(y, self.ln3))


class T5EncoderDecoder(nn.Module):
    """``forward({"input_ids": (B, src) ints, "decoder_input_ids": (B, tgt)
    ints}) -> {"logits": (B, tgt, vocab) f32}``. Token 0 is the source's
    pad token (masked out of encoder self-attention and cross-attention);
    the decoder has a causal mask and no pad mask."""

    def __init__(self, params: dict, cfg: dict) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg["dtype"])
        self.n_heads = cfg["n_heads"]
        self.embed = _frozen(params["embed"])
        self.enc_rel = _frozen(params["enc_rel"])
        self.dec_rel = _frozen(params["dec_rel"])
        self.enc_layers = nn.ModuleList(EncoderLayer(p) for p in params["enc_layers"])
        self.dec_layers = nn.ModuleList(DecoderLayer(p) for p in params["dec_layers"])
        self.enc_ln = _frozen(params["enc_ln"])
        self.dec_ln = _frozen(params["dec_ln"])
        self._buckets: dict[tuple[int, int, bool], torch.Tensor] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def _bias(self, table: torch.Tensor, q_len: int, k_len: int,
              bidirectional: bool) -> torch.Tensor:
        """(1, h, q_len, k_len) f32 relative bias (the reference's
        ``_rel_bias``): host-computed bucket indices, cached on the table's
        device, gathered there."""
        key = (q_len, k_len, bidirectional)
        with self._lock:
            idx = self._buckets.get(key)
        if idx is None:
            idx = bucket_table(q_len, k_len, bidirectional, self.cfg["rel_buckets"],
                               self.cfg["rel_max_dist"]).to(table.device)
            with self._lock:
                if len(self._buckets) >= _MAX_BUCKET_TABLES:
                    self._buckets.clear()
                self._buckets[key] = idx
        return table[idx].permute(2, 0, 1)[None].float()

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        # the reference's gather semantics: negative ids wrap, out-of-range
        # ids clamp (an unchecked CUDA index would fault the whole context)
        vocab = self.embed.shape[0]
        rows = self.embed[torch.where(ids < 0, ids + vocab, ids).clamp(0, vocab - 1)]
        return rows.to(self.dtype)

    def forward(self, inputs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        src = inputs["input_ids"].long()
        tgt = inputs["decoder_input_ids"].long()
        # the pad mask reads the ids as sent (a wrapped -vocab is no pad)
        src_valid = (src != 0)[:, None, None, :]
        x = self._embed(src)
        s = x.shape[1]
        enc_bias = self._bias(self.enc_rel, s, s, True)
        for layer in self.enc_layers:
            x = layer(x, enc_bias, src_valid, self.n_heads)
        enc_out = rmsnorm(x, self.enc_ln)

        y = self._embed(tgt)
        t = y.shape[1]
        dec_bias = self._bias(self.dec_rel, t, t, False)
        causal = torch.ones((t, t), dtype=torch.bool, device=y.device).tril()[None, None]
        for layer in self.dec_layers:
            y = layer(y, enc_out, dec_bias, causal, src_valid, self.n_heads)
        y = rmsnorm(y, self.dec_ln)
        # tied head with T5's 1/sqrt(d) scaling, in the compute dtype
        logits = (y / math.sqrt(self.cfg["d_model"])) @ self.embed.to(self.dtype).t()
        return {"logits": logits.float()}


def _cut(leaf: ShardedLeaf, n: int) -> nn.ParameterList:
    """The first ``n`` shards of a placed leaf (a replicated half's one
    whole weight on the leader when ``n`` is 1)."""
    return nn.ParameterList(_frozen(t) for t in leaf.shards[:n])


class TPAttention(nn.Module):
    """One attention block on a group: shard i projects its ``n_heads / P``
    heads' q, k and v, attends with its heads' rows of the relative bias
    and multiplies by its rows of ``wo``; the partials reduce on the
    leader. Replicated (P does not divide the heads), the whole block on
    the leader."""

    def __init__(self, p: dict[str, ShardedLeaf], n_heads: int,
                 group: tuple[torch.device, ...]) -> None:
        super().__init__()
        self.devices = group if p["wq"].dim is not None else group[:1]
        n = len(self.devices)
        self.n_heads = n_heads // n
        self.wq, self.wk, self.wv, self.wo = (_cut(p[w], n) for w in ("wq", "wk", "wv", "wo"))

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor, bias: torch.Tensor | None,
                mask: torch.Tensor) -> torch.Tensor:
        b, sq, d = q_in.shape
        sk = kv_in.shape[1]
        h = self.n_heads
        hd = d // (h * len(self.devices))
        dt = q_in.dtype
        parts = []
        for i, dev in enumerate(self.devices):
            qi, kvi = q_in.to(dev, non_blocking=True), kv_in.to(dev, non_blocking=True)
            q = (qi @ self.wq[i].to(dt)).reshape(b, sq, h, hd).transpose(1, 2)
            k = (kvi @ self.wk[i].to(dt)).reshape(b, sk, h, hd).transpose(1, 2)
            v = (kvi @ self.wv[i].to(dt)).reshape(b, sk, h, hd).transpose(1, 2)
            scores = q.float() @ k.float().transpose(-1, -2)
            if bias is not None:
                scores = scores + bias[:, i * h:(i + 1) * h].to(dev, non_blocking=True)
            scores = torch.where(mask.to(dev, non_blocking=True), scores, _MASKED)
            probs = torch.softmax(scores, dim=-1).to(dt)
            ctx = (probs @ v).transpose(1, 2).reshape(b, sq, -1)
            parts.append(ctx @ self.wo[i].to(dt))
        return reduce_partials(parts, q_in.device)


class TPGeGLU(nn.Module):
    """The feed-forward on a group: ``w0``/``w1`` cut by columns, ``w2`` by
    rows, each shard's ``gelu(x w0_i) * (x w1_i) @ w2_i`` reduced on the
    leader; replicated (P does not divide ``d_ff``), whole on the leader."""

    def __init__(self, p: dict[str, ShardedLeaf], group: tuple[torch.device, ...]) -> None:
        super().__init__()
        self.devices = group if p["w0"].dim is not None else group[:1]
        n = len(self.devices)
        self.w0, self.w1, self.w2 = (_cut(p[w], n) for w in ("w0", "w1", "w2"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        parts = []
        for i, dev in enumerate(self.devices):
            xi = x.to(dev, non_blocking=True)
            ff = F.gelu(xi @ self.w0[i].to(dt), approximate="tanh") * (xi @ self.w1[i].to(dt))
            parts.append(ff @ self.w2[i].to(dt))
        return reduce_partials(parts, x.device)


class TPEncoderLayer(nn.Module):
    def __init__(self, p: dict, n_heads: int, group: tuple[torch.device, ...]) -> None:
        super().__init__()
        self.attn = TPAttention(p["attn"], n_heads, group)
        self.mlp = TPGeGLU(p["mlp"], group)
        self.ln1 = _frozen(p["ln1"].shards[0])
        self.ln2 = _frozen(p["ln2"].shards[0])

    def forward(self, x: torch.Tensor, bias: torch.Tensor, src_valid: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(x, self.ln1)
        x = x + self.attn(h, h, bias, src_valid)
        return x + self.mlp(rmsnorm(x, self.ln2))


class TPDecoderLayer(nn.Module):
    def __init__(self, p: dict, n_heads: int, group: tuple[torch.device, ...]) -> None:
        super().__init__()
        self.self_attn = TPAttention(p["self_attn"], n_heads, group)
        self.cross_attn = TPAttention(p["cross_attn"], n_heads, group)
        self.mlp = TPGeGLU(p["mlp"], group)
        for name in ("ln1", "ln2", "ln3"):
            setattr(self, name, _frozen(p[name].shards[0]))

    def forward(self, y: torch.Tensor, enc_out: torch.Tensor, bias: torch.Tensor,
                causal: torch.Tensor, src_valid: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(y, self.ln1)
        y = y + self.self_attn(h, h, bias, causal)
        y = y + self.cross_attn(rmsnorm(y, self.ln2), enc_out, None, src_valid)
        return y + self.mlp(rmsnorm(y, self.ln3))


class TensorParallelT5(T5EncoderDecoder):
    """``T5EncoderDecoder`` over a tree that ``parallel.sharding`` placed on
    a device group. The inputs, the residual streams, the norms, the bias
    tables and the logits live on ``group[0]``, the leader; the relative
    bias is gathered there for all heads and each shard takes its heads'
    rows. On a group that repeats one device the shards run one after
    another there."""

    def __init__(self, sharded: dict, cfg: dict, group: tuple[torch.device, ...]) -> None:
        nn.Module.__init__(self)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg["dtype"])
        self.n_heads = cfg["n_heads"]
        self.group = tuple(group)
        embed = sharded["embed"]
        self.embed_devices = self.group if embed.dim is not None else self.group[:1]
        self.embed_shards = _cut(embed, len(self.embed_devices))
        self.vocab = embed.shape[0]
        for name in ("enc_rel", "dec_rel", "enc_ln", "dec_ln"):
            setattr(self, name, _frozen(sharded[name].shards[0]))
        self.enc_layers = nn.ModuleList(TPEncoderLayer(p, self.n_heads, self.group)
                                        for p in sharded["enc_layers"])
        self.dec_layers = nn.ModuleList(TPDecoderLayer(p, self.n_heads, self.group)
                                        for p in sharded["dec_layers"])
        self._buckets = {}
        self._lock = threading.Lock()

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        """Each shard gathers its ``d_model`` columns, joined on the leader
        in shard order, then cast (a cast commutes with the gather)."""
        lead = self.group[0]
        ids = torch.where(ids < 0, ids + self.vocab, ids).clamp(0, self.vocab - 1)
        rows = torch.cat([e[ids.to(dev, non_blocking=True)].to(lead, non_blocking=True)
                          for e, dev in zip(self.embed_shards, self.embed_devices)], dim=-1)
        return rows.to(self.dtype)

    def forward(self, inputs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        lead = self.group[0]
        src = inputs["input_ids"].long().to(lead)
        tgt = inputs["decoder_input_ids"].long().to(lead)
        src_valid = (src != 0)[:, None, None, :]
        x = self._embed(src)
        s = x.shape[1]
        enc_bias = self._bias(self.enc_rel, s, s, True)
        for layer in self.enc_layers:
            x = layer(x, enc_bias, src_valid)
        enc_out = rmsnorm(x, self.enc_ln)

        y = self._embed(tgt)
        t = y.shape[1]
        dec_bias = self._bias(self.dec_rel, t, t, False)
        causal = torch.ones((t, t), dtype=torch.bool, device=lead).tril()[None, None]
        for layer in self.dec_layers:
            y = layer(y, enc_out, dec_bias, causal, src_valid)
        y = rmsnorm(y, self.dec_ln) / math.sqrt(self.cfg["d_model"])
        # the tied head, row parallel over the cut embedding
        width = y.shape[-1] // len(self.embed_devices)
        parts = [y[..., i * width:(i + 1) * width].to(dev, non_blocking=True)
                 @ e.to(self.dtype).t()
                 for i, (e, dev) in enumerate(zip(self.embed_shards, self.embed_devices))]
        return {"logits": reduce_partials(parts, lead).float()}


@register("t5", DEFAULT_CONFIG)
def build(config: dict) -> ModelDef:
    cfg = config

    def make_module(params: Any) -> nn.Module:
        return T5EncoderDecoder(params, cfg)

    def init(gen: torch.Generator) -> dict:
        """Random params in the reference's layout: N(0, 1/fan_in) weights
        and embedding, N(0, 1) bias tables, unit RMSNorm gains, all f32."""
        d, ff, v, h = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"], cfg["n_heads"]
        dev = gen.device

        def dense(fan_in: int, shape: tuple[int, ...]) -> torch.Tensor:
            return torch.randn(shape, generator=gen, device=dev) / math.sqrt(fan_in)

        def ones() -> torch.Tensor:
            return torch.ones(d, device=dev)

        def attn_p() -> dict:
            return {name: dense(d, (d, d)) for name in ("wq", "wk", "wv", "wo")}

        def mlp_p() -> dict:
            return {"w0": dense(d, (d, ff)), "w1": dense(d, (d, ff)), "w2": dense(ff, (ff, d))}

        enc_layers = [{"attn": attn_p(), "mlp": mlp_p(), "ln1": ones(), "ln2": ones()}
                      for _ in range(cfg["n_layers"])]
        dec_layers = [{"self_attn": attn_p(), "cross_attn": attn_p(), "mlp": mlp_p(),
                       "ln1": ones(), "ln2": ones(), "ln3": ones()}
                      for _ in range(cfg["n_layers"])]
        return {
            "embed": dense(d, (v, d)),
            "enc_rel": dense(1, (cfg["rel_buckets"], h)),
            "dec_rel": dense(1, (cfg["rel_buckets"], h)),
            "enc_layers": enc_layers,
            "dec_layers": dec_layers,
            "enc_ln": ones(),
            "dec_ln": ones(),
        }

    def tensor_parallel(group: tuple[torch.device, ...]) -> TensorParallelPlan:
        # every attention block is cut where P divides the heads, the GeGLU
        # where it divides d_ff, the embedding (and so the tied head) where
        # it divides d_model
        return cut_halves(partition_rules, group, {
            "attn": (r"(enc|dec)_layers/\d+/(self_|cross_)?attn/w[qkvo]", cfg["n_heads"]),
            "mlp": (r"(enc|dec)_layers/\d+/mlp/w[012]", cfg["d_ff"]),
            "embed": (r"embed", cfg["d_model"]),
        }, lambda sharded: TensorParallelT5(sharded, cfg, tuple(group)))

    # the reference's Megatron-style rules over the "model" axis, served on
    # a group by TensorParallelT5
    partition_rules = {
        r"embed": (None, "model"),
        r"(enc|dec)_layers/\d+/(self_|cross_)?attn/w[qkv]": (None, "model"),
        r"(enc|dec)_layers/\d+/(self_|cross_)?attn/wo": ("model", None),
        r"(enc|dec)_layers/\d+/mlp/w[01]": (None, "model"),
        r"(enc|dec)_layers/\d+/mlp/w2": ("model", None),
    }

    return ModelDef(
        family="t5",
        config=cfg,
        make_module=make_module,
        init=init,
        input_spec={
            "input_ids": TensorSpec("int32", ("batch", "src")),
            "decoder_input_ids": TensorSpec("int32", ("batch", "tgt")),
        },
        output_spec={"logits": TensorSpec("float32", ("batch", "tgt", cfg["vocab_size"]))},
        partition_rules=partition_rules,
        tensor_parallel=tensor_parallel,
        # apply casts to cfg dtype; bf16 artifacts halve the cold transfer
        store_param_dtype=cfg["dtype"],
    )
