"""moe_lm — mixture-of-experts decoder LM (Switch-style top-1 routing), in
PyTorch.

Counterpart of ``tfservingcache_tpu/models/moe_lm.py``: transformer_lm's
attention half (the port's ``Attention`` and ``rmsnorm``, so attention runs
the flash kernel on CUDA) with a routed expert FFN in place of the dense
one. Same arithmetic and rounding points as the reference's ``_moe_block``:
  - the router runs in f32 (its weight is stored in the model dtype and
    widened at use); ``argmax`` of the softmax picks the expert, the first
    on a tie, and the softmax's max is the gate;
  - expert capacity is ``ceil(capacity_factor * B*S / E)`` over the whole
    (bucket-padded) batch, and tokens queue for their expert in flattened
    row-major ``(b, s)`` order: a token past its expert's capacity drops
    (the residual carries it unchanged), pad tokens included;
  - the expert FFNs ``silu(x @ w1) @ w2`` run batched over experts in the
    activation dtype;
  - the combine rounds ``gate`` to the activation dtype before its product
    with the expert output.
The reference builds dense one-hot ``(t, E, C)`` dispatch and combine
tensors and contracts them; here each token is scattered into its expert
slot and gathered back by index, which gives the same values (a one-hot
contraction adds exact zeros) without the ``(t, E, C)`` tensors. Nothing in
the block reads a value back to the host. The load-balancing aux loss is a
training signal and is not ported (serving discards it).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from tfservingcache_tpu_torch.models.registry import ModelDef, TensorSpec, register
from tfservingcache_tpu_torch.models.transformer_lm import (
    Attention,
    TransformerLM,
    _param,
    rmsnorm,
)

DEFAULT_CONFIG: dict[str, Any] = {
    "vocab_size": 2048,
    "d_model": 256,
    "n_layers": 4,
    "n_heads": 8,
    "n_kv_heads": 8,
    "d_ff": 512,            # per-expert FFN width
    "n_experts": 8,
    "capacity_factor": 1.25,
    "aux_loss_weight": 0.01,
    "max_seq": 1024,
    "rope_theta": 10000.0,
    "dtype": "bfloat16",
}


def moe_block(router: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, x: torch.Tensor,
              cfg: dict) -> torch.Tensor:
    """Top-1 routed expert FFN over ``x (B, S, d)`` -> ``(B, S, d)`` in x's
    dtype (reference ``_moe_block`` :50, without the aux loss). ``w1 (E, d,
    ff)`` and ``w2 (E, ff, d)`` come in x's dtype; ``router (d, E)`` in any
    float dtype, used in f32."""
    b, s, d = x.shape
    e = cfg["n_experts"]
    t = b * s
    capacity = max(1, math.ceil(cfg["capacity_factor"] * t / e))
    xt = x.reshape(t, d)
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)          # (t, e) f32
    gate = probs.amax(dim=-1)                                            # (t,)
    expert = torch.argmax(probs, dim=-1)                                 # (t,)
    # each token's place in its expert's queue (0-based), in token order (a
    # comparison, not F.one_hot, which checks its indices on the host)
    onehot = (expert[:, None] == torch.arange(e, device=x.device)).long()
    slot = onehot.cumsum(dim=0).gather(1, expert[:, None])[:, 0] - 1
    # the token's cell among the e * capacity expert slots; a dropped token
    # goes to one spare row past them, which reads back as zeros
    cell = torch.where(slot < capacity, expert * capacity + slot,
                       torch.full_like(slot, e * capacity))
    expert_in = xt.new_zeros(e * capacity + 1, d)
    expert_in.index_copy_(0, cell, xt)  # kept cells are distinct; drops share the spare row
    h = F.silu(torch.bmm(expert_in[:-1].view(e, capacity, d), w1))     # (e, c, ff)
    out = torch.bmm(h, w2).view(e * capacity, d)                         # (e*c, d)
    out = torch.cat([out, out.new_zeros(1, d)])
    return (gate.to(x.dtype)[:, None] * out[cell]).view(b, s, d)


class MoE(nn.Module):
    def __init__(self, p: dict) -> None:
        super().__init__()
        self.router, self.w1, self.w2 = _param(p["router"]), _param(p["w1"]), _param(p["w2"])

    def forward(self, x: torch.Tensor, cfg: dict) -> torch.Tensor:
        # routing stays f32; the experts run in the activation dtype
        dt = x.dtype
        return moe_block(self.router, self.w1.to(dt), self.w2.to(dt), x, cfg)


class MoEBlock(nn.Module):
    def __init__(self, p: dict, cfg: dict, group: tuple[torch.device, ...] | None = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.attn = Attention(p["attn"], cfg, group)
        self.moe = MoE(p["moe"])
        self.ln1, self.ln2 = _param(p["ln1"]), _param(p["ln2"])

    def forward(self, x: torch.Tensor, attention_fn) -> torch.Tensor:
        x = x + self.attn(rmsnorm(x, self.ln1), attention_fn)
        return x + self.moe(rmsnorm(x, self.ln2), self.cfg)


class MoELM(TransformerLM):
    """``forward({"input_ids": (B, S) ints}) -> {"logits": (B, S, V) f32}``:
    ``TransformerLM``'s embedding, norms and tied output over ``MoEBlock``
    layers."""

    block_cls = MoEBlock


@register("moe_lm", DEFAULT_CONFIG)
def build(config: dict) -> ModelDef:
    cfg = config

    def make_module(params: Any) -> nn.Module:
        return MoELM(params, cfg)

    def init(gen: torch.Generator) -> dict:
        """Random params in the reference's layout: N(0, 1/fan_in) weights in
        f32, unit norm gains."""
        d, v, ff, e = cfg["d_model"], cfg["vocab_size"], cfg["d_ff"], cfg["n_experts"]
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
                "moe": {
                    "router": dense(d, (d, e)),
                    "w1": dense(d, (e, d, ff)),
                    "w2": dense(ff, (e, ff, d)),
                },
                "ln1": ones(d),
                "ln2": ones(d),
            })
        return {"embed": dense(d, (v, d)), "layers": layers, "ln_f": ones(d)}

    def last_token_logits(outputs: dict, dyn_sizes: dict) -> torch.Tensor:
        """On-device slice at the last REAL position (seq is bucket-padded)."""
        logits = outputs["logits"]
        s = dyn_sizes.get("seq", logits.shape[1])
        b = dyn_sizes.get("batch", logits.shape[0])
        return logits[:b, s - 1, :]

    # the reference's expert parallelism ("expert" axis) and Megatron-style
    # attention over "model"; the port shards no weight yet, so a group
    # runtime refuses these rules (runtime/model_runtime.py)
    partition_rules = {
        "embed": (None, "model"),
        r"layers/\d+/attn/w[qkv]": (None, "model"),
        r"layers/\d+/attn/wo": ("model", None),
        r"layers/\d+/moe/router": (None,),
        r"layers/\d+/moe/w[12]": ("expert", None, None),
        r".*ln.*": (None,),
    }

    return ModelDef(
        family="moe_lm",
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
    )
