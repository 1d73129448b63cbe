"""resnet — the ResNet family (BASELINE.json config #4: 1000 per-tenant
variants), in PyTorch (counterpart of ``tfservingcache_tpu/models/resnet.py``,
a flax module; no flax here).

The params tree is flax's: the stem ``Conv_0/kernel`` (HWIO) and
``GroupNorm_0/{scale,bias}``; blocks ``_BottleneckBlock_{i}`` (depth >= 50)
or ``_BasicBlock_{i}``, numbered through all stages, each with
``Conv_{j}/kernel`` and ``GroupNorm_{j}/{scale,bias}``, the last pair (j = 3
in a bottleneck block, 2 in a basic one) the projection shortcut, present
only where the block changes its input's shape; ``Dense_0/{kernel,bias}``.

The arithmetic rounds where flax's does: the image is cast to bf16; convs
are bf16 with no bias, padded as XLA pads ``"SAME"`` (asymmetric at stride
2: the low side gets ``total // 2``), the max pool padded with -inf; group
norm takes f32 statistics and applies scale and bias in f32 before one
rounding (flax's ``GroupNorm``, eps 1e-6); the global mean accumulates in
f32 and rounds to bf16, as ``jnp.mean`` does; the classifier runs in f32.
Flax convolves NHWC: the module permutes the NHWC input to an NCHW view,
which lies channels-last in memory, and lays each conv weight out
channels-last to match when it casts it. The module holds the loaded
tree's leaves (a conv kernel as an OIHW view of its HWIO leaf) and casts
each weight to the compute dtype inside the forward, as flax casts at use:
an f32 artifact served in bf16 keeps no second copy on the device.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from tfservingcache_tpu_torch.models.registry import ModelDef, TensorSpec, register

DEFAULT_CONFIG: dict[str, Any] = {"depth": 50, "num_classes": 1000, "width": 64,
                                  "image_size": 224}
TINY_CONFIG: dict[str, Any] = {"depth": 18, "num_classes": 10, "width": 8, "image_size": 32}

_STAGES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}

GN_EPS = 1e-6  # flax GroupNorm's default epsilon


def same_pad(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """Pad NCHW ``x``'s H and W as XLA's ``"SAME"`` does for a k x k window
    at ``stride``: total ``max((ceil(n / s) - 1) * s + k - n, 0)``, the low
    side ``total // 2``."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad's order: last axis first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


def group_norm(x: torch.Tensor, groups: int, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """flax's GroupNorm over NCHW ``x``: statistics, scale and bias in f32,
    one rounding to ``x``'s dtype."""
    return F.group_norm(x.float(), groups, scale, bias, GN_EPS).to(x.dtype)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class ConvNorm(nn.Module):
    """flax's ``Conv`` (no bias, SAME) then ``GroupNorm``, from one
    ``Conv_{j}`` and one ``GroupNorm_{j}`` subtree."""

    def __init__(self, conv: dict, norm: dict, groups: int, stride: int,
                 dtype: torch.dtype) -> None:
        super().__init__()
        # HWIO -> OIHW: a view of the leaf
        self.kernel = _frozen(conv["kernel"].permute(3, 2, 0, 1))
        self.dtype = dtype
        self.scale, self.bias = _frozen(norm["scale"]), _frozen(norm["bias"])
        self.k, self.stride, self.groups = self.kernel.shape[-1], stride, groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # cast to the compute dtype at use, as flax does, channels-last in
        # memory; the copy lives for this call only
        kernel = self.kernel.to(self.dtype).contiguous(memory_format=torch.channels_last)
        y = F.conv2d(same_pad(x, self.k, self.stride), kernel, stride=self.stride)
        return group_norm(y, self.groups, self.scale.float(), self.bias.float())


class Block(nn.Module):
    """``_BottleneckBlock`` (1x1, 3x3 at ``stride``, 1x1 to 4x the filters;
    GroupNorm(32)) or ``_BasicBlock`` (3x3 at ``stride``, 3x3; GroupNorm(8)),
    with the projection shortcut where the tree holds one."""

    def __init__(self, p: dict, bottleneck: bool, stride: int, dtype: torch.dtype) -> None:
        super().__init__()
        groups, n_main = (32, 3) if bottleneck else (8, 2)
        strides = (1, stride, 1) if bottleneck else (stride, 1)
        self.main = nn.ModuleList(
            ConvNorm(p[f"Conv_{j}"], p[f"GroupNorm_{j}"], groups, strides[j], dtype)
            for j in range(n_main))
        proj = f"Conv_{n_main}"
        self.proj = (ConvNorm(p[proj], p[f"GroupNorm_{n_main}"], groups, stride, dtype)
                     if proj in p else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i, layer in enumerate(self.main):
            y = layer(y)
            if i < len(self.main) - 1:
                y = torch.relu(y)
        residual = x if self.proj is None else self.proj(x)
        return torch.relu(y + residual)


class Stem(nn.Module):
    """The 7x7/2 conv, GroupNorm(min(32, width)), relu and the 3x3/2 max
    pool (SAME, padded with -inf)."""

    def __init__(self, params: dict, width: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.conv = ConvNorm(params["Conv_0"], params["GroupNorm_0"], min(32, width), 2, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv(x))
        return F.max_pool2d(same_pad(x, 3, 2, float("-inf")), 3, stride=2)


class ResNet(nn.Module):
    """``forward({"image": (B, H, W, 3) f32 NHWC}) -> {"logits": (B, C) f32,
    "classes": (B,) int32}``. ``dtype`` is the compute dtype (flax's
    ``dtype``, bf16 when served)."""

    def __init__(self, params: dict, cfg: dict, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.dtype = dtype
        depth = cfg["depth"]
        bottleneck = depth >= 50
        name = "_BottleneckBlock" if bottleneck else "_BasicBlock"
        self.stem = Stem(params, cfg["width"], dtype)
        blocks, i = [], 0
        for stage, n_blocks in enumerate(_STAGES[depth]):
            for j in range(n_blocks):
                # indexed by number: sorted, _10 would come before _2
                stride = 2 if stage > 0 and j == 0 else 1
                blocks.append(Block(params[f"{name}_{i}"], bottleneck, stride, dtype))
                i += 1
        self.blocks = nn.ModuleList(blocks)
        self.dense = _frozen(params["Dense_0"]["kernel"])
        self.dense_b = _frozen(params["Dense_0"]["bias"])

    def forward(self, inputs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        x = inputs["image"].to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels-last
        x = self.stem(x)
        for block in self.blocks:
            x = block(x)
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        logits = x.float() @ self.dense.float() + self.dense_b.float()
        return {"logits": logits, "classes": logits.argmax(dim=-1).to(torch.int32)}


@register("resnet", DEFAULT_CONFIG)
def build(config: dict) -> ModelDef:
    cfg = config
    if cfg["depth"] not in _STAGES:
        raise ValueError(f"unsupported resnet depth {cfg['depth']}; known: {sorted(_STAGES)}")
    size = cfg["image_size"]

    def make_module(params: Any) -> nn.Module:
        return ResNet(params, cfg)

    def init(gen: torch.Generator) -> dict:
        """Random params in flax's tree: N(0, 1/fan_in) kernels in f32 (flax's
        lecun_normal draws a truncated normal of that variance), GroupNorm
        scale 1 and bias 0, a zero Dense bias."""
        dev = gen.device

        def conv(k: int, cin: int, cout: int) -> dict:
            return {"kernel": torch.randn((k, k, cin, cout), generator=gen, device=dev)
                    / math.sqrt(k * k * cin)}

        def norm(c: int) -> dict:
            return {"scale": torch.ones(c, device=dev), "bias": torch.zeros(c, device=dev)}

        width, depth = cfg["width"], cfg["depth"]
        bottleneck = depth >= 50
        tree: dict[str, Any] = {"Conv_0": conv(7, 3, width), "GroupNorm_0": norm(width)}
        cin, i = width, 0
        for stage, n_blocks in enumerate(_STAGES[depth]):
            filters = width * 2**stage
            for j in range(n_blocks):
                stride = 2 if stage > 0 and j == 0 else 1
                if bottleneck:
                    shapes = [(1, cin, filters), (3, filters, filters), (1, filters, 4 * filters)]
                    name, cout = "_BottleneckBlock", 4 * filters
                else:
                    shapes = [(3, cin, filters), (3, filters, filters)]
                    name, cout = "_BasicBlock", filters
                if stride != 1 or cin != cout:
                    shapes.append((1, cin, cout))  # the projection shortcut
                block = {}
                for n, (k, a, b) in enumerate(shapes):
                    block[f"Conv_{n}"] = conv(k, a, b)
                    block[f"GroupNorm_{n}"] = norm(b)
                tree[f"{name}_{i}"] = block
                cin, i = cout, i + 1
        tree["Dense_0"] = {
            "kernel": torch.randn((cin, cfg["num_classes"]), generator=gen, device=dev)
            / math.sqrt(cin),
            "bias": torch.zeros(cfg["num_classes"], device=dev),
        }
        return tree

    return ModelDef(
        family="resnet",
        config=cfg,
        make_module=make_module,
        init=init,
        input_spec={"image": TensorSpec("float32", (-1, size, size, 3))},
        output_spec={
            "logits": TensorSpec("float32", (-1, cfg["num_classes"])),
            "classes": TensorSpec("int32", (-1,)),
        },
    )
