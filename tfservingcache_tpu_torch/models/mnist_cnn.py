"""mnist_cnn — the MNIST convnet family (BASELINE.json config #2: 10 tenant
copies exercising LRU eviction), in PyTorch (counterpart of
``tfservingcache_tpu/models/mnist_cnn.py``).

The params tree is flax's: ``Conv_{0,1}/{kernel,bias}`` with HWIO kernels and
``Dense_{0,1}/{kernel,bias}`` with ``(in, out)`` kernels. The arithmetic
follows flax's at its rounding points: the image and every conv and the
first dense layer in bf16 (each bias added after its product, as flax adds
it), the last dense layer and the logits in f32. Flax convolves NHWC; the
module convolves NCHW and puts the features back in NHWC order before the
flatten, so the first dense kernel's rows mean what they meant in flax.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from tfservingcache_tpu_torch.models.registry import ModelDef, TensorSpec, register


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class MnistCNN(nn.Module):
    """``forward({"image": (B, 28, 28, 1) f32}) -> {"logits": (B, C) f32,
    "classes": (B,) int32}``."""

    def __init__(self, params: dict) -> None:
        super().__init__()
        # HWIO -> OIHW: a view of the leaf; every weight is cast to the
        # compute dtype at use, as flax casts it
        self.conv0 = _frozen(params["Conv_0"]["kernel"].permute(3, 2, 0, 1))
        self.conv0_b = _frozen(params["Conv_0"]["bias"])
        self.conv1 = _frozen(params["Conv_1"]["kernel"].permute(3, 2, 0, 1))
        self.conv1_b = _frozen(params["Conv_1"]["bias"])
        self.dense0 = _frozen(params["Dense_0"]["kernel"])
        self.dense0_b = _frozen(params["Dense_0"]["bias"])
        self.dense1 = _frozen(params["Dense_1"]["kernel"])
        self.dense1_b = _frozen(params["Dense_1"]["bias"])

    def forward(self, inputs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        bf16 = torch.bfloat16
        x = inputs["image"].to(bf16).permute(0, 3, 1, 2)                    # NCHW
        for w, b in ((self.conv0, self.conv0_b), (self.conv1, self.conv1_b)):
            x = F.conv2d(x, w.to(bf16).contiguous(), padding=1)              # SAME, 3x3
            x = F.avg_pool2d(torch.relu(x + b.to(bf16)[None, :, None, None]), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)                    # NHWC flatten
        x = torch.relu(x @ self.dense0.to(bf16) + self.dense0_b.to(bf16))
        logits = x.float() @ self.dense1.float() + self.dense1_b.float()
        return {"logits": logits, "classes": logits.argmax(dim=-1).to(torch.int32)}


@register("mnist_cnn", {"num_classes": 10, "width": 32})
def build(config: dict) -> ModelDef:
    classes, width = config["num_classes"], config["width"]

    def init(gen: torch.Generator) -> dict[str, Any]:
        """Random params in flax's layout: N(0, 1/fan_in) kernels in f32
        (flax's lecun_normal draws a truncated normal of that variance),
        zero biases."""
        dev = gen.device

        def layer(shape: tuple[int, ...], fan_in: int) -> dict[str, torch.Tensor]:
            kernel = torch.randn(shape, generator=gen, device=dev) / math.sqrt(fan_in)
            return {"kernel": kernel, "bias": torch.zeros(shape[-1], device=dev)}

        return {
            "Conv_0": layer((3, 3, 1, width), 9),
            "Conv_1": layer((3, 3, width, 2 * width), 9 * width),
            "Dense_0": layer((7 * 7 * 2 * width, 128), 7 * 7 * 2 * width),
            "Dense_1": layer((128, classes), 128),
        }

    return ModelDef(
        family="mnist_cnn",
        config=config,
        make_module=MnistCNN,
        init=init,
        input_spec={"image": TensorSpec("float32", (-1, 28, 28, 1))},
        output_spec={
            "logits": TensorSpec("float32", (-1, classes)),
            "classes": TensorSpec("int32", (-1,)),
        },
    )
