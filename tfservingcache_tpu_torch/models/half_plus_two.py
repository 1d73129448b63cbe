"""half_plus_two — the canonical TF Serving smoke-test model (BASELINE.json
config #1), in PyTorch (counterpart of
``tfservingcache_tpu/models/half_plus_two.py``): ``y = w * x + b`` with
``w = 0.5`` and ``b = 2`` as f32 scalars, the reference's params tree."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from tfservingcache_tpu_torch.models.registry import ModelDef, TensorSpec, register


class HalfPlusTwo(nn.Module):
    def __init__(self, params: dict) -> None:
        super().__init__()
        self.w = nn.Parameter(params["w"], requires_grad=False)
        self.b = nn.Parameter(params["b"], requires_grad=False)

    def forward(self, inputs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return {"y": self.w * inputs["x"] + self.b}


@register("half_plus_two")
def build(config: dict) -> ModelDef:
    def init(gen: torch.Generator) -> dict[str, Any]:
        dev = gen.device
        return {"w": torch.tensor(0.5, device=dev), "b": torch.tensor(2.0, device=dev)}

    return ModelDef(
        family="half_plus_two",
        config=config,
        make_module=HalfPlusTwo,
        init=init,
        input_spec={"x": TensorSpec("float32", (-1,))},
        output_spec={"y": TensorSpec("float32", (-1,))},
    )


def reference_output(x: np.ndarray) -> np.ndarray:
    return 0.5 * np.asarray(x, np.float32) + 2.0
