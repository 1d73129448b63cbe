"""The port's transformer_lm (tfservingcache_tpu_torch/models/transformer_lm.py)
against the JAX package's ``build(...).apply`` on the same params and ids.

Small config: 2 layers, d_model 128, 4 heads / 2 KV heads, vocab 512.
Tolerances: f32 logits 1e-4 (same math, other summation order; measured
~6e-6). bf16 logits 2**-4 (a few bf16 ulps at |x| ~ 2; measured ~0.047):
both frameworks round at the same points but fuse elementwise ops
differently. bf16 logits are bf16-valued, so exact ties exist: argmax must
agree on every position whose top-2 margin exceeds twice that position's
max |diff|, and such decided positions must be the large majority.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.models import transformer_lm as jlm
from tfservingcache_tpu_torch.models import registry as treg
from tfservingcache_tpu_torch.models import transformer_lm as tlm

SMALL = {"vocab_size": 512, "d_model": 128, "n_layers": 2, "n_heads": 4,
         "n_kv_heads": 2, "d_ff": 256}


def _cfg(dtype: str) -> dict:
    return dict(SMALL, dtype=dtype)


def _jax_params(cfg: dict, seed: int):
    return jax.device_get(jreg.build("transformer_lm", cfg).init(jax.random.PRNGKey(seed)))


def _logits_both(cfg: dict, seed: int, shape=(2, 160)):
    params = _jax_params(cfg, seed)
    ids = np.random.default_rng(seed).integers(0, cfg["vocab_size"], size=shape).astype(np.int32)
    want = np.asarray(jreg.build("transformer_lm", cfg).apply(
        params, {"input_ids": jnp.asarray(ids)})["logits"])
    module = treg.build("transformer_lm", cfg).make_module(tlm.params_from_jax(params))
    with torch.inference_mode():
        got = module({"input_ids": torch.from_numpy(ids)})["logits"].numpy()
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax_f32(seed):
    got, want = _logits_both(_cfg("float32"), seed)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 160, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("seed", [0, 2])
def test_forward_matches_jax_bf16(seed):
    got, want = _logits_both(_cfg("bfloat16"), seed)
    diff = np.abs(got - want)
    assert diff.max() <= 2.0**-4
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * diff.max(axis=-1)
    assert decided.mean() > 0.75
    assert (got.argmax(-1) == want.argmax(-1))[decided].all()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 2.0**-7)])
def test_rmsnorm_matches_jax(dtype, tol):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    g = rng.standard_normal(64, dtype=np.float32)
    want = np.asarray(jlm._rmsnorm(jnp.asarray(x, dtype), jnp.asarray(g)).astype(jnp.float32))
    got = tlm.rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(g))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2.0**-6)])
def test_rope_matches_jax_interleaved_pairs(dtype, tol):
    x = np.random.default_rng(4).standard_normal((1, 2, 40, 16), dtype=np.float32)
    pos = np.arange(40)
    want = np.asarray(jlm._rope(jnp.asarray(x, dtype), jnp.asarray(pos), 10000.0).astype(jnp.float32))
    got = tlm.rope(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_last_token_logits_matches_jax_derived_output():
    cfg = _cfg("float32")
    logits = np.random.default_rng(5).standard_normal((4, 8, 512), dtype=np.float32)
    dyn = {"batch": 3, "seq": 5}
    jfn, jspec = jreg.build("transformer_lm", cfg).derived_outputs["last_token_logits"]
    tfn, tspec = treg.build("transformer_lm", cfg).derived_outputs["last_token_logits"]
    want = np.asarray(jfn({"logits": jnp.asarray(logits)}, dyn))
    got = tfn({"logits": torch.from_numpy(logits)}, dyn).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 512)
    assert tspec.shape == jspec.shape and tspec.dtype == jspec.dtype


def test_model_def_mirrors_the_reference():
    cfg = _cfg("bfloat16")
    j, t = jreg.build("transformer_lm", cfg), treg.build("transformer_lm", cfg)
    assert t.config == j.config
    assert t.input_spec == {k: treg.TensorSpec(v.dtype, v.shape) for k, v in j.input_spec.items()}
    assert {k: (v.dtype, v.shape) for k, v in t.output_spec.items()} == {
        k: (v.dtype, v.shape) for k, v in j.output_spec.items()}
    assert t.default_outputs == j.default_outputs == ["last_token_logits"]
    assert t.store_param_dtype == j.store_param_dtype == "bfloat16"


def test_params_from_jax_keeps_bf16_bits():
    params = jax.device_get(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16), _jax_params(_cfg("bfloat16"), 0)))
    conv = tlm.params_from_jax(params)
    wq = np.asarray(params["layers"][1]["attn"]["wq"])
    assert conv["layers"][1]["attn"]["wq"].dtype == torch.bfloat16
    assert conv["layers"][1]["attn"]["wq"].view(torch.int16).numpy().tobytes() == wq.tobytes()


def test_out_of_range_ids_follow_the_reference_gather():
    cfg = _cfg("float32")
    params = _jax_params(cfg, 0)
    ids = np.array([[0, 511, 600, -1, -600, 7]], np.int32)
    # device arrays, as the reference runtime holds them (jnp gather semantics)
    want = np.asarray(jreg.build("transformer_lm", cfg).apply(
        jax.tree_util.tree_map(jnp.asarray, params), {"input_ids": jnp.asarray(ids)})["logits"])
    module = treg.build("transformer_lm", cfg).make_module(tlm.params_from_jax(params))
    with torch.inference_mode():
        got = module({"input_ids": torch.from_numpy(ids)})["logits"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_ring_attention_config_is_refused():
    """"ring" is ported, but as in the reference only with n_heads ==
    n_kv_heads (SMALL groups 4 heads over 2); a mode the port does not know
    is refused too."""
    with pytest.raises(ValueError, match="requires n_heads == n_kv_heads"):
        treg.build("transformer_lm", dict(_cfg("float32"), attention="ring"))
    with pytest.raises(ValueError, match="not ported"):
        treg.build("transformer_lm", dict(_cfg("float32"), attention="paged"))
