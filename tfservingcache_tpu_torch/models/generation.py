"""KV-cached autoregressive generation for ``transformer_lm`` and ``moe_lm``.

Counterpart of ``tfservingcache_tpu/models/generation.py`` with the same
arithmetic and rounding points, reusing the port's ``rmsnorm``/``rope`` math
and, for ``moe_lm``, its routed FFN (``moe_lm.moe_block``, which routes over
whatever (B, S) a step forwards, as the reference's does):
  - prefill writes each layer's K/V into a preallocated cache and the
    decode steps attend one query position against it;
  - the solo path (``generate``) is prefill + a decode loop over a dense
    ``(layers, B, n_kv, max_len, hd)`` cache;
  - the continuous engine's lanes live either in a dense slot array
    (``decode_chunk``) or in a paged arena shared through per-lane block
    tables (``paged_decode_chunk``), whose attention goes through
    ``ops.attention.paged_attention`` — the CUDA paged decode kernel on the
    card;
  - a speculative round's verify pass (``_paged_verify_step``, driven by
    ``models/speculative.py``) forwards T positions per lane through
    ``ops.attention.paged_attention_verify`` — the CUDA paged verify kernel;
    a chunk of a chunked prefill (``paged_prefill_chunk``) is the same step
    on one lane at T = chunk;
  - the KV-reuse layer: the solo prefix cache continues from cached rows
    (``generate_from_cache``, ``slot_prefill_from_cache``), and the shared
    prefix of a paged arena is gathered (``paged_gather_prefix``) and
    copied on write (``page_copy``);
  - conversation parking: a lane's raw pages are gathered for the host
    (``pages_export``) and written back into fresh pages at resume
    (``pages_import``).

The JAX functions are pure and donate their buffers; here the cache and the
arena are updated IN PLACE (index assignment under ``torch.inference_mode``).
Write offsets follow ``lax.dynamic_update_slice``: a start index is clamped
so that the update fits, so a lane that decodes past its budget overwrites
its last row instead of writing out of bounds (an index past the end would
fault the CUDA context). A chunk copies its host inputs to the device once
and runs every step without a host sync.

Random draws come from explicit ``torch.Generator``s (JAX's threefry stream
cannot be reproduced): the filter math of ``_sample``/``_sample_per_row``
is the reference's, the categorical draw is Gumbel-max as in
``jax.random.categorical``.
"""

from __future__ import annotations

import math

import torch

from tfservingcache_tpu_torch.models.transformer_lm import rmsnorm
from tfservingcache_tpu_torch.ops.attention import (
    NEG_INF,
    paged_attention,
    paged_attention_verify,
)


def _dims(cfg: dict) -> tuple[int, int, int]:
    n_heads, n_kv = cfg["n_heads"], cfg["n_kv_heads"]
    return n_heads, n_kv, cfg["d_model"] // n_heads


def init_cache(cfg: dict, batch: int, max_len: int, device: torch.device | str) -> dict:
    """Per-layer K/V buffers ``(layers, batch, n_kv, max_len, hd)`` in the
    model dtype (reference :43)."""
    _, n_kv, hd = _dims(cfg)
    shape = (cfg["n_layers"], batch, n_kv, max_len, hd)
    dtype = getattr(torch, cfg["dtype"])
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_cache(cfg: dict, n_pages: int, page_tokens: int, arena_dtype: str,
                     device: torch.device | str) -> dict:
    """The paged arena ``(layers, n_pages, n_kv, page_tokens, hd)`` shared by
    every lane of one model (reference :381). Page 0 is the trash page.
    ``arena_dtype="int8"`` adds per-(page, head, token) f32 scale buffers
    ``k_scale``/``v_scale``; another non-empty name overrides the model
    dtype."""
    _, n_kv, hd = _dims(cfg)
    shape = (cfg["n_layers"], n_pages, n_kv, page_tokens, hd)
    if arena_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    dtype = getattr(torch, arena_dtype or cfg["dtype"])
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 over the last axis (reference :430): ``x (..., hd)``
    -> (int8 values, f32 scales ``(...)``) with ``x ~ values * scales``.
    ``torch.round`` rounds half to even, as ``jnp.round`` does, so equal f32
    inputs give bit-identical rows."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _gumbel_argmax(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One categorical draw per row (``jax.random.categorical``'s method)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _sample_per_row(logits: torch.Tensor, gen: torch.Generator | None,
                    temperature: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """logits (S, V) f32, temperature (S,) f32, top_k (S,) -> ids (S,)
    (reference :206): greedy where t <= 0; otherwise the top-k threshold at
    the k-th largest value (k in (0, V), ties kept), the rest filled with
    -1e30, then a categorical draw at ``max(t, 1e-6)``. ``gen=None`` means
    every row is greedy (the caller checked its host mirrors)."""
    greedy = torch.argmax(logits, dim=-1)
    if gen is None:
        return greedy
    v = logits.shape[-1]
    k = top_k.long().clamp(0, v)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = sorted_desc.gather(1, (k - 1).clamp(0, v - 1)[:, None])
    use = ((k > 0) & (k < v))[:, None]
    thresh = torch.where(use, kth, torch.full_like(kth, -math.inf))
    filt = torch.where(logits < thresh, torch.full_like(logits, -1e30), logits)
    temp = temperature.float().clamp(min=1e-6)[:, None]
    sampled = _gumbel_argmax(filt / temp, gen)
    return torch.where(temperature <= 0.0, greedy, sampled)


def _sample(logits: torch.Tensor, gen: torch.Generator, temperature: float,
            top_k: int) -> torch.Tensor:
    """logits (B, V) -> ids (B,) with one sampling config for every row
    (reference :62)."""
    b = logits.shape[0]
    temps = torch.full((b,), float(temperature), device=logits.device)
    topks = torch.full((b,), int(top_k), device=logits.device)
    return _sample_per_row(logits, gen if temperature > 0.0 else None, temps, topks)


def _rope_per_example(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding with per-example positions (B, S) over (B, H, S, D),
    interleaved pairs (reference :913)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = positions[..., None].float() * freqs[None, None, :]          # (B,S,d/2)
    cos = torch.cos(angles)[:, None]                                      # (B,1,S,d/2)
    sin = torch.sin(angles)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.reshape(x.shape).to(x.dtype)


def _ffn_block(layer: torch.nn.Module, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The family's FFN half of a decoder layer on the residual stream before
    its norm; returns the residual delta (reference :830): moe_lm's routed
    experts (the router in f32, the experts in the activation dtype; the aux
    loss is a training signal) or transformer_lm's dense FFN."""
    h = rmsnorm(x, layer.ln2)
    if hasattr(layer, "moe"):
        return layer.moe(h, cfg)
    return layer.mlp(h)


def _embed(model: torch.nn.Module, ids: torch.Tensor) -> torch.Tensor:
    """The reference's gather semantics: negative ids wrap, out-of-range ids
    clamp (as ``TransformerLM.forward``)."""
    vocab = model.embed.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + vocab, ids).clamp(0, vocab - 1)
    return model.embed[ids].to(model.dtype)


def _qkv(layer: torch.nn.Module, x: torch.Tensor, positions: torch.Tensor, cfg: dict):
    """Pre-norm projections + RoPE: x (B, S, d) -> q (B, Hq, S, hd), k/v
    (B, Hkv, S, hd) in the activation dtype."""
    n_heads, n_kv, hd = _dims(cfg)
    b, s, _ = x.shape
    dt = x.dtype
    attn = layer.attn
    h = rmsnorm(x, layer.ln1)
    q = (h @ attn.wq.to(dt)).reshape(b, s, n_heads, hd).transpose(1, 2)
    k = (h @ attn.wk.to(dt)).reshape(b, s, n_kv, hd).transpose(1, 2)
    v = (h @ attn.wv.to(dt)).reshape(b, s, n_kv, hd).transpose(1, 2)
    q = _rope_per_example(q, positions, cfg["rope_theta"])
    k = _rope_per_example(k, positions, cfg["rope_theta"])
    return q, k, v


def _finish_layer(layer, x: torch.Tensor, out: torch.Tensor, cfg: dict) -> torch.Tensor:
    """out (B, Hq, S, hd) f32 attention -> residual adds of the attention and
    FFN halves."""
    b, _, s, _ = out.shape
    out = out.to(x.dtype).transpose(1, 2).reshape(b, s, x.shape[-1])
    x = x + out @ layer.attn.wo.to(x.dtype)
    return x + _ffn_block(layer, x, cfg)


def _logits(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, model.ln_f)
    return (x @ model.embed.to(x.dtype).T).float()


def _forward_cached_dyn(model: torch.nn.Module, input_ids: torch.Tensor, cache: dict,
                        start_pos: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Forward ``input_ids (B, S)`` at per-example start positions ``(B,)``
    against a dense cache, writing each example's K/V rows at its start
    (clamped so the rows fit, as ``lax.dynamic_update_slice``) IN PLACE
    (reference :848). Attention reads the whole cache with the mask
    ``k_pos <= q_pos``; scores and p.v are f32 sums of the stored values, p
    cast to the cache dtype first. -> logits (B, S, V) f32."""
    n_heads, n_kv, hd = _dims(cfg)
    b, s_len = input_ids.shape
    max_len = cache["k"].shape[3]
    start_pos = start_pos.long()
    positions = start_pos[:, None] + torch.arange(s_len, device=input_ids.device)[None, :]
    write = start_pos.clamp(0, max_len - s_len)[:, None] + torch.arange(
        s_len, device=input_ids.device)[None, :]                            # (B, S)
    rows = torch.arange(b, device=input_ids.device)[:, None]
    k_pos = torch.arange(max_len, device=input_ids.device)
    mask = (k_pos[None, None, :] <= positions[:, :, None])[:, None, None]   # (B,1,1,S,L)
    g = n_heads // n_kv
    x = _embed(model, input_ids)
    for li, layer in enumerate(model.layers):
        q, k, v = _qkv(layer, x, positions, cfg)
        ck, cv = cache["k"][li], cache["v"][li]
        # advanced indices at dims 0 and 2: the updated block is (B, S, n_kv, hd)
        ck[rows, :, write] = k.transpose(1, 2).to(ck.dtype)
        cv[rows, :, write] = v.transpose(1, 2).to(cv.dtype)
        qg = q.reshape(b, n_kv, g, s_len, hd).float()
        sc = torch.einsum("bkgqd,bkld->bkgql", qg, ck.float()) / math.sqrt(hd)
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        p = torch.softmax(sc, dim=-1)
        out = torch.einsum("bkgql,bkld->bkgqd", p.to(cv.dtype).float(), cv.float())
        x = _finish_layer(layer, x, out.reshape(b, n_heads, s_len, hd), cfg)
    return _logits(model, x)


def _decode_loop(model: torch.nn.Module, cfg: dict, cache: dict, tok: torch.Tensor,
                 pos: torch.Tensor, gen: torch.Generator, temperature: float, top_k: int,
                 max_new_tokens: int, write_last: bool) -> torch.Tensor:
    """The solo decode loop shared by ``generate`` and ``generate_from_cache``
    (the reference's ``_decode_scan`` :85): ``tok (B,)`` is the first
    emitted token, at ``pos`` and not yet in the cache; each step forwards
    the last token and samples the next from ``gen``, so the plain and
    from-cache paths draw the same stream under one seed. The reference's
    scan also forwards the LAST emitted token (its result discarded); that
    forward runs only with ``write_last``, for a caller that keeps the cache
    (its row at ``pos + max_new_tokens - 1`` is then written).
    -> (B, max_new_tokens) ids."""
    toks = [tok]
    for _ in range(max_new_tokens - 1):
        logits = _forward_cached_dyn(model, tok[:, None], cache, pos, cfg)
        tok = _sample(logits[:, 0], gen, temperature, top_k)
        toks.append(tok)
        pos = pos + 1
    if write_last:
        _forward_cached_dyn(model, tok[:, None], cache, pos, cfg)
    return torch.stack(toks, dim=1).int()


@torch.inference_mode()
def generate(model: torch.nn.Module, cfg: dict, input_ids: torch.Tensor,
             prompt_lengths: torch.Tensor, max_new_tokens: int, temperature: float = 0.0,
             top_k: int = 0, seed: int = 0, return_cache: bool = False):
    """Generate ``max_new_tokens`` per row of ``input_ids`` (B, S prompt,
    right-padded; ``prompt_lengths`` the true lengths) -> (B, max_new_tokens)
    ids (reference :925 with the ``_generate_jit``/``_decode_scan`` body,
    :85-146). Draws come from a generator seeded with ``seed``: the same
    seed gives the same tokens. ``return_cache`` also returns the final K/V
    ``(layers, B, n_kv, S + max_new_tokens, hd)``, valid for the whole
    prompt + completion (the prefix cache stores it)."""
    b, s = input_ids.shape
    if s + max_new_tokens > cfg["max_seq"]:
        raise ValueError(
            f"prompt {s} + max_new_tokens {max_new_tokens} exceeds max_seq {cfg['max_seq']}"
        )
    dev = input_ids.device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    cache = init_cache(cfg, b, s + max_new_tokens, dev)
    lengths = prompt_lengths.long().to(dev)
    logits = _forward_cached_dyn(model, input_ids, cache, torch.zeros(b, dtype=torch.long,
                                                                      device=dev), cfg)
    last = logits[torch.arange(b, device=dev), lengths - 1]
    tok = _sample(last, gen, temperature, top_k)
    toks = _decode_loop(model, cfg, cache, tok, lengths, gen, temperature, top_k,
                        max_new_tokens, return_cache)
    return (toks, cache["k"], cache["v"]) if return_cache else toks


def _cache_from_prefix(cfg: dict, cached_k: torch.Tensor, cached_v: torch.Tensor,
                       max_len: int) -> dict:
    """A fresh ``(layers, 1, n_kv, max_len, hd)`` cache whose first rows are
    the cached prefix's (cast to the model dtype)."""
    cache = init_cache(cfg, cached_k.shape[1], max_len, cached_k.device)
    l_pad = cached_k.shape[3]
    cache["k"][:, :, :, :l_pad] = cached_k.to(cache["k"].dtype)
    cache["v"][:, :, :, :l_pad] = cached_v.to(cache["v"].dtype)
    return cache


@torch.inference_mode()
def generate_from_cache(model: torch.nn.Module, cfg: dict, suffix_ids: torch.Tensor,
                        suffix_len: int, cached_k: torch.Tensor, cached_v: torch.Tensor,
                        cached_len: int, max_new_tokens: int, temperature: float = 0.0,
                        top_k: int = 0, seed: int = 0, return_cache: bool = False):
    """Continue a B = 1 generate from a cached prompt prefix (reference
    ``generate_from_cache`` :976 / ``_generate_from_cache_jit`` :153): copy
    the prefix rows ``cached_k/v (layers, 1, n_kv, Lpad, hd)`` in, prefill
    only ``suffix_ids (1, S')`` (the prompt tokens after the ``cached_len``
    valid rows, padded; ``suffix_len`` true), then ``generate``'s decode
    loop under the same seed discipline. Rows past ``cached_len`` are junk
    the suffix prefill and the decode steps overwrite before any query sees
    them. -> ids (1, max_new_tokens) [, k, v]."""
    s_pad = suffix_ids.shape[1]
    dev = suffix_ids.device
    cache = _cache_from_prefix(cfg, cached_k, cached_v,
                               cached_k.shape[3] + s_pad + max_new_tokens)
    start = torch.full((1,), int(cached_len), dtype=torch.long, device=dev)
    logits = _forward_cached_dyn(model, suffix_ids, cache, start, cfg)
    last = logits[:, int(suffix_len) - 1]
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    tok = _sample(last, gen, temperature, top_k)
    toks = _decode_loop(model, cfg, cache, tok, start + int(suffix_len), gen, temperature,
                        top_k, max_new_tokens, return_cache)
    return (toks, cache["k"], cache["v"]) if return_cache else toks


@torch.inference_mode()
def slot_prefill(model: torch.nn.Module, cfg: dict, input_ids: torch.Tensor, prompt_len: int,
                 temperature: float, top_k: int, seed: int):
    """Prefill ONE right-padded prompt ``(1, S_pad)`` into a fresh cache and
    sample its first token (``_slot_prefill_jit`` :228). -> (first token
    (1,), k, v ``(layers, 1, n_kv, S_pad, hd)``, last logits (1, V) f32). The
    first token's own K/V is written by the first decode step."""
    dev = input_ids.device
    cache = init_cache(cfg, 1, input_ids.shape[1], dev)
    logits = _forward_cached_dyn(model, input_ids, cache,
                                 torch.zeros(1, dtype=torch.long, device=dev), cfg)
    last = logits[:, prompt_len - 1].clone()  # not a view that pins every row's logits
    return sample_logits(last, temperature, top_k, seed), cache["k"], cache["v"], last


@torch.inference_mode()
def slot_prefill_from_cache(model: torch.nn.Module, cfg: dict, suffix_ids: torch.Tensor,
                            suffix_len: int, cached_k: torch.Tensor, cached_v: torch.Tensor,
                            cached_len: int, temperature: float, top_k: int, seed: int):
    """Admission prefill continuing from cached prefix rows
    (``_slot_prefill_from_cache_jit`` :261): copy the prefix rows, prefill
    only the suffix, sample the first token as ``slot_prefill`` does. ->
    (first token (1,), k, v ``(layers, 1, n_kv, Lpad + S'_pad, hd)``, last
    logits (1, V) f32)."""
    dev = suffix_ids.device
    cache = _cache_from_prefix(cfg, cached_k, cached_v, cached_k.shape[3] + suffix_ids.shape[1])
    start = torch.full((1,), int(cached_len), dtype=torch.long, device=dev)
    logits = _forward_cached_dyn(model, suffix_ids, cache, start, cfg)
    last = logits[:, int(suffix_len) - 1].clone()
    return sample_logits(last, temperature, top_k, seed), cache["k"], cache["v"], last


@torch.inference_mode()
def sample_logits(last: torch.Tensor, temperature: float, top_k: int,
                  seed: int) -> torch.Tensor:
    """Sample a first token from last-position logits ``(1, V)`` f32 with a
    generator seeded with ``seed`` (``_sample_logits_jit`` :304): the draw
    ``slot_prefill`` makes after its forward, so an exact shared-prefix hit
    or a chunked prefill samples the token a monolithic prefill of the same
    prompt samples under the same seed. -> (1,)."""
    gen = torch.Generator(device=last.device).manual_seed(int(seed))
    return _sample(last, gen, temperature, top_k)


@torch.inference_mode()
def slot_insert(slot_k: torch.Tensor, slot_v: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                idx: int) -> None:
    """Copy one admitted request's prefill K/V ``(layers, 1, n_kv, P_pad, hd)``
    into lane ``idx`` of the dense slot array IN PLACE (``_slot_insert_jit``
    :315). Rows past P_pad keep a previous occupant's K/V, never visible:
    a decode step writes row p before attending to it."""
    p_pad = pk.shape[3]
    slot_k[:, idx:idx + 1, :, :p_pad] = pk.to(slot_k.dtype)
    slot_v[:, idx:idx + 1, :, :p_pad] = pv.to(slot_v.dtype)


@torch.inference_mode()
def decode_chunk(model: torch.nn.Module, cfg: dict, slot_k: torch.Tensor,
                 slot_v: torch.Tensor, tok: torch.Tensor, pos: torch.Tensor,
                 active: torch.Tensor, gen: torch.Generator | None, temps: torch.Tensor,
                 topks: torch.Tensor, chunk: int):
    """Advance every ACTIVE lane of the dense slot array by ``chunk`` steps
    (``_decode_chunk_jit`` :339), K/V written in place. Inactive lanes ride
    along frozen (same token, same position). -> (tok (S,), pos (S,),
    toks (S, chunk)), all device tensors."""
    step_pos = active.long()
    toks = []
    for _ in range(chunk):
        logits = _forward_cached_dyn(model, tok[:, None], {"k": slot_k, "v": slot_v}, pos, cfg)
        nxt = _sample_per_row(logits[:, 0], gen, temps, topks)
        tok = torch.where(active, nxt, tok)
        pos = pos + step_pos
        toks.append(tok)
    return tok, pos, torch.stack(toks, dim=1)


@torch.inference_mode()
def paged_insert(arena: dict, pk: torch.Tensor, pv: torch.Tensor, table_row: torch.Tensor,
                 page_tokens: int, base: int = 0) -> None:
    """Scatter one admitted request's prefill K/V ``(layers, 1, n_kv, P_pad,
    hd)`` into its reserved pages IN PLACE (``_paged_insert_jit`` :654):
    logical row ``r`` goes to page ``table_row[r // page_tokens]`` offset
    ``r % page_tokens``; rows below ``base`` (the shared-prefix boundary: those
    rows live in pages mapped read-only, and a suffix prefill produced junk
    there) go to the trash page. An int8 arena quantizes the rows first."""
    p_pad = pk.shape[3]
    pps = table_row.shape[0]
    dev = pk.device
    rows = torch.arange(p_pad, device=dev)
    pages = table_row.long()[(rows // page_tokens).clamp(0, pps - 1)]
    pages = torch.where(rows >= base, pages, torch.zeros_like(pages))
    offs = rows % page_tokens
    # (layers, 1, n_kv, P_pad, hd) -> (P_pad, layers, n_kv, hd): the two
    # advanced indices below are non-adjacent, so their broadcast dim moves
    # to the front of the updated block
    kv = pk[:, 0].permute(2, 0, 1, 3)
    vv = pv[:, 0].permute(2, 0, 1, 3)
    if "k_scale" in arena:
        kv, k_s = _quantize_kv_rows(kv)
        vv, v_s = _quantize_kv_rows(vv)
        arena["k_scale"][:, pages, :, offs] = k_s
        arena["v_scale"][:, pages, :, offs] = v_s
    arena["k"][:, pages, :, offs, :] = kv.to(arena["k"].dtype)
    arena["v"][:, pages, :, offs, :] = vv.to(arena["v"].dtype)


@torch.inference_mode()
def paged_gather_prefix(arena: dict, pages: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather ``n`` full shared-prefix pages into the dense ``(layers, 1,
    n_kv, n * page_tokens, hd)`` rows ``slot_prefill_from_cache`` takes
    (``_paged_gather_prefix_jit`` :697). Read-only on the arena. An int8
    arena is dequantized to f32 rows here."""
    idx = torch.as_tensor(pages, dtype=torch.long, device=arena["k"].device)
    k, v = arena["k"][:, idx], arena["v"][:, idx]          # (L, n, n_kv, pt, hd)
    if "k_scale" in arena:
        k = k.float() * arena["k_scale"][:, idx][..., None]
        v = v.float() * arena["v_scale"][:, idx][..., None]
    layers, n, n_kv, pt, hd = k.shape
    k = k.transpose(1, 2).reshape(layers, n_kv, n * pt, hd)[:, None]
    v = v.transpose(1, 2).reshape(layers, n_kv, n * pt, hd)[:, None]
    return k, v


@torch.inference_mode()
def page_copy(arena: dict, src: int, dst: int) -> None:
    """Copy arena page ``src`` to ``dst`` IN PLACE, with an int8 arena's
    scales (``_page_copy_jit`` :718): copy-on-write, and the index's
    pristine copy of a published boundary page."""
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in arena:
            arena[name][:, dst] = arena[name][:, src]


@torch.inference_mode()
def pages_export(arena: dict, pages: list[int]) -> dict:
    """Gather ``n`` arena pages' RAW rows for conversation parking
    (``_pages_export_jit`` :737): ``{"k", "v"[, "k_scale", "v_scale"]}``
    in page layout ``(layers, n, n_kv, page_tokens[, hd])``, in the arena's
    dtype. An int8 arena's values and scales come back as they are, never
    dequantized, so that an import writes the same bits back. Read-only on
    the arena (a gather copies)."""
    idx = torch.as_tensor(pages, dtype=torch.long, device=arena["k"].device)
    return {name: t.index_select(1, idx) for name, t in arena.items()}


@torch.inference_mode()
def pages_import(arena: dict, pages: list[int], payload: dict) -> None:
    """Write parked page payloads (``pages_export``'s layout and dtype) into
    the arena pages ``pages`` IN PLACE (``_pages_import_jit`` :754): one
    batched index copy along the page axis per buffer, values and int8
    scales, so a park followed by an import leaves every page bit-identical."""
    idx = torch.as_tensor(pages, dtype=torch.long, device=arena["k"].device)
    for name, t in arena.items():
        t.index_copy_(1, idx, payload[name].to(t.dtype))


def _paged_step(model: torch.nn.Module, cfg: dict, toks: torch.Tensor, arena: dict,
                tables: torch.Tensor, pos: torch.Tensor, page_tokens: int, kernel: bool,
                attend) -> torch.Tensor:
    """One forward of ``toks (S, T)`` per lane against the paged arena: lane
    ``s``'s T tokens sit at ``pos[s] .. pos[s] + T - 1`` and each writes its
    K/V row IN PLACE at ``tables[s, p // page_tokens]`` offset
    ``p % page_tokens``. The table index is clipped first; a position at or
    past ``pps * page_tokens`` then goes to the trash page 0 explicitly (the
    clip alone would alias it onto the lane's last slot and overwrite
    visible history). An int8 arena quantizes the T rows at write time.
    Attention is one ``attend`` call per layer (the decode or the verify
    dispatch). -> logits (S, T, V) f32."""
    n_heads, n_kv, hd = _dims(cfg)
    s_lanes, t_q = toks.shape
    pps = tables.shape[1]
    positions = pos.long()[:, None] + torch.arange(t_q, device=toks.device)[None, :]  # (S, T)
    pages = tables.gather(1, (positions // page_tokens).clamp(0, pps - 1)).long()
    pages = torch.where(positions // page_tokens >= pps, torch.zeros_like(pages), pages)
    off = positions % page_tokens
    quantized = "k_scale" in arena
    x = _embed(model, toks)                                               # (S, T, d)
    for li, layer in enumerate(model.layers):
        q, k, v = _qkv(layer, x, positions, cfg)
        # advanced indices (S, T) at arena dims 0 and 2 straddle the head
        # slice, so the updated block is (S, T, n_kv, hd)
        k_rows, v_rows = k.transpose(1, 2), v.transpose(1, 2)              # (S, T, n_kv, hd)
        ks_arena = vs_arena = None
        if quantized:
            k_rows, k_s = _quantize_kv_rows(k_rows)
            v_rows, v_s = _quantize_kv_rows(v_rows)
            ks_arena, vs_arena = arena["k_scale"][li], arena["v_scale"][li]
            ks_arena[pages, :, off] = k_s
            vs_arena[pages, :, off] = v_s
        k_arena, v_arena = arena["k"][li], arena["v"][li]
        k_arena[pages, :, off, :] = k_rows.to(k_arena.dtype)
        v_arena[pages, :, off, :] = v_rows.to(v_arena.dtype)
        out = attend(q, k_arena, v_arena, tables, pos, page_tokens,
                     k_scale=ks_arena, v_scale=vs_arena, kernel=kernel)
        x = _finish_layer(layer, x, out.reshape(s_lanes, n_heads, t_q, hd), cfg)
    return _logits(model, x)


def _paged_forward_step(model: torch.nn.Module, cfg: dict, tok: torch.Tensor, arena: dict,
                        tables: torch.Tensor, pos: torch.Tensor, page_tokens: int,
                        kernel: bool) -> torch.Tensor:
    """One decode step (one token ``tok (S,)`` per lane) against the paged
    arena (reference :441): ``_paged_step`` at T = 1 through
    ``paged_attention``, the decode dispatch. -> logits (S, 1, V) f32."""
    return _paged_step(model, cfg, tok[:, None], arena, tables, pos, page_tokens, kernel,
                       paged_attention)


def _paged_verify_step(model: torch.nn.Module, cfg: dict, toks: torch.Tensor, arena: dict,
                       tables: torch.Tensor, pos: torch.Tensor, page_tokens: int,
                       kernel: bool) -> torch.Tensor:
    """One multi-position forward (``toks (S, T)``) against the paged arena
    (reference :523): the verify pass of a speculative round, ``_paged_step``
    through ``paged_attention_verify`` — one call per layer, each of the T
    queries with its own causal frontier. At T = 1 it is the decode step
    operation for operation. -> logits (S, T, V) f32."""
    return _paged_step(model, cfg, toks, arena, tables, pos, page_tokens, kernel,
                       paged_attention_verify)


@torch.inference_mode()
def paged_prefill_chunk(model: torch.nn.Module, cfg: dict, arena: dict,
                        table_row: torch.Tensor, toks: torch.Tensor, start: torch.Tensor,
                        real_len: int, page_tokens: int, kernel: bool) -> torch.Tensor:
    """One fixed-size prefill chunk written straight into a lane's reserved
    pages (``_paged_prefill_chunk_jit`` :612, chunked prefill): the verify
    step on one lane at T = C (``toks (1, C)``, zero-padded past
    ``real_len`` real tokens; ``table_row (1, pps)`` and ``start (1,)``
    int32 device tensors, ``start`` the position of ``toks[:, 0]``). K/V
    rows land at start .. start + C - 1 through the lane's table (pad rows
    past the reservation go to the trash page) and every real query attends
    over every row written before it, through the paged verify dispatch: B3
    at T = C on the card. -> the last real token's logits (1, V) f32, on the
    device."""
    logits = _paged_verify_step(model, cfg, toks, arena, table_row, start, page_tokens, kernel)
    return logits[:, min(max(int(real_len) - 1, 0), toks.shape[1] - 1)].clone()


@torch.inference_mode()
def paged_decode_chunk(model: torch.nn.Module, cfg: dict, arena: dict, tables: torch.Tensor,
                       tok: torch.Tensor, pos: torch.Tensor, active: torch.Tensor,
                       gen: torch.Generator | None, temps: torch.Tensor, topks: torch.Tensor,
                       chunk: int, page_tokens: int, kernel: bool):
    """Paged counterpart of ``decode_chunk`` (``_paged_decode_chunk_jit``
    :777): the same loop and frozen inactive lanes, K/V in the shared arena
    (updated in place), each lane reading through its block table. ``tables``
    and ``pos`` are int32 device tensors. -> (tok, pos, toks (S, chunk))."""
    step_pos = active.int()
    toks = []
    for _ in range(chunk):
        logits = _paged_forward_step(model, cfg, tok, arena, tables, pos, page_tokens, kernel)
        nxt = _sample_per_row(logits[:, 0], gen, temps, topks)
        tok = torch.where(active, nxt, tok)
        pos = pos + step_pos
        toks.append(tok)
    return tok, pos, torch.stack(toks, dim=1)

