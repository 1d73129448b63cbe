"""Greedy speculative decoding: a small draft model proposes ``spec_tokens``
tokens per round, the target model verifies them in ONE multi-position
forward.

Counterpart of ``tfservingcache_tpu/models/speculative.py``. Two paths:
  - solo (``speculative_generate``, transformer_lm and moe_lm targets and
    drafts): dense per-request caches through ``_forward_cached_dyn``, plain
    torch ops; with the prefix cache it returns the target's K/V
    (``return_cache``) and starts the target's prefill from cached prefix
    rows (``cached_kv``);
  - the continuous engine (``paged_spec_round``): one round for every lane
    of a paged slot state — the draft's spec+1 decode steps over its own
    arena (the paged decode kernel on the card), then the target's verify
    pass over all spec+1 positions (the paged verify kernel).

Either model may be tensor parallel on a device group (``TensorParallelLM``,
``TensorParallelMoELM``): its caches and arena are then cut over its KV
heads as ``models/generation.py`` places them, and each of its steps runs
shard by shard, the draft's and the target's alike.

Exactness: at temperature 0 the emitted sequence is the target's own greedy
decode — a token is kept only while it matches the target's argmax, and the
first mismatch is replaced by the target's own choice. The verify forward
and the width-1 decode forward are different matmul shapes, so on the card
a near-tied argmax can round the other way; on the CPU in f32 the tests
hold it token for token. A moe_lm target routes its verify chunk at
another (B, spec+1) shape than its width-1 steps, so where a token can
overflow its expert's capacity the two may drop different tokens and
differ, as the reference's do.

Rollback costs nothing: a verify pass starts exactly at the accepted
position and attention masks reads to ``k_pos <= query_pos``, so K/V rows
written for later-rejected tokens are invisible until the next round
overwrites them; "rollback" is not advancing the position.
"""

from __future__ import annotations

from typing import Any

import torch

from tfservingcache_tpu_torch.models.generation import (
    _cache_from_prefix,
    _forward_cached_dyn,
    _paged_forward_step,
    _paged_verify_step,
    _sample_per_row,
    init_cache,
    kv_group,
)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def _spec_decode_loop(model_t: torch.nn.Module, model_d: torch.nn.Module, cfg_t: dict,
                      cfg_d: dict, cache_t: dict, cache_d: dict, first: torch.Tensor,
                      prompt_len: torch.Tensor, spec: int,
                      max_new_tokens: int):
    """The draft-propose / target-verify loop (reference :48-129) as a Python
    loop over rounds, caches updated in place. -> (out (B, max_new_tokens),
    rounds, final_tok, final_idx): the last round's carry and its EMITTED
    index (unclamped; past max_new_tokens - 1 when the last round
    overshot, see ``_writeback_final``)."""
    b = first.shape[0]
    dev = first.device
    # one spare column takes every dropped write (the reference's OOB drop)
    out = torch.zeros((b, max_new_tokens + 1), dtype=torch.long, device=dev)
    out[:, 0] = first
    n_done = torch.ones((b,), dtype=torch.long, device=dev)
    jrange = torch.arange(spec + 1, device=dev)[None, :]
    cur_tok = first
    final_idx = torch.zeros((b,), dtype=torch.long, device=dev)  # `first` is emitted index 0
    rounds = 0
    while bool((n_done < max_new_tokens).any()):
        # cur_tok is the accepted token AT position pos, not yet in either cache
        pos = prompt_len + n_done - 1
        # spec+1 draft steps, not spec: the extra step forwards d_spec so its
        # K/V row lands in the draft cache. Without it a fully accepted round
        # leaves a never-written hole at pos+spec that every later draft
        # query attends to, silently decaying acceptance.
        tk, p, d_toks = cur_tok, pos, []
        for _ in range(spec + 1):
            logits = _forward_cached_dyn(model_d, tk[:, None], cache_d, p, cfg_d)
            tk = _greedy(logits[:, 0])
            d_toks.append(tk)
            p = p + 1
        d = torch.stack(d_toks[:spec], dim=1)                          # (B, spec)
        # one chunked target forward verifies every proposal: logits_j
        # predicts position pos+1+j
        chunk = torch.cat([cur_tok[:, None], d], dim=1)                 # (B, spec+1)
        g = _greedy(_forward_cached_dyn(model_t, chunk, cache_t, pos, cfg_t))
        a = torch.cumprod((d == g[:, :spec]).long(), dim=1).sum(dim=1)  # (B,) 0..spec
        # emitted this round: d_1..d_a (== g_0..g_{a-1}) then g_a
        g_at_a = g.gather(1, a[:, None])[:, 0]
        d_pad = torch.cat([d, torch.zeros((b, 1), dtype=d.dtype, device=dev)], dim=1)
        e = torch.where(jrange < a[:, None], d_pad,
                        torch.where(jrange == a[:, None], g_at_a[:, None],
                                    torch.zeros_like(d_pad)))
        idx = n_done[:, None] + jrange
        valid = (jrange <= a[:, None]) & (idx < max_new_tokens)
        out.scatter_(1, torch.where(valid, idx, torch.full_like(idx, max_new_tokens)), e)
        cur_tok = g_at_a
        final_idx = n_done + a
        n_done = torch.clamp(n_done + a + 1, max=max_new_tokens)
        rounds += 1
    # rounds is the acceptance-health signal: a well-aligned draft emits
    # ~spec+1 tokens per round
    return out[:, :max_new_tokens], rounds, cur_tok, final_idx


def _writeback_final(model_t: torch.nn.Module, cfg_t: dict, cache_t: dict,
                     final_tok: torch.Tensor, final_idx: torch.Tensor,
                     prompt_len: torch.Tensor, max_new_tokens: int) -> None:
    """One (B, 1) target forward so that the LAST completion position's K/V
    row is valid (reference :132): every other emitted token was the input
    of a later verify chunk, so its row is written already. When the last
    round overshot max_new_tokens the carry was never emitted, and the true
    last token's row is already right: the forward then goes one row PAST
    the kept range (the slack rows every spec cache has)."""
    overshoot = (final_idx > max_new_tokens - 1).long()
    _forward_cached_dyn(model_t, final_tok[:, None], cache_t,
                        prompt_len + max_new_tokens - 1 + overshoot, cfg_t)


@torch.inference_mode()
def speculative_generate(
    model_def_t: Any,
    model_t: torch.nn.Module,
    model_def_d: Any,
    model_d: torch.nn.Module,
    input_ids: torch.Tensor,
    prompt_lengths: torch.Tensor | None = None,
    max_new_tokens: int = 32,
    spec_tokens: int = 4,
    return_rounds: bool = False,
    return_cache: bool = False,
    cached_kv: tuple | None = None,
):
    """Greedy decode of the TARGET model accelerated by the draft (reference
    :411-499). ``input_ids (B, S)`` on the models' device, right-padded;
    ``prompt_lengths`` the true lengths. -> (B, max_new_tokens) int32, then
    the verify-round count when ``return_rounds``, then the target's K/V
    when ``return_cache`` (B = 1: rows valid for the whole prompt +
    completion, after a final writeback forward). ``cached_kv = (suffix_ids,
    suffix_len, k, v, cached_len)`` (B = 1) starts the TARGET's prefill from
    cached prefix rows instead of the full prompt; the draft still prefills
    all of ``input_ids``. The emitted sequence is the same greedy decode
    either way."""
    for md, role in ((model_def_t, "target"), (model_def_d, "draft")):
        if md.family not in ("transformer_lm", "moe_lm"):
            raise ValueError(
                f"speculative decoding supports transformer_lm/moe_lm "
                f"{role}s, not {md.family!r}"
            )
    if model_def_t.config["vocab_size"] != model_def_d.config["vocab_size"]:
        raise ValueError(
            "draft and target must share a vocabulary: "
            f"{model_def_d.config['vocab_size']} vs "
            f"{model_def_t.config['vocab_size']}"
        )
    if spec_tokens < 1:
        raise ValueError(f"spec_tokens must be >= 1, got {spec_tokens}")
    b, s = input_ids.shape
    dev = input_ids.device
    if prompt_lengths is None:
        lengths = torch.full((b,), s, dtype=torch.long, device=dev)
    else:
        lengths = torch.as_tensor(prompt_lengths).long().to(dev)
    if s + max_new_tokens > model_def_t.config["max_seq"]:
        raise ValueError(
            f"prompt {s} + max_new_tokens {max_new_tokens} exceeds max_seq "
            f"{model_def_t.config['max_seq']}"
        )
    if (return_cache or cached_kv is not None) and b != 1:
        raise ValueError("cached-prefix speculative decoding and return_cache are B=1 only")
    cfg_t, cfg_d = model_def_t.config, model_def_d.config
    # slack for chunk writes past the last emitted position (stale rows are
    # masked off and finished examples keep writing while others drain)
    slack = max_new_tokens + spec_tokens + 1
    zeros = torch.zeros((b,), dtype=torch.long, device=dev)
    if cached_kv is None:
        cache_t = init_cache(cfg_t, b, s + slack, dev, kv_group(model_t))
        logits_t = _forward_cached_dyn(model_t, input_ids, cache_t, zeros, cfg_t)
        last = logits_t[torch.arange(b, device=dev), lengths - 1]
    else:
        # target: the prefix rows copied in, only the suffix prefilled
        suffix_ids, suffix_len, ck, cv, cached_len = cached_kv
        suffix_ids = torch.as_tensor(suffix_ids).to(dev)
        cache_t = _cache_from_prefix(cfg_t, ck, cv, ck.shape[3] + suffix_ids.shape[1] + slack)
        start = torch.full((1,), int(cached_len), dtype=torch.long, device=dev)
        logits_t = _forward_cached_dyn(model_t, suffix_ids, cache_t, start, cfg_t)
        last = logits_t[:, int(suffix_len) - 1]
    cache_d = init_cache(cfg_d, b, s + slack, dev, kv_group(model_d))
    _forward_cached_dyn(model_d, input_ids, cache_d, zeros, cfg_d)
    first = _greedy(last)
    out, rounds, final_tok, final_idx = _spec_decode_loop(
        model_t, model_d, cfg_t, cfg_d, cache_t, cache_d, first, lengths, spec_tokens,
        max_new_tokens)
    res = (out.int(),)
    if return_rounds:
        res += (rounds,)
    if return_cache:
        _writeback_final(model_t, cfg_t, cache_t, final_tok, final_idx, lengths, max_new_tokens)
        res += (cache_t["k"], cache_t["v"])
    return res[0] if len(res) == 1 else res


@torch.inference_mode()
def paged_spec_round(model_t: torch.nn.Module, cfg_t: dict, model_d: torch.nn.Module,
                     cfg_d: dict, arena_t: dict, arena_d: dict, t_tables: torch.Tensor,
                     d_tables: torch.Tensor, tok: torch.Tensor, pos: torch.Tensor,
                     active: torch.Tensor, gen: torch.Generator | None, temps: torch.Tensor,
                     topks: torch.Tensor, spec: int, page_tokens: int, kernel: bool):
    """One speculative round for EVERY lane of the continuous engine
    (``_paged_spec_round_jit``, reference :299-408), both arenas updated in
    place: the draft proposes ``spec`` greedy tokens per lane in spec+1
    paged decode steps over its own arena (the extra step writes d_spec's
    row, so full acceptance leaves no hole), then ONE multi-position target
    forward verifies all spec+1 positions and each lane accepts a
    variable-length prefix. Non-greedy lanes (temperature > 0) accept 0 and
    emit ``_sample_per_row`` of the position-0 logits — the token a plain
    decode step would have drawn. ``tables``/``pos`` are int32 device
    tensors; nothing here syncs with the host. -> (tok', pos', toks
    (S, spec+1), accept (S,)): lane ``s`` emits ``toks[s, :accept[s]]``
    (accept = a + 1 for active lanes, 0 for frozen ones)."""
    tk, p, d_toks = tok, pos, []
    for _ in range(spec + 1):
        logits = _paged_forward_step(model_d, cfg_d, tk, arena_d, d_tables, p, page_tokens,
                                     kernel)
        tk = _greedy(logits[:, 0])
        d_toks.append(tk)
        p = p + 1
    d = torch.stack(d_toks[:spec], dim=1)                               # (S, spec)
    # logits_t[:, j] predicts position pos+1+j
    chunk = torch.cat([tok[:, None], d], dim=1)                         # (S, spec+1)
    logits_t = _paged_verify_step(model_t, cfg_t, chunk, arena_t, t_tables, pos,
                                  page_tokens, kernel)
    g = _greedy(logits_t)                                               # (S, spec+1)
    a = torch.cumprod((d == g[:, :spec]).long(), dim=1).sum(dim=1)      # (S,) 0..spec
    # greedy lanes emit g[:, :a+1] (for j < a, d_j == g_j); the others
    # accept nothing and emit one token sampled from the position-0 logits
    greedy_row = temps <= 0.0
    e0 = _sample_per_row(logits_t[:, 0], gen, temps, topks)
    a = torch.where(greedy_row, a, torch.zeros_like(a))
    toks = g.clone()
    toks[:, 0] = torch.where(greedy_row, g[:, 0], e0)
    accept = torch.where(active, a + 1, torch.zeros_like(a))
    carry = toks.gather(1, a[:, None])[:, 0]
    tok = torch.where(active, carry, tok)
    pos = pos + accept.to(pos.dtype)
    return tok, pos, toks, accept
