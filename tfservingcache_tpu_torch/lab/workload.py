"""Workload DSL: declarative scenario specs compiled to seeded schedules
(counterpart of ``tfservingcache_tpu/lab/workload.py``; numpy and the
standard library only, and the same ``(spec, seed, vocab)`` compiles to the
reference's schedule field for field).

A :class:`WorkloadSpec` names five axes: tenant mix x zipf skew x arrival
process x prompt-length mix x multi-turn depth. :func:`compile_schedule`
turns it into a deterministic list of :class:`ScheduledRequest` (arrival
offset, tenant, prompt tokens, budget). The same (spec, seed) pair always
compiles to the same schedule, so a scorecard cell is replayable: re-run the
cell, get the same request stream, diff only the system under test.

Arrival processes:

* ``poisson``     — exponential inter-arrivals at ``rate_rps`` (open-loop
  load);
* ``burst``       — groups of ``burst_size`` simultaneous arrivals spaced
  ``burst_gap_s`` apart (coordinated clients, cron fan-out);
* ``flash_crowd`` — a poisson baseline with ``flash_share`` of all traffic
  compressed into a ``flash_width_s`` window at ``flash_at_s`` (everyone
  wants the same model at once).

Multi-turn conversations (``turns`` > 1) chain requests whose prompts
extend the previous turn's prompt with a fresh suffix, so the prefix and
conversation machinery is on the hook, not just cold prefill.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

__all__ = [
    "WorkloadSpec",
    "ScheduledRequest",
    "compile_schedule",
]

ARRIVALS = ("poisson", "burst", "flash_crowd")


@dataclass(frozen=True)
class WorkloadSpec:
    """One scenario, declaratively. ``requests`` counts TOTAL requests
    (conversations x turns); weights in ``tenant_mix``/``prompt_mix`` are
    relative, not normalized."""

    name: str
    tenants: tuple[str, ...] = ("lm",)
    # zipf skew over the tenant list (rank-ordered as given): weight of
    # tenant i is 1/(i+1)^zipf_s. 0 = uniform.
    zipf_s: float = 0.0
    arrival: str = "poisson"
    rate_rps: float = 16.0
    requests: int = 24
    burst_size: int = 6
    burst_gap_s: float = 0.4
    flash_at_s: float = 0.5
    flash_width_s: float = 0.05
    flash_share: float = 0.5
    prompt_lens: tuple[int, ...] = (6, 12, 24)
    prompt_mix: tuple[float, ...] = ()
    max_new: int = 12
    turns: int = 1
    turn_gap_s: float = 0.25
    # tokens appended per follow-up turn (the new "user message")
    turn_suffix_tokens: int = 6
    temperature: float = 0.0

    def __post_init__(self) -> None:
        if self.arrival not in ARRIVALS:
            raise ValueError(
                f"unknown arrival process {self.arrival!r}; one of {ARRIVALS}"
            )
        if not self.tenants:
            raise ValueError("spec needs at least one tenant")
        if self.prompt_mix and len(self.prompt_mix) != len(self.prompt_lens):
            raise ValueError("prompt_mix must match prompt_lens length")
        if self.requests < 1 or self.turns < 1:
            raise ValueError("requests and turns must be >= 1")


@dataclass(frozen=True)
class ScheduledRequest:
    """One compiled request: fire at ``at_s`` (offset from replay start)."""

    at_s: float
    tenant: str
    prompt: tuple[int, ...]
    max_new: int
    temperature: float
    conv: int          # conversation id (stable across its turns)
    turn: int          # 0-based turn index within the conversation
    index: int = field(default=0, compare=False)  # position in the schedule


def _tenant_weights(spec: WorkloadSpec) -> np.ndarray:
    n = len(spec.tenants)
    if spec.zipf_s <= 0.0 or n == 1:
        w = np.ones(n)
    else:
        w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), spec.zipf_s)
    return w / w.sum()


def _conv_starts(spec: WorkloadSpec, n: int, rng: np.random.Generator) -> np.ndarray:
    """Arrival offsets for the ``n`` conversation FIRST turns."""
    if spec.arrival == "poisson":
        return np.cumsum(rng.exponential(1.0 / spec.rate_rps, n))
    if spec.arrival == "burst":
        groups = np.arange(n) // max(1, spec.burst_size)
        return groups * spec.burst_gap_s
    # flash_crowd: baseline poisson trickle + a compressed spike
    n_flash = int(round(n * min(1.0, max(0.0, spec.flash_share))))
    base = np.cumsum(rng.exponential(1.0 / spec.rate_rps, n - n_flash))
    spike = spec.flash_at_s + rng.uniform(0.0, spec.flash_width_s, n_flash)
    return np.sort(np.concatenate([base, spike]))


def compile_schedule(
    spec: WorkloadSpec, seed: int, vocab: int = 256
) -> list[ScheduledRequest]:
    """Compile ``spec`` into a replayable schedule, sorted by arrival time.
    Token ids are drawn from [1, vocab): 0 is reserved (the LM families'
    pad)."""
    rng = np.random.default_rng([int(seed), spec.requests, len(spec.tenants)])
    vocab = max(2, int(vocab))
    n_conv = max(1, spec.requests // spec.turns)
    starts = _conv_starts(spec, n_conv, rng)
    weights = _tenant_weights(spec)
    mix = (
        np.asarray(spec.prompt_mix, np.float64)
        if spec.prompt_mix else np.ones(len(spec.prompt_lens))
    )
    mix = mix / mix.sum()

    out: list[ScheduledRequest] = []
    budget = spec.requests
    for conv in range(n_conv):
        tenant = spec.tenants[int(rng.choice(len(spec.tenants), p=weights))]
        base_len = int(spec.prompt_lens[int(rng.choice(len(spec.prompt_lens), p=mix))])
        prompt = tuple(int(t) for t in rng.integers(1, vocab, base_len))
        for turn in range(spec.turns):
            if budget <= 0:
                break
            budget -= 1
            if turn > 0:
                suffix = tuple(
                    int(t) for t in rng.integers(1, vocab, spec.turn_suffix_tokens)
                )
                prompt = prompt + suffix
            out.append(ScheduledRequest(
                at_s=float(starts[conv] + turn * spec.turn_gap_s),
                tenant=tenant,
                prompt=prompt,
                max_new=spec.max_new,
                temperature=spec.temperature,
                conv=conv,
                turn=turn,
            ))
    # leftover budget (requests not divisible by turns): extra single-turn
    # conversations riding the tail of the start sequence, never dropped
    # silently: a 25-request spec yields 25 requests
    extra = 0
    while budget > 0:
        budget -= 1
        extra += 1
        tenant = spec.tenants[int(rng.choice(len(spec.tenants), p=weights))]
        plen = int(spec.prompt_lens[int(rng.choice(len(spec.prompt_lens), p=mix))])
        out.append(ScheduledRequest(
            at_s=float(starts[-1] + extra * (1.0 / spec.rate_rps)),
            tenant=tenant,
            prompt=tuple(int(t) for t in rng.integers(1, vocab, plen)),
            max_new=spec.max_new,
            temperature=spec.temperature,
            conv=n_conv - 1 + extra,
            turn=0,
        ))
    out.sort(key=lambda r: (r.at_s, r.conv, r.turn))
    return [replace(r, index=i) for i, r in enumerate(out)]
