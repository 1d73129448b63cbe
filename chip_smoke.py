#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``tfservingcache_tpu_torch``).

Drives the port's main path on one NVIDIA GPU and checks every kernel on it:

  1. environment — torch/CUDA versions, the card (nvidia-smi), g++'s version
     (the native host tier's compiler), which optional packages exist
     (information only); the card asked first from a child process with a
     deadline (``utils/backend_probe.backend_answers``); exits non-zero,
     with the probe's diagnostic, without a CUDA device, and outside a
     checkout of the repo;
  2. build — compiles every kernel in ``tfservingcache_tpu_torch/ops/csrc``
     with nvcc, one process per source, all started together; prints ptxas's
     registers, spills and warnings, and checks that the bf16 flash and
     carry kernels' SASS holds wgmma (HGMMA) and TMA loads (UTMALDG), that
     the paged kernels' SASS holds cp.async (LDGSTS) and mma.sync (HMMA),
     and that the built paged and carry kernels use no local memory (no
     spills: ``cuobjdump -res-usage``);
  3. kernels — each kernel against its plain PyTorch version on the card at
     the main paths' shapes and a few edge shapes, with the stated
     tolerance; CUDA-event times (warm, median), the least time the card
     could take (bound), and one PyTorch library call's time as a yardstick:
     flash attention in bf16 and f32, paged decode attention over bf16,
     int8 and f32 arenas, paged verify attention at T in {1, 5, 9, 256}
     (with its T = 1 gap to the decode kernel) and at the chunked-prefill
     shape (one lane, T = 256 from starts 0, 256 and 768, bf16 / int8 / f32
     pages), each paged row with the page-axis split the wrappers chose,
     and the ring-attention carry
     step from a carried state at the ring phase's hop (a past block, the
     diagonal, a future block that must leave the carry bit-identical), GQA,
     ragged lengths down to 1 and f32; every kernel also at head_dim 32
     (the LM families' default: B2 bf16 and f32, B1 and B3 over bf16 and
     int8 pages, B4's past hop and diagonal) and B2 at the moe phase's
     attention (2, 12, 12, 1024, 64); then the 4-shard ring on one card
     against the plain attention, timed beside the flash kernel and SDPA,
     and the carry kernel's gap to the flash kernel (two kernels of one
     design: within ATTN_TOL); B1 and B2 at their table shapes also timed
     by ``utils/benchtime.chained_device_time`` (chains captured as CUDA
     graphs), its estimate and ``dominated`` flag beside the CUDA-event
     time;
  4. artifact — writes a random-weight transformer_lm artifact at the full
     llama-7b width (depth cut, see --layers) into a temporary store, two
     drafts (an exact copy under another name, and a 1-layer model from the
     target's embed, layer 0 and ln_f), and the same weights under
     ``"attention": "ring"``;
  5. serve — builds a cache node on ``cuda`` through ``server.build_node``
     (what ``cli serve`` calls) and sends REST ``:predict`` requests over
     localhost: cold, then warm. Every response is checked (HTTP 200, shape,
     finite, agreement with the plain path on the card), and the flash
     kernel's launch counter must show the path went through it (every
     request's forward and the load's warm-up forward); each reply is the
     native encoder's body of its logits byte for byte, timed beside
     ``json.dumps``;
  6. batch — the batchers (``serving.batch_window_ms``) on the same artifact
     and disk cache, over the native host tier (``native_available()``):
     16 closed-loop clients post 128 seeded, distinct (1, 128) ``:predict``
     requests to a node with batching off, then to one with
     ``batch_window_ms`` 1 and ``batch_max_size`` 64, off/on/off/on. Each
     arm logs QPS, p50, the runtime's device calls and rows, the coalesced
     batches; flash launches = n_layers x device calls, fewer device calls
     than requests with batching on, and every answer passes the serve
     phase's logits check. Then 8 concurrent unseeded greedy ``:generate``
     requests (prompts 96-128, 32 new) on the batching node's coalescer
     and a seeded one: at least one coalesced batch of 2 or more, the
     seeded request solo, every token passing the teacher-forced check, no
     paged or verify launch, and the scrape's
     ``tpusc_coalesced_requests_total{kind="generate"}`` equal to the
     coalescer's count;
  7. surface — the serving surface on the same disk cache: half_plus_two
     (BASELINE.json config #1) ``:predict`` and ``:regress`` through
     /versions/1 and /labels/stable, exactly 0.5 x + 2; the artifact mapped
     as ``version_labels`` {llama7b: {canary: 1}} on a continuous paged node:
     warm (1, 128) ``:predict`` through /labels/canary (the serve phase's
     logits check), 4 greedy ``:generate`` requests through the label, token
     for token those of /versions/1 (and within the teacher-forced check),
     an unmapped label's 412, with the flash kernel's launches = n_layers x
     labelled predicts and the paged kernel's = n_layers x the engine's
     decode steps; then 10 mnist_cnn tenants (BASELINE.json config #2, seeds
     0-9) on a node that holds 3: 3 round-robin rounds of ``:classify`` (8
     images each, flat tf.Example features), every round reloading every
     tenant (the manager's reload and eviction counts printed), scores within
     2**-7 of the plain forward, cold / reload / warm p50s. Where ``grpc``
     and ``google.protobuf`` import, the same requests go over Predict
     (``version_label``), GenerateStream, Regress and Classify and must equal
     the REST replies; elsewhere one line says that gRPC was not driven;
  8. tier — the pipelined cold load and the host RAM tier on the serve
     phase's disk cache, with the artifact and its exact copy ``copy``: both
     loaded with ``cold_load_pipeline: false`` (``copy`` fetched into the
     disk cache), then pipelined, each load's stages and page-locked memory
     printed; then a pipelined node whose device holds one model and whose
     ``cache.host_tier_bytes`` holds both runs llama7b, copy (disk loads,
     each evicting the other to the tier), llama7b, copy (promotions), a
     (1, 128) ``:predict`` a step: ``tpusc_reload_source`` must count disk 2
     and host 2 and nothing else, each promoted reply must be its disk
     load's byte for byte and pass the serve phase's logits check, and the
     flash kernel's launches must be n_layers x 6 (4 requests + the disk
     loads' 2 warm-up forwards; a promotion runs none). Printed beside the
     card's name and power limit: every load's stages, the copies' GB/s,
     the overlap ratio, the page-locked staging and peaks (the caching host
     allocator's and the tier chunks'). Then half_plus_two and two mnist_cnn
     tenants through a tier of their own (store 3, host 3; promoted replies
     their first loads' byte for byte), and ``copy`` promoted three times
     and loaded from disk once while llama7b (4, 2048) ``:predict`` runs
     back to back on a client thread: every reply of both models must be
     its quiet run's byte for byte;
  9. quant — int8 artifacts: the artifact's weights written again with
     ``save_artifact(quantize="int8")`` as ``llama7b_int8`` (every weight of
     two or more axes and >= 65536 elements as int8 + per-output-channel f32
     scales), its bytes beside the bf16 artifact's; a plain module on the
     card from the host-dequantized weights. On the serve phase's disk
     cache: serialized and pipelined nodes cold-load llama7b and the int8
     model (each load's stages: transfer, ``device_dequant``, total, and the
     caching host allocator's fresh page-locked blocks), the two int8
     replies equal byte for byte; int8 ``:predict`` at (1, 128) and
     (2, 1024) held by the serve phase's logits check to the plain module;
     4 greedy 32-token ``:generate`` requests on a continuous paged node,
     every token held to the teacher-forced check, paged launches =
     n_layers x decode steps; a node with a host tier holding both models
     loads int8 and bf16 from disk and promotes int8, bf16, int8: reload
     sources disk 2 / host 3, every promoted reply its disk load's byte for
     byte, the int8 entry's bytes and each promotion's stages printed beside
     the bf16 model's. Flash launches = n_layers x (requests + the disk
     loads' warm-ups) on every predict node. The int8 artifact and its
     disk-cache copy are deleted at the end;
  10. generate — REST ``:generate`` on the same artifact in eighteen arms: (a)
     the continuous paged engine over a bf16 arena, 16 concurrent greedy
     requests plus a top_k=1 sampled one; (b) the solo path, two seeded
     sampled requests; (c) the continuous engine over an int8 arena; (d)
     (a) with speculative rounds drafted by the exact copy (>= 0.8 x
     (spec + 1) tokens per lane-round, tokens as (a)'s up to near-ties);
     (e) (c) with rounds drafted by the 1-layer draft; (f) two solo
     ``"draft_model"`` requests; (g) (d) over an int8 arena, on 8 of the
     prompts, so that accepted int8 verify rows decide served tokens (the
     1-layer draft of (e) has every proposal rejected, which leaves only
     position 0 of each verify pass served); (h) (a) with chunked prefill
     (``prefill_chunk_tokens`` 256: B3 at T = 256 on one lane, a chunk per
     boundary), tokens as (a)'s up to near-ties; (i) the same over an int8
     arena on 8 prompts, as (c)'s; (j) a 512-token system prompt before 16
     distinct suffixes, then 2 exact repeats, with ``kv_share_prefix_bytes``
     (shared pages, suffix-only prefills, exact hits with no prefill), then
     the same prompts with sharing off, tokens equal up to near-ties, a full
     reclaim of the index's pages after the drain; (k) the solo path's
     prefix cache (``prefix_cache_bytes``) on a "coalesce" node: two-turn
     conversations, plain and ``"draft_model"``, turn 2 hitting turn 1's
     entry, against a cache-off node; (l) two-turn conversations from 8
     clients with the conversation tier (``conversation_kv_bytes`` 256 MiB
     over a 2 GiB disk level): every turn 2 resumes from its parked turn 1
     (some from disk), prefilling only its new suffix + 1 token, the
     resumed pages equal the parked ones bit for bit; (l0) the same prompts
     with the tier off, tokens equal up to near-ties; (l1) (l) again on a
     fresh node without the park watch (its device copies, synchronize and
     page compares), for the turn-2 latency and the scheduler thread's
     seconds in parks and resumes; (l8) 4 conversations over an int8 arena; (m) priority: 8 "low" rows fill a 160-page arena,
     2 "high" rows arrive after the first chunk, are admitted before every
     queued low row and preempt (park) a low lane, whose tokens equal an
     uncontended node's (m0) up to near-ties; (n) ``?stream=true``: 4
     engine streams, a seeded and a ``"draft_model"`` stream, each a frame
     a token + a done frame equal to the buffered answer, a 2-row stream
     refused; (o) ``kill_engine`` after 6 boundaries under 8 requests (one
     streamed) on the (n) node and, as the conversations' third turns, on
     the (l) node: every row answers, equal to an unkilled run up to
     near-ties, recovered = rows in flight + queued, and on (l) every
     admission resumes from the parked turn 2. Every response is checked
     against the plain path on the card (teacher-forced logits), the page
     census must be green after each arm (both arenas with a draft, the
     index's holds counted) with no park failure, and the kernels' launch
     counters must equal what the engine ran in each continuous arm (paged
     = n_layers x plain decode steps + draft layers x (spec + 1) x spec
     rounds, verify = n_layers x (spec rounds + prefill chunks), the chunks
     also counted from the prompts) and stay 0 on the solo paths;
  11. observe — the observability layer on a served continuous node (the
     shared disk cache of arms (l)-(o)), configured as ``cli serve``
     configures it (``server.configure_observability``): after a warm-up,
     the recorder and the ledger are reset, then arm (a)'s schedule (16
     requests x 64 tokens from 8 clients) and 4 ``:predict`` requests. The
     scrape (parsed here with the standard library) must count exactly those
     requests, with ``gen_kv_pages_used`` back at 0; ``/monitoring/engine``
     must hold one row with a chunk per chunk the engine dispatched, and the
     paged kernel's launches must be n_layers x the rows' summed chunk;
     ``/monitoring/tenants`` must attribute every emitted token; and there
     is a ``rest`` trace root per request. Then ``POST
     /monitoring/profiler?duration_s=2&label=smoke`` runs during a second
     burst with a ``:predict`` inside the window: its Chrome trace must name
     the paged decode kernel and the flash kernel, and each
     ``tpusc.decode_chunk`` range's kernels give one chunk's device time,
     printed beside the recorder's ``step_ms`` p50 / p90 of the first burst;
     the trace is deleted after the check. The burst's tok/s is printed
     beside arm (a)'s;
  12. cluster — the router and cluster plane: three continuous paged nodes
     on the card, each with a ``Router`` over static discovery (ports 0,
     127.0.0.1). (A) one replica a key: 6 warm (1, 128) ``:predict`` through
     every router, each reply byte for byte the ring owner's direct reply and
     within the serve phase's logits check, every forward on the owner (flash
     launches = n_layers x (its forwards + the load's warm-up)), local against
     forwarded p50, and a gRPC Predict through a non-owner router equal to the
     REST reply; (B) conversation X's two turns through a router, and
     conversation Y's turn 1 on the owner fetched by the key's second replica
     over ``FetchParkedConversation``, adopted, and its turn 2 served there:
     a suffix + 1 prefill, X's turn-2 tokens (up to near-ties),
     ``migrations_in`` 1, paged launches = n_layers x that node's decode
     steps; the migrated bytes, fetch and adopt times; (C) two replicas a
     key, the owner closed: 8 ``:generate`` requests pinned to it through the
     third node's router all answered by the second replica, the closed
     peer's health in ``/monitoring/cluster`` below the threshold, rendered
     by tools/fleet_top.py;
  13. ring — REST ``:predict`` of the ring artifact on a ``CacheNode``
     around ``TorchModelRuntime(devices=[cuda:0] * 4)`` (one card runs the
     group's four shards one after another): cold, then warm, at (1, 4096)
     (1024 rows a shard), (2, 1024), (1, 300) (pads to 512) and (1, 2)
     (bucket 2: no ring divides it, so the flash kernel runs). Every answer
     is checked against the plain single-device path; the carry kernel's
     launches must be n_layers x 16 a ring request and the flash kernel's
     n_layers a fall-through request (+ the load's warm-up forward). One
     warm (1, 4096) forward is profiled beside the one-card "auto" model's;
  14. peer — peer model adoption over ``FetchPackedModel``: a sender node in
     a process of its own (on the serve phase's disk cache, a host tier that
     holds the artifact) answers a (1, 128) ``:predict``, a greedy
     ``:generate`` and an mnist ``:classify`` once; a receiver node in this
     process (``cluster.peer_fetch``, a Router over static discovery of
     both) then serves (a) the artifact cold from the sender's tier:
     ``reload_source`` peer 1 and no other load, the reply and the tokens
     the sender's (and within the plain-path checks), flash launches =
     n_layers (a promotion runs no warm-up), paged = n_layers x decode
     steps; the wire's bytes and rate, the entry's rebuild, the promotion
     and the first reply printed apart; (b) mnist with ``corrupt_peer_chunk``
     armed once: the chunk's hash fails, the store serves it, the reply the
     sender's; (c) mnist from a stdlib fake S3 endpoint over the artifact
     store through ``model_provider.type: s3``, the reply the sender's;
  15. moe — the moe_lm family on a store and disk cache of its own (deleted
     at the end): a random-weight artifact at Switch-Base-8's widths
     (MOE_CONFIG), a 2-layer draft of its first layers and the family's
     DEFAULT_CONFIG (head_dim 32), on one node. :predict at (1, 128) cold,
     then warm at (1, 128), (2, 512) and (4, 1024): flash launches =
     n_layers x (requests + the load's warm-up), every reply finite and,
     where the plain path routes the checked token away from a tie
     (MOE_ROUTER_TIE, MOE_SLOT_SLACK), within the serve phase's logits
     check; a forward and a decode step against their kernels' device
     time; seeded greedy :generate at B = 1 and 2 (two calls identical, no
     flash launch, each first token the argmax of a full forward at the
     padded shape); a speculative :generate with the draft (tokens,
     acceptance, the positions that differ from the plain run); the
     default-config model's :predict through B2 at head_dim 32 (launches =
     its n_layers x (requests + 1), the same logits check);
  16. zoo — the per-tenant classifier families on a store and disk cache of
     their own (deleted at the end), f32 artifacts of random weights: bert
     at bert-base's widths as two tenants and a third at max_seq 384, resnet
     at ResNet-50's as two tenants, on one node of two resident models, so
     that the tenants evict one another. bert :predict at (1, 128) cold,
     then warm at (1, 128), (8, 128) and (4, 512); a (1, 100) request against
     the same ids in (1, 128) with a masked tail; on the capped tenant a
     (1, 300) request (pads to 384) answers and a (1, 400) one is refused
     with the reference's 400; a two-example :classify. resnet :predict cold
     at batch 1, then warm at 1, 8 and 32. Every reply's logits within
     ZOO_TOL_FLOOR's rule of the same module's forward on the CPU, argmax
     equal off near-ties; B1-B4 launch 0 times over the phase; 4
     evictions; a warm forward of each family against its kernels' device
     time.
  17. t5 — the encoder-decoder family on a store and disk cache of its own
     (deleted at the end): three tenants written by ``cli export`` on the
     card, one process each, all started together (T5 v1.1-base's widths in
     bf16 and as int8, and the family's DEFAULT_CONFIG); ``cli repack`` of
     the bf16 one byte for byte its source, of the int8 one every leaf bit
     for bit and a second repack byte for byte the first; a node of two
     resident models: :predict at (1, 128/32) cold, then warm at (1, 128/32),
     (4, 512/128) and (8, 300/64) (src 512), a 100-token source bare against
     the same with 60 pad tokens (src buckets 128 / 256) and a 32-token target
     against 33 (tgt buckets 32 / 64), each pair equal on the shared
     positions, one gRPC Predict equal to the REST reply, :generate refused
     with the reference's 400, the int8 and default tenants and a reload (2
     evictions). Every reply's logits within ZOO_TOL_FLOOR's rule of the
     same artifact's CPU forward and bit for bit the same module's forward in
     this process on the card at the padded shape; one f32 forward on the
     card held stage by stage (each layer, the gather, the biases, the norms,
     the head) to the CPU's on the same inputs; B1-B4 launch 0 times; a warm
     forward against its kernels, the reply encodes timed; ``cli warm`` on
     t5_base in a process of its own;
  18. lab — the scenario lab (``lab/workload.py``, ``lab/scenario.py``):
     ``default_scenarios(("tenant0", "tenant1"), requests=12, max_new=8)``
     x ``default_faults(0.4)`` (none, kill_engine, freeze_scheduler,
     stall_store, drop_peer), 20 cells, each ``compile_schedule(spec,
     seed=11)`` replayed open loop by ``run_cell`` against a fresh
     continuous paged engine (4 slots, chunks of 4, pages of 16, 48 pages,
     bf16 arena, B1 on) over one cache manager, disk provider and runtime:
     tenant1 the run's artifact, tenant0 its 1-layer draft, both already in
     the generate arms' disk cache; a warm sweep first; stall_store evicts
     tenant0 so the stall sits on the cold miss; drop_peer feeds a
     FleetView (``peer_health_after``). The phase's disk writes are
     reckoned and printed (under 8 GiB) and held to what the provider
     copied. Every cell: 12 of 12 answered, recovered > 0 in the kill
     cells, a firing in every faulted cell, the census green,
     ``kernel_active`` and B1 launches in [n_layers min, max] x decode
     steps (> 0), no B3; every faulted cell's greedy tokens the no-fault
     cell's or within LOGITS_TOL of the plain path's teacher-forced max,
     and every no-fault cell's tokens held to that check. Each row printed,
     the no-fault cells' TTFT p50 / p95 and tok/s beside the card's name
     and power limit.

The last three lines of standard output are the card's name and power limit
(nvidia-smi), a JSON object with one entry per kernel, and
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
them.

Run from the root of a checkout:  python3 chip_smoke.py [--layers N | --full-depth]
(``TPUSC_PAGECHECK=1`` is set for the run: every paged decode chunk and
speculative round first asserts that no live lane maps the trash page.)
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# |kernel - plain| bound for attention on N(0, 1) inputs: bf16 output
# values reach |x| ~ 4-8, where one bf16 ulp is 1/32; the kernel also
# rounds p to bf16 before p.v where the plain version keeps f32.
ATTN_TOL = 1.0 / 32
# f32 flash kernel vs the plain version: the same f32 math in another
# summation order (TF32 is off for the plain version, see the environment
# phase)
ATTN_TOL_F32 = 1e-4
# |REST logits - plain-path logits| bound at llama-7b width: logits are
# ~N(0, 1); both paths run bf16 matmuls and differ in attention rounding
# (above) through every layer, 32 bf16 ulps at |x| ~ 1.
LOGITS_TOL = 0.125
# the same bound for tokens decoded over an int8 KV arena: an int8 row
# carries a rounding error of up to absmax/254 per element (absmax ~ 3
# sigma for N(0, sigma) rows: ~0.7% rms of the row's scale), about 3.5x the
# relative error of a bf16 row (2**-9 ~ 0.2%); the bound is 4x the bf16 one
LOGITS_TOL_INT8 = 0.5
# paged decode kernel vs its plain version (f32 out): int8 and f32 arenas
# dequantize to the same f32 values on both sides (other summation order);
# a bf16 arena rounds p to bf16 on both sides but at other points of the
# online softmax, a bf16 ulp of p on a convex mix of N(0, 1) rows
PAGED_TOL = {"bfloat16": 2.0**-8, "int8": 1e-4, "float32": 1e-4}

# (B, Hq, Hkv, S, D): the serving path's attention at llama-7b width for the
# request shapes below (seq buckets 128, 1024, 512), a long sequence, a GQA
# width at head_dim 64, a length that is no multiple of a tile, the LM
# families' default head_dim 32 (transformer_lm's GQA) and the moe phase's
# Switch-Base-8 attention at (2, 1024)
KERNEL_SHAPES = [
    (1, 32, 32, 128, 128),
    (16, 32, 32, 128, 128),  # the batch phase's coalesced (1, 128) requests, bucket 16
    (2, 32, 32, 1024, 128),
    (1, 32, 32, 4096, 128),
    (4, 8, 4, 1024, 64),
    (1, 32, 32, 200, 128),
    (2, 8, 4, 1024, 32),
    (2, 12, 12, 1024, 64),
]
MAIN_SHAPE = (2, 32, 32, 1024, 128)  # the largest attention call of the served requests
D32_SHAPE = (2, 8, 4, 1024, 32)  # head_dim 32 in the 64-column tile (the C15 repair)
MOE_KERNEL_SHAPE = (2, 12, 12, 1024, 64)
# f32 inputs take the kernel's f32 instantiation (an f32 artifact's :predict)
KERNEL_SHAPES_F32 = [(1, 8, 8, 256, 128), (2, 8, 4, 1024, 32)]
# paged decode (S lanes, Hq, Hkv, D, page_tokens, max pos): the generate
# phase's occupancy at llama-7b width (8 lanes, prompts up to 1024 + 64 new
# tokens), full max_seq, GQA g = 4, a small page, head_dim 64
PAGED_SHAPES = [
    (8, 32, 32, 128, 16, 1088),
    (32, 32, 32, 128, 16, 4095),
    (16, 32, 8, 128, 16, 2047),
    (4, 32, 32, 128, 8, 300),
    (8, 16, 16, 64, 16, 500),
    (8, 8, 4, 32, 16, 1088),  # head_dim 32 (transformer_lm's default heads)
]
PAGED_MAIN = PAGED_SHAPES[0]
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores (the paged kernel's FMAs)
# paged verify (S lanes, Hq, Hkv, D, page_tokens, max pos, T, arenas, lane 0
# past its table): the spec rounds of the generate phase (T = spec + 1 = 5)
# and T = 1 / 9 at its occupancy, GQA g = 4, a lane whose pos + T runs past
# its table, and the chunked-prefill shape (T = 256)
_ALL_ARENAS = ("bfloat16", "int8", "float32")
VERIFY_SHAPES = [
    (8, 32, 32, 128, 16, 1088, 1, _ALL_ARENAS, False),
    (8, 32, 32, 128, 16, 1088, 5, _ALL_ARENAS, False),
    (8, 32, 32, 128, 16, 1088, 9, _ALL_ARENAS, False),
    (16, 32, 8, 128, 16, 2047, 5, ("bfloat16", "int8"), False),
    (4, 32, 32, 128, 8, 300, 5, ("bfloat16", "int8"), True),
    (8, 32, 32, 128, 16, 1088, 256, ("bfloat16", "int8"), False),
    (8, 8, 4, 32, 16, 1088, 5, ("bfloat16", "int8"), False),  # head_dim 32
]
VERIFY_MAIN = (8, 32, 32, 128, 16, 1088, 5)
# paged verify at the chunked-prefill shape of arms (h)/(i): ONE lane, T =
# PREFILL_CHUNK queries at start = 0, 256, 768 (a 1024-token prompt's first,
# second and last chunk), over bf16, int8 and f32 arenas
PREFILL_CHUNK = 256
PREFILL_KERNEL = (32, 32, 128, 16)  # (Hq, Hkv, D, page_tokens)
PREFILL_STARTS = (0, 256, 768)
# :generate phase: 16 single-row greedy requests from 8 client threads,
# prompt lengths seeded-random in [64, 1024], 64 new tokens each
GEN_REQUESTS = 16
GEN_CLIENTS = 8
GEN_PROMPT_RANGE = (64, 1024)
GEN_NEW_TOKENS = 64
# draft tokens per speculative round in arms (d)-(g)
SPEC_TOKENS = 4
# arm (i), chunked prefill over an int8 arena, runs the first 8 prompts
CHUNKED_INT8_REQUESTS = 8
# arm (j): one seeded system prompt before every request's own suffix, then
# exact repeats of earlier prompts
SHARED_PREFIX_TOKENS = 512
SHARED_SUFFIX_RANGE = (16, 256)
SHARED_REPEATS = 2
SHARE_BYTES = 256 << 20
# arm (k): the solo path's prefix cache, a two-turn conversation (turn 2 =
# turn 1's prompt + its tokens + TURN2_NEW_TOKENS new ones)
PREFIX_CACHE_BYTES = 1 << 30
TURN2_NEW_TOKENS = 32
# arm (g), the exact-copy draft over an int8 arena, runs the first 8 prompts
SPEC_INT8_REQUESTS = 8
# arms (l), (l0), (l8): two-turn conversations from CONV_CLIENTS clients
# (turn 2 = turn 1's prompt + its tokens + CONV_SUFFIX_RANGE new ones) on a
# node with a CONV_KV_BYTES host tier over a CONV_KV_DISK_BYTES disk level;
# (l8) runs the first CONV_INT8_CONVERSATIONS over an int8 arena
CONV_CLIENTS = 8
CONV_PROMPT_RANGE = (256, 1024)
CONV_SUFFIX_RANGE = (32, 128)
CONV_KV_BYTES = 256 << 20
CONV_KV_DISK_BYTES = 2 << 30
CONV_INT8_CONVERSATIONS = 4
# the history a park and a resume are timed at, with its resume suffix
PARK_HISTORY = 1024
PARK_SUFFIX = 32
# arm (m): PRIO_LOW "low" rows fill an arena of PRIO_ARENA_PAGES pages
# (about four of their reservations); PRIO_HIGH "high" rows arrive after the
# first decode chunk
PRIO_LOW, PRIO_LOW_PROMPT, PRIO_LOW_NEW = 8, 512, 128
PRIO_HIGH, PRIO_HIGH_PROMPT, PRIO_HIGH_NEW = 2, 256, 32
PRIO_ARENA_PAGES = 160
# arm (n): single-row streams on the continuous engine
STREAMS = 4
# arm (o): kill_engine after this many scheduler boundaries, under
# KILL_REQUESTS greedy requests in flight
KILL_AFTER = 6
KILL_REQUESTS = 8
# the observe phase: :predict requests beside the burst, the profiler window
OBSERVE_PREDICTS = 4
PROFILE_S = 2.0
# generated tok/s of each continuous arm's burst, by arm name
ARM_TOK_S: dict[str, float] = {}
# :predict request shapes; (1, 300) pads to the 512 bucket
REQUEST_SHAPES = [(1, 128), (2, 1024), (1, 300)]
# the batch phase: BATCH_CLIENTS closed-loop clients, each posting
# BATCH_REQUESTS seeded, distinct BATCH_SHAPE requests, to a node with
# batching off and one with it on (batch_window_ms 1, batch_max_size 64),
# in the arms' order; then BATCH_GEN_REQUESTS concurrent unseeded greedy
# :generate requests (prompts in one 128 bucket) + 1 seeded one
BATCH_CLIENTS = 16
BATCH_REQUESTS = 8
BATCH_SHAPE = (1, 128)
BATCH_ARMS = ("off", "on", "off", "on")
BATCH_GEN_REQUESTS = 8
BATCH_GEN_PROMPT_RANGE = (96, 128)
BATCH_GEN_NEW_TOKENS = 32
# B4 ring hops (B, Hq, Hkv, Sq, Sk, D, dtype, rel), each from a carried
# state: the ring phase's hop at llama-7b width (a (1, 4096) request over 4
# shards: 1024 rows a shard) as a past block, the diagonal and a future
# block; GQA (which the kernel takes though the ring's build does not);
# ragged lengths down to 1; f32
# tier phase: the serve artifact and its exact copy through one resident
# model's budget and a host tier that holds both
TIER_SHAPE = (1, 128)
TIER_SCHEDULE = (("llama7b", "disk"), ("copy", "disk"), ("llama7b", "host"), ("copy", "host"))
# small models through the tier: half_plus_two and two mnist_cnn tenants
# (the surface phase's artifacts), whose chunks of a few bytes to a few MiB
# lie beside each other in host memory
TIER_SMALL = ("hpt", "mnist0", "mnist1")
# loads of ``copy`` while another model serves: llama7b (TIER_BUSY_SHAPE)
# :predict back to back on a client thread
TIER_BUSY_SHAPE = (4, 2048)
TIER_BUSY_LOADS = ("host", "host", "disk", "host")

CARRY_MAIN = (1, 32, 32, 1024, 1024, 128)
CARRY_HOPS = [
    (*CARRY_MAIN, "bfloat16", -1024),
    (*CARRY_MAIN, "bfloat16", 0),
    (*CARRY_MAIN, "bfloat16", 1024),
    (1, 32, 8, 1024, 1024, 128, "bfloat16", 0),
    (1, 32, 32, 64, 64, 128, "bfloat16", 0),
    (1, 32, 32, 64, 64, 128, "bfloat16", -64),
    (1, 32, 32, 1, 1, 128, "bfloat16", 0),
    (1, 32, 32, 1, 1, 128, "bfloat16", -1),
    (1, 8, 8, 256, 256, 128, "float32", 0),
    (1, 8, 8, 256, 256, 128, "float32", -256),
    (1, 8, 8, 1024, 1024, 32, "bfloat16", -1024),  # head_dim 32: a past hop
    (1, 8, 8, 1024, 1024, 32, "bfloat16", 0),      # and the diagonal
]
CARRY_D32 = (1, 8, 8, 1024, 1024, 32)
# |kernel - plain| of the normalized hop output acc / l: bf16 as the paged
# kernels' (both round p to bf16, from f32 p values a few ulps apart and at
# other points of the online softmax); f32: the same f32 math in another
# summation order
CARRY_TOL = {"bfloat16": 2.0**-8, "float32": 1e-4}
# |kernel m - plain m|: f32 scores (~N(0, 1) here) summed in another order,
# and the bf16 body's log2 units converted at both ends: a few dozen f32
# ulps at most
CARRY_M_TOL = 1e-4
# the ring phase: a group of RING_SHARDS copies of the card (one card runs
# the shards one after another), and the request shapes: (1, 4096) is 1024
# rows a shard, (1, 300) pads to 512, and (1, 2)'s bucket of 2 does not
# divide by 4, so it falls through to the flash kernel
RING_SHARDS = 4
RING_DEVICE = "cuda:0"
RING_REQUEST_SHAPES = [(1, 4096), (2, 1024), (1, 300), (1, 2)]
RING_CHAIN = (1, 32, 32, 4096, 128)  # (B, H, Hkv, S, D) of the chained ring on one card
# every phase runs on device 0: the last line's device count
CARDS_USED = 1
RUN_NOTES: dict = {}  # a number one phase keeps for a later phase's line


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "Phase":
        self.t0 = time.monotonic()
        log(f"== phase {self.name}")
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__}: {exc})"
        log(f"== phase {self.name}: {status} in {time.monotonic() - self.t0:.2f}s")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` calls, each between
    its own pair of CUDA events, after ``warmup`` untimed calls. A spin
    kernel queued first keeps the device busy while the host enqueues every
    timed call, so host launch overhead does not enter the device times."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))  # ~0.1 s of device time at H100 clocks
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn()`` in ms (``fn`` ends in a device
    sync), after one untimed call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.monotonic()
        fn()
        times.append((time.monotonic() - t0) * 1e3)
    return statistics.median(times)


def device_kernels(fn) -> dict[str, float]:
    """{kernel name: device ms} of one warm ``fn()`` under ``torch.profiler``
    (empty when the profiler records no device time on this machine)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    # kernel rows only: CPU ops would double-count
    return {row.key: row.self_device_time_total / 1e3 for row in prof.key_averages()
            if row.device_type == torch.autograd.DeviceType.CUDA and row.self_device_time_total > 0}


def device_kernel_ms(fn, matches: tuple[str, ...] = (),
                     kernels: dict[str, float] | None = None) -> tuple[float, list[float]] | None:
    """(sum of device kernel time, [the part in kernels whose name contains
    each of ``matches``]) of one ``fn()`` (or of ``kernels``, a
    ``device_kernels`` result), in ms; None when the profiler records no
    device time on this machine."""
    kernels = device_kernels(fn) if kernels is None else kernels
    if not kernels:
        return None
    return (sum(kernels.values()),
            [sum(ms for name, ms in kernels.items() if m in name) for m in matches])


def device_busy_ms(fn) -> float | None:
    """Sum of device kernel time of one ``fn()`` under ``torch.profiler``
    (None when the profiler records no device time on this machine)."""
    got = device_kernel_ms(fn)
    return None if got is None else got[0]


def attention_bound_ms(b: int, hq: int, hkv: int, s: int, d: int, causal: bool) -> tuple[float, str]:
    """The larger of (operations / bf16 peak) and (bytes / HBM rate). A
    causal call needs half the score matrix: 2*B*Hq*S^2*D flops for the two
    products together; full attention twice that. Bytes: q, k, v read once,
    out written once, bf16."""
    flops = (2 if causal else 4) * b * hq * s * s * d
    nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def carry_bound_ms(b: int, hq: int, hkv: int, sq: int, sk: int, d: int, rel: int,
                   itemsize: int, f32: bool = False) -> tuple[float, str]:
    """The larger of bytes / HBM rate and operations / peak rate for one
    ring hop over THIS hop's mask (row iq sees key ik when iq - ik >= rel).
    Operations: 4*B*Hq*D per visible (query, key) pair (two FMAs each for
    q.k and p.v) over the bf16 tensor-core peak, or the f32 peak for f32
    inputs. Bytes: the q rows that see a key, the K/V rows some row sees,
    and those rows' carry read and written (acc D f32, m and l f32). A
    future block needs nothing."""
    pairs = sum(max(0, min(sk, iq - rel + 1)) for iq in range(sq))
    rows = min(sq, max(0, sq - max(rel, 0)))
    keys = min(sk, max(0, sq - rel))
    flops = 4 * b * hq * d * pairs
    nbytes = (b * hq * rows * d * itemsize + 2 * b * hkv * keys * d * itemsize
              + 2 * b * hq * rows * (d + 2) * 4)
    t_ops = flops / (PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def phase_environment() -> None:
    import torch

    from tfservingcache_tpu_torch.utils.backend_probe import backend_answers

    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    for mod in ("ninja", "aiohttp", "grpc", "yaml", "ml_dtypes"):
        found = importlib.util.find_spec(mod) is not None
        log(f"optional package {mod}: {'present' if found else 'absent'} (not needed)")
    # the card asked from a child process first, with a deadline: a wedged
    # card shows here with its diagnostic, not as a hang further on
    ok, diag = backend_answers(timeout_s=180.0, retries=1)
    log(f"backend probe (child process): {diag}")
    if not ok:
        raise SystemExit(f"chip_smoke: the card did not answer in a child process: {diag}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    # the native host tier's compiler (std::to_chars for floats needs GCC 11+)
    gxx = shutil.which("g++")
    version = "not found" if gxx is None else subprocess.run(
        [gxx, "--version"], capture_output=True, text=True, timeout=60).stdout.splitlines()[0]
    log(f"g++: {version}")
    log(f"device 0: {torch.cuda.get_device_name(0)}; devices: {torch.cuda.device_count()}")
    log(f"nvidia-smi: {nvidia_smi_line()}")
    # plain-version matmuls in full f32 (both TF32 switches off, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sass_counts(lib_path, kernel: str, opcodes: tuple[str, ...]) -> dict[str, int]:
    """How many instructions of each opcode the SASS of every function
    whose name contains ``kernel`` holds (``cuobjdump -sass`` of the built
    library, found beside nvcc)."""
    from tfservingcache_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts = dict.fromkeys(opcodes, 0)
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            for op in opcodes:
                counts[op] += f" {op}" in line
    return counts


def resource_usage(lib_path, kernel: str) -> dict:
    """What ptxas allotted every function whose name contains ``kernel``,
    read from the built library (``cuobjdump -res-usage``, found beside
    nvcc), so it holds whether or not this run compiled it: how many there
    are, the most registers one uses, and the stack frame and local memory
    bytes summed over them, with the functions that have either. A spill
    lives in the stack frame, so 0 stack and 0 local bytes is 0 spills."""
    from tfservingcache_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-res-usage", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    usage = {"functions": 0, "max_registers": 0, "stack_bytes": 0, "local_bytes": 0,
             "with_stack_or_local": []}
    name = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            name = line[len("Function "):].rstrip(":")
            continue
        if name is None or kernel not in name or "REG:" not in line:
            name = None
            continue
        fields = dict(f.split(":", 1) for f in line.split() if ":" in f)
        usage["functions"] += 1
        usage["max_registers"] = max(usage["max_registers"], int(fields["REG"]))
        stack, local = int(fields.get("STACK", 0)), int(fields.get("LOCAL", 0))
        usage["stack_bytes"] += stack
        usage["local_bytes"] += local
        if stack or local:
            usage["with_stack_or_local"].append(name)
        name = None
    return usage


def phase_build() -> dict:
    from tfservingcache_tpu_torch.ops import _build

    paths = _build.build()
    for name, path in paths.items():
        log(f"built {name}: {os.path.relpath(path, ROOT)}")
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                log(f"  ptxas: {line.strip()}")
    # the bf16 flash kernel (B2) is built on wgmma and TMA
    sass = sass_counts(paths["flash_attention"], "flash_fwd_kernel", ("HGMMA", "UTMALDG"))
    log(f"flash_fwd_kernel SASS: {sass} (HGMMA: wgmma, UTMALDG: TMA loads)")
    if not all(sass.values()):
        raise AssertionError(f"flash_fwd_kernel SASS lacks wgmma or TMA: {sass}")
    # the paged kernels (B1, B3) stage K/V with cp.async (LDGSTS) and run
    # mma.sync (HMMA) on bf16 pages, and use no local memory (no spills)
    paged = {}
    for kernel in ("paged_decode_attention_kernel", "paged_verify_attention_kernel"):
        paged[kernel] = sass_counts(paths["paged_attention"], kernel, ("LDGSTS", "HMMA"))
        log(f"{kernel} SASS: {paged[kernel]} (LDGSTS: cp.async, HMMA: mma.sync)")
        if not all(paged[kernel].values()):
            raise AssertionError(f"{kernel} SASS lacks cp.async or mma.sync: {paged[kernel]}")
    usage = resource_usage(paths["paged_attention"], "paged_")
    log(f"paged kernels, registers and local memory (cuobjdump -res-usage): {usage}")
    if not usage["functions"]:
        raise AssertionError("cuobjdump -res-usage reports no paged kernel")
    if usage["stack_bytes"] or usage["local_bytes"]:
        raise AssertionError(f"the paged kernels use local memory (spills): {usage}")
    # the bf16 carry kernel (B4) is built on B2's design (wgmma, TMA), and
    # neither carry kernel (bf16, f32) uses local memory
    carry_sass = sass_counts(paths["flash_attention"], "flash_attention_carry_kernel",
                             ("HGMMA", "UTMALDG"))
    log(f"flash_attention_carry_kernel SASS: {carry_sass} (HGMMA: wgmma, UTMALDG: TMA loads)")
    if not all(carry_sass.values()):
        raise AssertionError(f"flash_attention_carry_kernel SASS lacks wgmma or TMA: {carry_sass}")
    carry_usage = resource_usage(paths["flash_attention"], "flash_attention_carry")
    log(f"carry kernels, registers and local memory (cuobjdump -res-usage): {carry_usage}")
    if not carry_usage["functions"]:
        raise AssertionError("cuobjdump -res-usage reports no carry kernel")
    if carry_usage["stack_bytes"] or carry_usage["local_bytes"]:
        raise AssertionError(f"the carry kernels use local memory (spills): {carry_usage}")
    return {"flash_attention": sass,
            "flash_attention_carry": {**carry_sass, "resources": carry_usage},
            "paged_attention": {**paged, "resources": usage}}


def _benchtime_row(name: str, ms: float, fn, q) -> dict:
    """``utils/benchtime.chained_device_time`` of ``fn(q)`` (chains of
    launches captured as CUDA graphs, a 1-launch chain subtracted), logged
    beside the CUDA-event time ``ms``. The launch counters count each
    capture and no replay, so they are reset here."""
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.utils.benchtime import chained_device_time

    est, dominated = chained_device_time(fn, (q,), return_valid=True)
    for counter in (A.FLASH_LAUNCHES, A.PAGED_LAUNCHES, A.VERIFY_LAUNCHES, A.CARRY_LAUNCHES):
        counter.reset()
    log(f"  {name}: chained_device_time {est * 1e3:.4f}ms (dominated={dominated}) beside "
        f"cuda_ms {ms:.4f}ms ({nvidia_smi_line()})")
    return {"benchtime_ms": est * 1e3, "benchtime_dominated": dominated}


def phase_kernels(seed: int) -> dict:
    import torch
    import torch.nn.functional as F

    from tfservingcache_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    main = None
    rows = {}  # the head_dim-32 and moe rows, as the kernels line reports them
    log(f"flash_attention vs attention_reference, tolerance {ATTN_TOL} (max |diff|)")
    for (b, hq, hkv, s, d) in KERNEL_SHAPES:
        for causal in (True, False):
            q = torch.randn(b, hq, s, d, device="cuda", generator=gen).bfloat16()
            k = torch.randn(b, hkv, s, d, device="cuda", generator=gen).bfloat16()
            v = torch.randn(b, hkv, s, d, device="cuda", generator=gen).bfloat16()
            out = A.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            ref = A.attention_reference(q, k, v, causal)
            err = (out.float() - ref.float()).abs().max().item()
            finite = bool(torch.isfinite(out).all())
            worst = max(worst, err)
            ms = cuda_ms(lambda: A.flash_attention(q, k, v, causal))
            plain_ms = cuda_ms(lambda: A.attention_reference(q, k, v, causal), reps=10, warmup=1)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=hq != hkv))
            bound, bound_by = attention_bound_ms(b, hq, hkv, s, d, causal)
            log(
                f"  B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal}: "
                f"max_abs_err={err:.6g} finite={finite} kernel={ms:.4f}ms "
                f"plain={plain_ms:.4f}ms sdpa={lib_ms:.4f}ms bound={bound:.4f}ms ({bound_by}) "
                f"bound/kernel={bound / ms:.3f}"
            )
            if not finite or not err <= ATTN_TOL:
                raise AssertionError(
                    f"flash_attention disagrees at {(b, hq, hkv, s, d)} causal={causal}: "
                    f"max_abs_err {err} > {ATTN_TOL} or non-finite"
                )
            if (b, hq, hkv, s, d) == MAIN_SHAPE and causal:
                main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": lib_ms,
                        **_benchtime_row("flash_attention", ms, lambda q: A.flash_attention(
                            q, k, v, True), q)}
            for key, at in (("d32", D32_SHAPE), ("moe_shape", MOE_KERNEL_SHAPE)):
                if (b, hq, hkv, s, d) == at and causal:
                    rows[key] = {"shape": list(at), "causal": True, "max_abs_err": err,
                                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                                 "bound_by": bound_by, "library_ms": lib_ms}
            del q, k, v, out, ref
    worst_f32 = 0.0
    log(f"flash_attention f32 vs attention_reference, tolerance {ATTN_TOL_F32} (max |diff|)")
    for (b, hq, hkv, s, d) in KERNEL_SHAPES_F32:
        for causal in (True, False):
            q = torch.randn(b, hq, s, d, device="cuda", generator=gen)
            k = torch.randn(b, hkv, s, d, device="cuda", generator=gen)
            v = torch.randn(b, hkv, s, d, device="cuda", generator=gen)
            out = A.attention(q, k, v, causal)  # the dispatch: f32 passes the gate
            torch.cuda.synchronize()
            ref = A.attention_reference(q, k, v, causal)
            err = (out - ref).abs().max().item()
            worst_f32 = max(worst_f32, err)
            ms = cuda_ms(lambda: A.flash_attention(q, k, v, causal))
            plain_ms = cuda_ms(lambda: A.attention_reference(q, k, v, causal), reps=10, warmup=1)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=hq != hkv))
            flops = (2 if causal else 4) * b * hq * s * s * d
            nbytes = 4 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
            t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
            bound, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
            log(
                f"  f32 B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal}: "
                f"max_abs_err={err:.6g} kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
                f"sdpa={lib_ms:.4f}ms bound={bound:.4f}ms ({bound_by}, f32 FMA peak) "
                f"bound/kernel={bound / ms:.3f}"
            )
            if out.dtype != torch.float32 or not err <= ATTN_TOL_F32:
                raise AssertionError(
                    f"f32 flash_attention disagrees at {(b, hq, hkv, s, d)} causal={causal}: "
                    f"max_abs_err {err} > {ATTN_TOL_F32} (dtype {out.dtype})"
                )
            if d == 32 and causal:
                rows["d32_f32"] = {"shape": [b, hq, hkv, s, d], "causal": True,
                                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                   "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms}
            del q, k, v, out, ref
    torch.cuda.empty_cache()
    return {
        "flash_attention": {
            "name": "flash_attention",
            "route": "cuda",
            "source": "tfservingcache_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "tfservingcache_tpu/ops/attention.py:211",
            "launches": 0,
            "max_abs_err": worst,
            **main,
            "shape": list(MAIN_SHAPE),
            "causal": True,
            "max_abs_err_f32": worst_f32,
            **rows,
        }
    }


def _paged_arena(gen, cgen, lanes, hkv, d, pt, max_pos, t_q=1, overrun=False):
    """A scattered arena (random rows from the card's generator ``cgen``)
    with ragged positions (lane 0 at ``max_pos``, the
    others uniform in [max_pos / 4, max_pos]), each lane's pages at shuffled
    arena slots and its table slots past the live pages on the trash page
    0 (the layout tests/test_paged_kernel.py builds). With T query
    positions a lane's live pages reach pos + T - 1; ``overrun`` sizes the
    tables to max_pos and puts lane 0 where pos + T runs past its table."""
    import torch

    pps = -(-(max_pos + (1 if overrun else t_q)) // pt)
    n_pages = lanes * pps + 1
    tables = (torch.randperm(n_pages - 1, generator=gen) + 1).reshape(lanes, pps).int()
    pos = torch.randint(max_pos // 4, max_pos + 1, (lanes,), generator=gen).int()
    pos[0] = pps * pt - max(1, t_q // 2) if overrun else max_pos
    for s in range(lanes):
        tables[s, -(-(int(pos[s]) + t_q) // pt):] = 0
    kp = torch.randn(n_pages, hkv, pt, d, generator=cgen, device="cuda")
    vp = torch.randn(n_pages, hkv, pt, d, generator=cgen, device="cuda")
    return kp, vp, tables, pos


def paged_bound_ms(pos, hq, hkv, d, pt, kv_itemsize, q_itemsize, quantized, t_q=1,
                   max_keys=None, f32=False):
    """The larger of bytes / HBM rate and operations / peak rate for one
    paged attention call with T query positions per lane (T = 1: a decode
    step) over THIS run's positions. Bytes: the K/V rows visible to each
    lane's deepest frontier (min(pos + T, max_keys), K and V), their f32
    scales for int8, the table entries read, pos, q and the f32 output.
    Operations: 4*Hq*D per (query, visible key) pair (two FMAs each for q.k
    and p.v) over the bf16 tensor-core peak, or the f32 peak for an f32
    arena. At T = 1 the operations' time is two orders below the bytes'."""
    cap = max_keys if max_keys is not None else float("inf")
    lanes = len(pos)
    rows = sum(min(int(p) + t_q, cap) for p in pos)
    pairs = sum(min(int(p) + t + 1, cap) for p in pos for t in range(t_q))
    nbytes = rows * hkv * d * 2 * kv_itemsize
    if quantized:
        nbytes += rows * hkv * 2 * 4
    nbytes += sum(-(-min(int(p) + t_q, cap) // pt) for p in pos) * 4 + lanes * 4
    nbytes += lanes * hq * t_q * d * (q_itemsize + 4)
    flops = 4 * hq * d * pairs
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / (PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS) * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def paged_plan(A, q, kp, tables) -> list[int]:
    """[n_splits, pages_per_split] of the launch the paged wrappers make
    for these arguments."""
    plan = A.paged_launch_plan(q, kp, tables)
    return [plan["n_splits"], plan["pages_per_split"]]


def phase_paged_kernel(seed: int) -> dict:
    """paged_decode_attention_kernel vs its plain version on the card, for
    bf16 and int8 arenas at every shape and an f32 arena at the first."""
    import torch
    import torch.nn.functional as F

    from tfservingcache_tpu_torch.models.generation import _quantize_kv_rows
    from tfservingcache_tpu_torch.ops import attention as A

    gen = torch.Generator().manual_seed(seed + 1)
    cgen = torch.Generator(device="cuda").manual_seed(seed + 1)
    main = None
    worst = {}
    d32 = {}
    log("paged_decode_attention vs paged_decode_attention (plain), tolerance "
        f"{PAGED_TOL} (max |diff|); yardstick: F.scaled_dot_product_attention on "
        "K/V ALREADY GATHERED to dense (S, Hkv, L, D) with a boolean mask, the "
        "gather excluded (no single PyTorch call computes paged attention)")
    for shape in PAGED_SHAPES:
        lanes, hq, hkv, d, pt, max_pos = shape
        kp32, vp32, tables_h, pos_h = _paged_arena(gen, cgen, lanes, hkv, d, pt, max_pos)
        q32 = torch.randn(lanes, hq, 1, d, generator=cgen, device="cuda")
        arenas = ["bfloat16", "int8"] + (["float32"] if shape == PAGED_MAIN else [])
        tables, pos = tables_h.cuda(), pos_h.cuda()
        for arena in arenas:
            ks = vs = None
            if arena == "int8":
                q = q32.bfloat16()
                kp, ks = _quantize_kv_rows(kp32)
                vp, vs = _quantize_kv_rows(vp32)
                plain_k, plain_v = A.dequantize_pages(kp, ks), A.dequantize_pages(vp, vs)
                kv_item, dense_dt = 1, torch.bfloat16
            else:
                dt = getattr(torch, arena)
                q, kp, vp = q32.to(dt), kp32.to(dt), vp32.to(dt)
                plain_k, plain_v = kp, vp
                kv_item, dense_dt = kp.element_size(), dt
            out = A.paged_decode_attention_kernel(q, kp, vp, tables, pos, ks, vs, page_tokens=pt)
            torch.cuda.synchronize()
            ref = A.paged_decode_attention(q, plain_k, plain_v, tables, pos, pt)
            err = (out - ref).abs().max().item()
            finite = bool(torch.isfinite(out).all())
            worst[arena] = max(worst.get(arena, 0.0), err)
            ms = cuda_ms(lambda: A.paged_decode_attention_kernel(
                q, kp, vp, tables, pos, ks, vs, page_tokens=pt))
            plain_ms = cuda_ms(lambda: A.paged_decode_attention(
                q, plain_k, plain_v, tables, pos, pt), reps=5, warmup=1)
            # yardstick: SDPA over K/V gathered to dense beforehand (excluded)
            kd = A.paged_gather_kv(plain_k, tables, pt).to(dense_dt)
            vd = A.paged_gather_kv(plain_v, tables, pt).to(dense_dt)
            mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
                    <= pos.long()[:, None])[:, None, None, :]
            qd = q.to(dense_dt)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask, enable_gqa=hq != hkv))
            bound, bound_by = paged_bound_ms(pos_h.tolist(), hq, hkv, d, pt, kv_item,
                                             q.element_size(), arena == "int8",
                                             f32=arena == "float32")
            splits = paged_plan(A, q, kp, tables)
            log(
                f"  S={lanes} Hq={hq} Hkv={hkv} D={d} pt={pt} max_pos={max_pos} "
                f"(live rows {int(pos_h.sum()) + lanes}) {arena} splits={splits}: "
                f"max_abs_err={err:.6g} "
                f"finite={finite} kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
                f"sdpa_on_gathered={lib_ms:.4f}ms bound={bound:.4f}ms ({bound_by}) "
                f"bound/kernel={bound / ms:.3f}"
            )
            if not finite or not err <= PAGED_TOL[arena]:
                raise AssertionError(
                    f"paged_decode_attention disagrees at {shape} {arena}: max_abs_err "
                    f"{err} > {PAGED_TOL[arena]} or non-finite"
                )
            if shape == PAGED_MAIN and arena == "bfloat16":
                main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": lib_ms, "splits": splits,
                        **_benchtime_row("paged_decode_attention", ms,
                                         lambda q: A.paged_decode_attention_kernel(
                                             q, kp, vp, tables, pos, page_tokens=pt), q)}
            if d == 32:
                d32[arena] = {"shape": list(shape), "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                              "library_ms": lib_ms, "splits": splits}
            del out, ref, kd, vd, kp, vp, plain_k, plain_v
        del kp32, vp32
        torch.cuda.empty_cache()
    return {
        "paged_decode_attention": {
            "name": "paged_decode_attention",
            "route": "cuda",
            "source": "tfservingcache_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "tfservingcache_tpu/ops/attention.py:705",
            "launches": 0,
            "max_abs_err": max(worst.values()),
            **main,
            "library_note": "SDPA on K/V already gathered to dense, gather excluded",
            "shape": list(PAGED_MAIN),
            "arena": "bfloat16",
            "max_abs_err_by_arena": worst,
            "d32": d32,
        }
    }


def phase_verify_kernel(seed: int) -> dict:
    """paged_verify_attention_kernel (B3) vs its plain version on the card
    at every VERIFY_SHAPES row; at T = 1 also its gap to the decode kernel
    (B1) on the same inputs (one body: 0 expected)."""
    import torch
    import torch.nn.functional as F

    from tfservingcache_tpu_torch.models.generation import _quantize_kv_rows
    from tfservingcache_tpu_torch.ops import attention as A

    gen = torch.Generator().manual_seed(seed + 3)
    cgen = torch.Generator(device="cuda").manual_seed(seed + 3)
    main = None
    worst = {}
    d32 = {}
    t1_gap = 0.0
    log("paged_verify_attention vs paged_verify_attention (plain), tolerance "
        f"{PAGED_TOL} (max |diff|); yardstick: F.scaled_dot_product_attention on "
        "K/V ALREADY GATHERED to dense (S, Hkv, L, D) with a boolean (T, L) mask per "
        "lane, the gather excluded")
    for (lanes, hq, hkv, d, pt, max_pos, t_q, arenas, overrun) in VERIFY_SHAPES:
        shape = (lanes, hq, hkv, d, pt, max_pos, t_q)
        kp32, vp32, tables_h, pos_h = _paged_arena(gen, cgen, lanes, hkv, d, pt, max_pos,
                                                   t_q=t_q, overrun=overrun)
        q32 = torch.randn(lanes, hq, t_q, d, generator=cgen, device="cuda")
        tables, pos = tables_h.cuda(), pos_h.cuda()
        max_keys = tables_h.shape[1] * pt
        for arena in arenas:
            ks = vs = None
            if arena == "int8":
                q = q32.bfloat16()
                kp, ks = _quantize_kv_rows(kp32)
                vp, vs = _quantize_kv_rows(vp32)
                plain_k, plain_v = A.dequantize_pages(kp, ks), A.dequantize_pages(vp, vs)
                kv_item, dense_dt = 1, torch.bfloat16
            else:
                dt = getattr(torch, arena)
                q, kp, vp = q32.to(dt), kp32.to(dt), vp32.to(dt)
                plain_k, plain_v = kp, vp
                kv_item, dense_dt = kp.element_size(), dt
            out = A.paged_verify_attention_kernel(q, kp, vp, tables, pos, ks, vs, page_tokens=pt)
            torch.cuda.synchronize()
            ref = A.paged_verify_attention(q, plain_k, plain_v, tables, pos, pt)
            err = (out - ref).abs().max().item()
            finite = bool(torch.isfinite(out).all())
            worst[arena] = max(worst.get(arena, 0.0), err)
            gap = ""
            if t_q == 1:
                b1 = A.paged_decode_attention_kernel(q, kp, vp, tables, pos, ks, vs, page_tokens=pt)
                torch.cuda.synchronize()
                g1 = (out - b1).abs().max().item()
                t1_gap = max(t1_gap, g1)
                gap = f" |B3 - B1|={g1:.3g}"
            ms = cuda_ms(lambda: A.paged_verify_attention_kernel(
                q, kp, vp, tables, pos, ks, vs, page_tokens=pt))
            plain_ms = cuda_ms(lambda: A.paged_verify_attention(
                q, plain_k, plain_v, tables, pos, pt), reps=5, warmup=1)
            kd = A.paged_gather_kv(plain_k, tables, pt).to(dense_dt)
            vd = A.paged_gather_kv(plain_v, tables, pt).to(dense_dt)
            q_pos = pos.long()[:, None] + torch.arange(t_q, device="cuda")[None, :]
            mask = (torch.arange(kd.shape[2], device="cuda")[None, None, :]
                    <= q_pos[:, :, None])[:, None]                         # (S, 1, T, L)
            qd = q.to(dense_dt)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask, enable_gqa=hq != hkv))
            bound, bound_by = paged_bound_ms(pos_h.tolist(), hq, hkv, d, pt, kv_item,
                                             q.element_size(), arena == "int8", t_q=t_q,
                                             max_keys=max_keys, f32=arena == "float32")
            splits = paged_plan(A, q, kp, tables)
            log(
                f"  S={lanes} Hq={hq} Hkv={hkv} D={d} pt={pt} max_pos={max_pos} T={t_q}"
                f"{' (lane 0 past its table)' if overrun else ''} {arena} splits={splits}: "
                f"max_abs_err={err:.6g} finite={finite}{gap} kernel={ms:.4f}ms "
                f"plain={plain_ms:.4f}ms sdpa_on_gathered={lib_ms:.4f}ms "
                f"bound={bound:.4f}ms ({bound_by}) bound/kernel={bound / ms:.3f}"
            )
            if not finite or not err <= PAGED_TOL[arena]:
                raise AssertionError(
                    f"paged_verify_attention disagrees at {shape} {arena}: max_abs_err "
                    f"{err} > {PAGED_TOL[arena]} or non-finite"
                )
            if shape == VERIFY_MAIN and arena == "bfloat16":
                main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": lib_ms, "splits": splits}
            if d == 32:
                d32[arena] = {"shape": list(shape), "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                              "library_ms": lib_ms, "splits": splits}
            del out, ref, kd, vd, kp, vp, plain_k, plain_v
        del kp32, vp32
        torch.cuda.empty_cache()
    log(f"paged_verify_attention at T = 1 vs paged_decode_attention (B1), same inputs: "
        f"max |diff| {t1_gap:.3g} (one body)")
    return {
        "paged_verify_attention": {
            "name": "paged_verify_attention",
            "route": "cuda",
            "source": "tfservingcache_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "tfservingcache_tpu/ops/attention.py:945",
            "launches": 0,
            "max_abs_err": max(worst.values()),
            **main,
            "library_note": "SDPA on K/V already gathered to dense with a (T, L) mask, "
                            "gather excluded",
            "shape": list(VERIFY_MAIN),
            "arena": "bfloat16",
            "max_abs_err_by_arena": worst,
            "t1_gap_to_paged_decode": t1_gap,
            "d32": d32,
        }
    }


def phase_prefill_kernel(seed: int) -> list[dict]:
    """paged_verify_attention_kernel (B3) at the chunked-prefill shape: one
    lane, T = PREFILL_CHUNK queries at each of PREFILL_STARTS, bf16 / int8 /
    f32 pages, against its plain version at PAGED_TOL (bf16: times the
    largest |v|, see below), with its time, the
    plain version's, SDPA on K/V gathered to dense with the (T, L) mask
    (gather excluded), the bound and the split the wrappers chose. -> one
    record per row."""
    import torch
    import torch.nn.functional as F

    from tfservingcache_tpu_torch.models.generation import _quantize_kv_rows
    from tfservingcache_tpu_torch.ops import attention as A

    gen = torch.Generator().manual_seed(seed + 6)
    cgen = torch.Generator(device="cuda").manual_seed(seed + 6)
    hq, hkv, d, pt = PREFILL_KERNEL
    t_q = PREFILL_CHUNK
    rows = []
    log(f"paged_verify_attention at the chunked-prefill shape: 1 lane, Hq={hq} Hkv={hkv} "
        f"D={d} pt={pt} T={t_q}, tolerance {PAGED_TOL}; yardstick as above")
    for start in PREFILL_STARTS:
        pps = (start + t_q) // pt
        n_pages = pps + 1
        tables = (torch.randperm(n_pages - 1, generator=gen) + 1).reshape(1, pps).int().cuda()
        pos = torch.tensor([start], dtype=torch.int32, device="cuda")
        kp32 = torch.randn(n_pages, hkv, pt, d, generator=cgen, device="cuda")
        vp32 = torch.randn(n_pages, hkv, pt, d, generator=cgen, device="cuda")
        q32 = torch.randn(1, hq, t_q, d, generator=cgen, device="cuda")
        for arena in ("bfloat16", "int8", "float32"):
            ks = vs = None
            if arena == "int8":
                q = q32.bfloat16()
                kp, ks = _quantize_kv_rows(kp32)
                vp, vs = _quantize_kv_rows(vp32)
                plain_k, plain_v = A.dequantize_pages(kp, ks), A.dequantize_pages(vp, vs)
                kv_item, dense_dt = 1, torch.bfloat16
            else:
                dt = getattr(torch, arena)
                q, kp, vp = q32.to(dt), kp32.to(dt), vp32.to(dt)
                plain_k, plain_v = kp, vp
                kv_item, dense_dt = kp.element_size(), dt
            out = A.paged_verify_attention_kernel(q, kp, vp, tables, pos, ks, vs, page_tokens=pt)
            torch.cuda.synchronize()
            ref = A.paged_verify_attention(q, plain_k, plain_v, tables, pos, pt)
            err = (out - ref).abs().max().item()
            finite = bool(torch.isfinite(out).all())
            ms = cuda_ms(lambda: A.paged_verify_attention_kernel(
                q, kp, vp, tables, pos, ks, vs, page_tokens=pt))
            plain_ms = cuda_ms(lambda: A.paged_verify_attention(
                q, plain_k, plain_v, tables, pos, pt), reps=5, warmup=1)
            kd = A.paged_gather_kv(plain_k, tables, pt).to(dense_dt)
            vd = A.paged_gather_kv(plain_v, tables, pt).to(dense_dt)
            q_pos = start + torch.arange(t_q, device="cuda")
            mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
                    <= q_pos[:, None])[None, None]                         # (1, 1, T, L)
            qd = q.to(dense_dt)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask))
            bound, bound_by = paged_bound_ms([start], hq, hkv, d, pt, kv_item, q.element_size(),
                                             arena == "int8", t_q=t_q, max_keys=pps * pt,
                                             f32=arena == "float32")
            # bf16 pages: both sides round each p to bf16, at other points,
            # so the gap is up to PAGED_TOL of the largest |v| a row mixes;
            # the 8-lane rows mix hundreds of keys into outputs under 1, but
            # a chunk from start 0 has queries that see a handful of keys
            tol = PAGED_TOL[arena]
            if arena == "bfloat16":
                tol *= max(1.0, plain_v.abs().max().item())
            splits = paged_plan(A, q, kp, tables)
            log(f"  start={start} (keys {start + t_q}) {arena} splits={splits}: "
                f"max_abs_err={err:.6g} (tolerance {tol:.4g}) finite={finite} kernel={ms:.4f}ms "
                f"plain={plain_ms:.4f}ms sdpa_on_gathered={lib_ms:.4f}ms "
                f"bound={bound:.4f}ms ({bound_by}) bound/kernel={bound / ms:.3f}")
            if not finite or not err <= tol:
                raise AssertionError(
                    f"paged_verify_attention disagrees at the prefill shape start={start} "
                    f"{arena}: max_abs_err {err} > {tol} or non-finite")
            rows.append({"start": start, "arena": arena, "max_abs_err": err, "tolerance": tol,
                         "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
                         "bound_by": bound_by, "splits": splits})
            del out, ref, kd, vd, kp, vp, plain_k, plain_v
        del kp32, vp32
        torch.cuda.empty_cache()
    return rows


def _empty_carry(b: int, h: int, s: int, d: int):
    import torch

    from tfservingcache_tpu_torch.ops import attention as A

    return (torch.zeros(b, h, s, d, device="cuda"),
            torch.full((b, h, s, 1), A.NEG_INF, device="cuda"),
            torch.zeros(b, h, s, 1, device="cuda"))


def phase_carry_kernel(seed: int) -> dict:
    """flash_attention_carry (B4) vs its plain version on the card at every
    CARRY_HOPS row, each from a carried state (the plain hop over an earlier
    block every row sees); the future hop must leave the carry bit-identical.
    Then the chained ring on one card (RING_CHAIN over RING_SHARDS shards)
    against attention_reference, timed beside B2 and SDPA at the full shape,
    and B4's gap to B2 (one hop at rel 0 from an empty carry, normalized as
    B2 normalizes): two kernels of one design, held to B2's own ATTN_TOL.
    Every row prints its bound over the kernel's time."""
    import torch
    import torch.nn.functional as F

    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.parallel.ring_attention import ring_attention

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    worst = {}
    worst_m = 0.0
    main = None
    d32 = {}
    log("flash_attention_carry vs flash_attention_carry_reference (plain) from a carried "
        f"state, tolerance {CARRY_TOL} on acc / l and {CARRY_M_TOL} on m (max |diff|); no "
        "PyTorch call computes one hop (library yardstick: the chained ring below)")
    for (b, hq, hkv, sq, sk, d, dt, rel) in CARRY_HOPS:
        dtype = getattr(torch, dt)

        def rnd(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

        q, k, v, k0, v0 = (rnd(b, hq, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d),
                           rnd(b, hkv, sk, d), rnd(b, hkv, sk, d))
        carry = A.flash_attention_carry_reference(q, k0, v0, *_empty_carry(b, hq, sq, d), -sk)
        want = A.flash_attention_carry_reference(q, k, v, *carry, rel)
        got = A.flash_attention_carry(q, k, v, *[t.clone() for t in carry], rel)
        torch.cuda.synchronize()
        err = ((got[0] / got[2].clamp_min(1e-30)) - (want[0] / want[2].clamp_min(1e-30))
               ).abs().max().item()
        m_err = (got[1] - want[1]).abs().max().item()
        blind = max(0, min(rel, sq))  # rows 0 .. rel - 1 see no key of this hop
        kept = all(torch.equal(g[:, :, :blind], c[:, :, :blind]) for g, c in zip(got, carry))
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        worst[dt] = max(worst.get(dt, 0.0), err)
        worst_m = max(worst_m, m_err)
        scratch = [t.clone() for t in carry]  # the timed calls update it in place
        ms = cuda_ms(lambda: A.flash_attention_carry(q, k, v, *scratch, rel))
        plain_ms = cuda_ms(lambda: A.flash_attention_carry_reference(q, k, v, *carry, rel),
                           reps=10, warmup=1)
        bound, bound_by = carry_bound_ms(b, hq, hkv, sq, sk, d, rel, q.element_size(),
                                         f32=dtype == torch.float32)
        share = f"bound/kernel={bound / ms:.3f}" if bound > 0 else "bound 0 (no row sees a key)"
        log(f"  B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} D={d} {dt} rel={rel}: "
            f"max_abs_err={err:.6g} m_err={m_err:.3g} finite={finite} "
            f"blind rows kept={kept} ({blind}) kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
            f"bound={bound:.4f}ms ({bound_by}) {share}")
        if not finite or not err <= CARRY_TOL[dt] or not m_err <= CARRY_M_TOL or not kept:
            raise AssertionError(
                f"flash_attention_carry disagrees at {(b, hq, hkv, sq, sk, d)} {dt} rel={rel}: "
                f"max_abs_err {err} (tolerance {CARRY_TOL[dt]}), m {m_err}, blind rows kept "
                f"{kept}, finite {finite}")
        if blind == sq and not all(torch.equal(g, c) for g, c in zip(got, carry)):
            raise AssertionError(f"the future hop rel={rel} changed the carry")
        if (b, hq, hkv, sq, sk, d) == CARRY_MAIN and dt == "bfloat16" and rel == -sk:
            main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by}
        if (b, hq, hkv, sq, sk, d) == CARRY_D32 and rel == -sk:
            d32 = {"shape": list(CARRY_D32), "rel": rel, "max_abs_err": err, "m_err": m_err,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                   "library_ms": None}
        del q, k, v, k0, v0, carry, want, got, scratch
        torch.cuda.empty_cache()

    # the chained ring on one card against the plain attention, B2 and SDPA
    b, h, hkv, s, d = RING_CHAIN
    q, k, v = (torch.randn(b, n, s, d, device="cuda", generator=gen).bfloat16()
               for n in (h, hkv, hkv))
    before = A.CARRY_LAUNCHES.value
    out = ring_attention(q, k, v, [RING_DEVICE] * RING_SHARDS)
    torch.cuda.synchronize()
    hops = A.CARRY_LAUNCHES.value - before
    ref = A.attention_reference(q, k, v)
    chain_err = (out.float() - ref.float()).abs().max().item()
    del ref
    torch.cuda.empty_cache()
    chain_ms = cuda_ms(lambda: ring_attention(q, k, v, [RING_DEVICE] * RING_SHARDS), reps=10)
    b2_ms = cuda_ms(lambda: A.flash_attention(q, k, v, True), reps=10)
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), reps=10)
    prof = device_kernel_ms(lambda: ring_attention(q, k, v, [RING_DEVICE] * RING_SHARDS),
                            ("flash_attention_carry",))
    b4_ms = None if prof is None else prof[1][0]
    bound, bound_by = attention_bound_ms(b, h, hkv, s, d, True)
    log(f"chained ring on one card: {RING_CHAIN} (B, H, Hkv, S, D) causal over {RING_SHARDS} "
        f"shards: {hops} carry launches, max |ring - attention_reference| = {chain_err:.6g} "
        f"(tolerance {ATTN_TOL}); ring {chain_ms:.4f} ms (its B4 launches "
        f"{'not measured' if b4_ms is None else f'{b4_ms:.4f} ms, torch.profiler'}; the rest "
        f"is shard copies, the carry's set-up and the normalization), B2 {b2_ms:.4f} ms, "
        f"SDPA {sdpa_ms:.4f} ms, attention bound {bound:.4f} ms ({bound_by})")
    if hops != RING_SHARDS**2 or not chain_err <= ATTN_TOL:
        raise AssertionError(f"chained ring: {hops} launches, max_abs_err {chain_err}")
    del q, k, v, out

    # B4's gap to B2: one hop at rel 0 from an empty carry, normalized as
    # B2 normalizes (times the reciprocal of max(l, 1e-30), rounded to bf16)
    b, hq, hkv, s, d = MAIN_SHAPE
    q = torch.randn(b, hq, s, d, device="cuda", generator=gen).bfloat16()
    k = torch.randn(b, hkv, s, d, device="cuda", generator=gen).bfloat16()
    v = torch.randn(b, hkv, s, d, device="cuda", generator=gen).bfloat16()
    acc, _m, l = A.flash_attention_carry(q, k, v, *_empty_carry(b, hq, s, d), 0)
    b4_out = (acc * (1.0 / l.clamp_min(1e-30))).bfloat16()
    b2_gap = (b4_out.float() - A.flash_attention(q, k, v, True).float()).abs().max().item()
    log(f"flash_attention_carry at rel 0 from an empty carry vs flash_attention (B2) at "
        f"{MAIN_SHAPE}: max |diff| {b2_gap:.3g} (tolerance {ATTN_TOL})")
    if not b2_gap <= ATTN_TOL:
        raise AssertionError(f"B4 at rel 0 differs from B2 by {b2_gap} > {ATTN_TOL}")
    del q, k, v, acc, l, b4_out
    torch.cuda.empty_cache()
    return {
        "flash_attention_carry": {
            "name": "flash_attention_carry",
            "route": "cuda",
            "source": "tfservingcache_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "tfservingcache_tpu/ops/attention.py:393",
            "launches": 0,
            "max_abs_err": worst["bfloat16"],
            **main,
            "library_ms": sdpa_ms,
            "library_note": "no PyTorch call computes one hop: SDPA(is_causal) over the whole "
                            f"{list(RING_CHAIN)} (B, H, Hkv, S, D), beside chain_ms (the ring "
                            f"of {RING_SHARDS} shards on one card, {RING_SHARDS ** 2} B4 "
                            "launches) and chain_b2_ms (B2 at that shape)",
            "shape": list(CARRY_MAIN),
            "rel": -CARRY_MAIN[4],
            "max_abs_err_f32": worst["float32"],
            "max_m_err": worst_m,
            "chain_shape": list(RING_CHAIN),
            "chain_ms": chain_ms,
            "chain_b4_ms": b4_ms,
            "chain_b2_ms": b2_ms,
            "chain_max_abs_err": chain_err,
            "b2_gap": b2_gap,
            "d32": d32,
        }
    }


def _post_raw(url: str, data: bytes, timeout: float = 900.0) -> tuple[int, bytes, float]:
    """POST ``data`` (a JSON body already encoded); -> (status, the reply's
    bytes, seconds). Nothing is parsed, so a client costs the server's
    process no JSON work inside a timed window."""
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    return status, raw, time.monotonic() - t0


def _post(url: str, body: dict, timeout: float) -> tuple[int, dict, float]:
    # the client's own JSON parse stays outside the seconds
    status, raw, dt = _post_raw(url, json.dumps(body).encode(), timeout)
    return status, json.loads(raw), dt


class Artifact:
    """The random-weight llama-7b-width artifact both serving phases load,
    and the same weights as a module on the card for the plain path."""

    def __init__(self, layers: int, seed: int) -> None:
        import torch

        from tfservingcache_tpu_torch.models import registry
        from tfservingcache_tpu_torch.models.transformer_lm import LLAMA7B_CONFIG
        from tfservingcache_tpu_torch.types import ModelId

        self.layers = layers
        self.model_id = ModelId("llama7b", 1)
        model_cfg = dict(LLAMA7B_CONFIG, n_layers=layers)
        self.model_cfg = model_cfg
        model_def = registry.build("transformer_lm", model_cfg)
        self.vocab = model_cfg["vocab_size"]
        log(f"transformer_lm at llama-7b width: d_model={model_cfg['d_model']} "
            f"heads={model_cfg['n_heads']} d_ff={model_cfg['d_ff']} vocab={self.vocab}, "
            f"n_layers={layers} (of 32)")
        self.work = tempfile.mkdtemp(prefix="tpusc_chip_smoke_")
        t0 = time.monotonic()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = model_def.init(gen)

        def to_bf16(tree):
            if isinstance(tree, dict):
                return {k: to_bf16(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [to_bf16(v) for v in tree]
            return tree.to(torch.bfloat16)

        params = to_bf16(params)  # the artifact's storage dtype, cast on the card
        self.params = params  # the plain module's tensors (no second copy)
        self.store = os.path.join(self.work, "store")
        registry.save_artifact(os.path.join(self.store, "llama7b", "1"), model_def, params)
        self.nbytes = os.path.getsize(os.path.join(self.store, "llama7b", "1", "params.bin"))
        log(f"wrote random-weight artifact (seed {seed}): {self.nbytes} bytes "
            f"in {time.monotonic() - t0:.2f}s")
        self.plain_model = model_def.make_module(params).eval()  # same weights, plain path
        # two drafts for the speculative arms: an exact copy of the target
        # under another name, and a 1-layer model built from the target's
        # embed, layer 0 and ln_f
        t0 = time.monotonic()
        shutil.copytree(os.path.join(self.store, "llama7b"), os.path.join(self.store, "copy"))
        self.draft_layers = 1
        registry.save_artifact(
            os.path.join(self.store, "layer0", "1"),
            registry.build("transformer_lm", dict(model_cfg, n_layers=self.draft_layers)),
            {"embed": params["embed"], "layers": params["layers"][:self.draft_layers],
             "ln_f": params["ln_f"]},
        )
        log(f"wrote the drafts: 'copy' (the target, {layers} layers) and 'layer0' "
            f"(embed + layer 0 + ln_f) in {time.monotonic() - t0:.2f}s")
        # the same weights under "attention": "ring" for the ring phase
        t0 = time.monotonic()
        self.ring_id = ModelId("llama7b_ring", 1)
        registry.save_artifact(
            os.path.join(self.store, self.ring_id.name, "1"),
            registry.build("transformer_lm", dict(model_cfg, attention="ring")), params)
        log(f"wrote '{self.ring_id.name}' (the same weights, \"attention\": \"ring\") in "
            f"{time.monotonic() - t0:.2f}s")

    def node_config(self, name: str, **serving) -> dict:
        return {
            "serving": {"load_timeout_s": 900.0, "max_concurrent_models": 2, **serving},
            "cache": {"base_dir": os.path.join(self.work, f"cache_{name}"),
                      "disk_capacity_bytes": 4 * self.nbytes},
            "model_provider": {"type": "disk", "base_dir": self.store},
            "cache_node": {"rest_port": 0, "grpc_port": 0},
        }

    def close(self) -> None:
        shutil.rmtree(self.work, ignore_errors=True)


def phase_serve(art: Artifact, seed: int, warm_reps: int, kernels: dict) -> None:
    import numpy as np
    import torch

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.protocol import codec
    from tfservingcache_tpu_torch.server import build_node

    model_id, vocab, layers, plain_model = art.model_id, art.vocab, art.layers, art.plain_model
    node = None
    try:
        cfg = config_from_dict(art.node_config("serve"))
        node = build_node(cfg, device="cuda")
        port = node.start("127.0.0.1")
        url = f"http://127.0.0.1:{port}/v1/models/{model_id.name}/versions/1:predict"
        rng = np.random.default_rng(seed)
        requests = []
        for shape in REQUEST_SHAPES:
            ids = rng.integers(0, vocab, size=shape, dtype=np.int64)
            requests += [(shape, ids, i == 0) for i in range(1 + warm_reps)]

        # --- the main path: counters to 0, REST requests, counters read ----
        A.FLASH_LAUNCHES.reset()
        results = []
        for n, (shape, ids, _first) in enumerate(requests):
            status, body, dt = _post(url, {"instances": ids.tolist()}, timeout=900.0)
            results.append((shape, ids, status, body, dt, n == 0))
        launches = A.FLASH_LAUNCHES.value
        # -------------------------------------------------------------------

        # the cold request's load runs one warm-up forward (seq 1) as well
        expected = layers * (len(requests) + 1)
        log(f"flash_attention launches on the serving path: {launches} "
            f"(n_layers {layers} x ({len(requests)} requests + the load's warm-up "
            f"forward) = {expected})")
        if launches != expected:
            raise AssertionError(f"kernel launch count {launches} != {expected}")
        kernels["flash_attention"]["launches"] = launches

        cold = [dt for *_, dt, is_cold in results if is_cold]
        RUN_NOTES["serve_cold_ms"] = cold[0] * 1e3
        log(f"cold :predict (fetch + load + first request, shape {REQUEST_SHAPES[0]}): "
            f"{cold[0] * 1e3:.1f} ms")
        checked = set()
        for shape in REQUEST_SHAPES:
            rows = [r for r in results if r[0] == shape and not r[5]]
            warm = [r[4] for r in rows]
            log(f"warm :predict {shape}: p50 {statistics.median(warm) * 1e3:.2f} ms "
                f"over {len(warm)} requests (host clock, localhost HTTP, JSON)")
        for shape, ids, status, body, _dt, _cold in results:
            if status != 200:
                raise AssertionError(f":predict {shape} answered {status}: {body}")
            pred = np.asarray(body["predictions"], dtype=np.float32)
            if pred.shape != (shape[0], vocab) or not np.isfinite(pred).all():
                raise AssertionError(f":predict {shape}: predictions {pred.shape}, finite="
                                     f"{bool(np.isfinite(pred).all())}")
            if shape in checked:
                continue
            checked.add(shape)
            padded = _check_logits(plain_model, shape, ids, pred)
            # where a warm request's time goes: the forward on the kernel
            # path (host clock, ends in a sync), the device kernels inside
            # it (profiler), the runtime's whole predict, the reply's JSON
            dev_in = {"input_ids": torch.from_numpy(padded).cuda()}

            def forward():
                with torch.inference_mode():
                    plain_model(dev_in)
                torch.cuda.synchronize()

            fwd_ms = host_ms(forward)
            predict_ms = host_ms(lambda: node.runtime.predict(model_id, {"input_ids": ids}))
            # the reply: the node's bytes against the native encoder's body
            # of the same logits, and both encoders timed on them
            served = _post_raw(url, json.dumps({"instances": ids.tolist()}).encode())[1]
            native_body = codec.encode_predict_json_bytes({"last_token_logits": pred}, True)
            if served != native_body:
                raise AssertionError(f"{shape}: the served body is not the native encoder's")
            native_ms = host_ms(lambda: codec.encode_predict_json_bytes(
                {"last_token_logits": pred}, True))
            dumps_ms = host_ms(lambda: json.dumps({"predictions": pred.tolist()}).encode())
            log(f"  {shape} breakdown: forward {fwd_ms:.2f} ms, runtime.predict (pad + H2D "
                f"+ forward + D2H) {predict_ms:.2f} ms; the {pred.shape} f32 reply: native "
                f"encoder {native_ms:.3f} ms (the served body byte for byte, "
                f"{len(served)} bytes), json.dumps {dumps_ms:.3f} ms")
            busy = device_busy_ms(lambda: plain_model(dev_in))
            if busy is None:
                log(f"  {shape} device busy share: not measured (the profiler saw no device time)")
            else:
                log(f"  {shape} device busy share of the forward: kernels {busy:.2f} ms of "
                    f"{fwd_ms:.2f} ms = {busy / fwd_ms:.3f} (torch.profiler, one forward)")
        log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finally:
        if node is not None:
            node.close()


class _DeviceCalls:
    """Counts a node runtime's ``predict`` or ``generate`` calls and their
    rows (and a generate's seed), through an instance attribute that
    shadows the method."""

    def __init__(self, runtime, method: str) -> None:
        self.runtime, self.method = runtime, method
        self.real = getattr(runtime, method)
        self.lock = threading.Lock()
        self.calls, self.rows, self.seeds = 0, 0, []

    def __enter__(self) -> "_DeviceCalls":
        def counted(model_id, inputs, *a, **kw):
            arr = inputs["input_ids"] if isinstance(inputs, dict) else inputs
            with self.lock:
                self.calls += 1
                self.rows += int(arr.shape[0])
                self.seeds.append(kw.get("seed"))
            return self.real(model_id, inputs, *a, **kw)

        setattr(self.runtime, self.method, counted)
        return self

    def __exit__(self, *exc) -> bool:
        delattr(self.runtime, self.method)
        return False


def phase_batch(art: Artifact, seed: int, kernels: dict) -> None:
    """The batchers on the serve phase's artifact and disk cache: warm
    (1, 128) ``:predict`` from BATCH_CLIENTS closed-loop clients against a
    node with batching off and one with it on, in turns (BATCH_ARMS); then
    concurrent ``:generate`` on the batching node's coalescer. The clients
    share the node's process, as the JAX package's bench clients do, and
    like them read raw bytes in the timed window."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from tfservingcache_tpu_torch import native
    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.server import build_node

    if not native.native_available():
        raise AssertionError("the native host tier is not built: the codec would run json")
    log(f"native host tier: {native.active_path()} ({native.library_path().name}, "
        f"built by g++ from {native.SOURCE.name})")
    model_id, layers, vocab = art.model_id, art.layers, art.vocab
    nodes = {}
    try:
        for arm, window in (("off", 0.0), ("on", 1.0)):
            cfg = config_from_dict(art.node_config(
                "serve", batch_window_ms=window, batch_max_size=64))
            node = build_node(cfg, device="cuda")
            base = f"http://127.0.0.1:{node.start('127.0.0.1')}"
            nodes[arm] = (node, base)
            url = f"{base}/v1/models/{model_id.name}/versions/1:predict"
            # the load and one concurrent round stay out of the arms
            settle = [json.dumps({"instances": [[i + 1] * BATCH_SHAPE[1]]}).encode()
                      for i in range(BATCH_CLIENTS)]
            for data in settle[:1]:
                _post_raw(url, data)
            with ThreadPoolExecutor(max_workers=BATCH_CLIENTS) as pool:
                for status, body, _dt in pool.map(lambda b: _post_raw(url, b), settle):
                    if status != 200:
                        raise AssertionError(f"[batch {arm}] warm-up answered {status}: {body}")
        rng = np.random.default_rng(seed + 12)
        flash_total = 0
        summary = {}
        for turn, arm in enumerate(BATCH_ARMS):
            node, base = nodes[arm]
            url = f"{base}/v1/models/{model_id.name}/versions/1:predict"
            ids = rng.integers(0, vocab, (BATCH_CLIENTS * BATCH_REQUESTS, BATCH_SHAPE[1]))
            bodies = [json.dumps({"instances": ids[i: i + 1].tolist()}).encode()
                      for i in range(len(ids))]
            mb = node.backend._predictor
            b0, r0 = getattr(mb, "batches", 0), getattr(mb, "batched_requests", 0)
            with _DeviceCalls(node.runtime, "predict") as dev:
                # --- the path: counters to 0, the arm's requests, read ----------
                # (the clients read raw bytes: the replies are parsed below)
                A.FLASH_LAUNCHES.reset()
                t0 = time.monotonic()
                with ThreadPoolExecutor(max_workers=BATCH_CLIENTS) as pool:
                    raw = list(pool.map(lambda b: _post_raw(url, b), bodies))
                wall = time.monotonic() - t0
                launches = A.FLASH_LAUNCHES.value
                # ---------------------------------------------------------------
            results = [(status, json.loads(body), dt) for status, body, dt in raw]
            batches = getattr(mb, "batches", 0) - b0
            batched = getattr(mb, "batched_requests", 0) - r0
            lat = sorted(dt * 1e3 for *_, dt in results)
            p50 = statistics.median(lat)
            qps = len(bodies) / wall
            log(f"  [batch {arm}, turn {turn}] {len(bodies)} (1,128) :predict from "
                f"{BATCH_CLIENTS} clients in {wall:.3f} s: {qps:.2f} QPS, p50 {p50:.2f} / p90 "
                f"{lat[int(0.9 * (len(lat) - 1))]:.2f} / max {lat[-1]:.2f} ms (host clock); "
                f"device calls {dev.calls} ({dev.rows / dev.calls:.2f} rows a call), "
                f"coalesced batches {batches} holding {batched} requests"
                f"{f' ({batched / batches:.2f} a batch)' if batches else ''}, flash launches "
                f"{launches} (n_layers {layers} x device calls = {layers * dev.calls})")
            if launches != layers * dev.calls:
                raise AssertionError(f"[batch {arm}] flash launches {launches} != "
                                     f"{layers} x {dev.calls} device calls")
            if dev.rows != len(bodies):
                raise AssertionError(f"[batch {arm}] {dev.rows} rows reached the runtime, "
                                     f"{len(bodies)} were sent")
            if arm == "on" and not dev.calls < len(bodies):
                raise AssertionError(f"[batch on] {dev.calls} device calls for {len(bodies)} "
                                     "requests: nothing coalesced")
            if arm == "off" and dev.calls != len(bodies):
                raise AssertionError(f"[batch off] {dev.calls} device calls != {len(bodies)}")
            flash_total += launches
            for status, body, _dt in results:
                if status != 200:
                    raise AssertionError(f"[batch {arm}] :predict answered {status}: {body}")
            pred = np.asarray([body["predictions"][0] for _s, body, _dt in results], np.float32)
            if pred.shape != (len(bodies), vocab) or not np.isfinite(pred).all():
                raise AssertionError(f"[batch {arm}] predictions {pred.shape}, finite="
                                     f"{bool(np.isfinite(pred).all())}")
            for lo in range(0, len(bodies), BATCH_CLIENTS):  # every answer, 16 at a time
                hi = lo + BATCH_CLIENTS
                _check_logits(art.plain_model, (hi - lo, BATCH_SHAPE[1]), ids[lo:hi], pred[lo:hi])
            summary.setdefault(arm, []).append((qps, p50, dev.calls / len(bodies)))
        for arm, rows in summary.items():
            log(f"  [batch {arm}] QPS {[round(q, 2) for q, _p, _c in rows]}, p50 ms "
                f"{[round(p, 2) for _q, p, _c in rows]}, device calls a request "
                f"{[round(c, 3) for _q, _p, c in rows]} ({nvidia_smi_line()})")
        kernels["flash_attention"]["launches"] += flash_total
        kernels["flash_attention"]["launches_batch_phase"] = flash_total
        _coalesced_generate(art, seed, nodes["on"])
    finally:
        for node, _base in nodes.values():
            node.close()


def _coalesced_generate(art: Artifact, seed: int, node_base) -> None:
    """BATCH_GEN_REQUESTS concurrent unseeded greedy ``:generate`` requests
    (prompts in one bucket, BATCH_GEN_NEW_TOKENS new each) on the batching
    node's coalescer, then a seeded request, which runs solo. Every answer
    passes the teacher-forced check; no paged or verify kernel runs (the
    solo path decodes without one); the scrape counts the coalescer's
    requests."""
    import numpy as np

    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.runtime.batcher import GenerateCoalescer

    node, base = node_base
    gc = node.backend._generator
    if not isinstance(gc, GenerateCoalescer):
        raise AssertionError(f"the batching node's generator is {type(gc).__name__}")
    url = f"{base}/v1/models/{art.model_id.name}/versions/1:generate"
    rng = np.random.default_rng(seed + 13)
    prompts = [rng.integers(1, art.vocab, int(n)).astype(np.int32)
               for n in rng.integers(BATCH_GEN_PROMPT_RANGE[0], BATCH_GEN_PROMPT_RANGE[1] + 1,
                                     BATCH_GEN_REQUESTS + 1)]
    bodies = [{"input_ids": [p.tolist()], "max_new_tokens": BATCH_GEN_NEW_TOKENS}
              for p in prompts[:-1]]
    seeded = {"input_ids": [prompts[-1].tolist()], "max_new_tokens": BATCH_GEN_NEW_TOKENS,
              "seed": 1234}
    b0, r0 = gc.batches, gc.batched_requests
    with _DeviceCalls(node.runtime, "generate") as dev:
        # --- the path: counters to 0, the requests, counters read ----------
        A.PAGED_LAUNCHES.reset()
        A.VERIFY_LAUNCHES.reset()
        A.FLASH_LAUNCHES.reset()
        t0 = time.monotonic()
        results = _post_many(url, bodies, len(bodies))
        wall = time.monotonic() - t0
        seeded_result = _post(url, seeded, 900.0)
        paged, verify = A.PAGED_LAUNCHES.value, A.VERIFY_LAUNCHES.value
        flash = A.FLASH_LAUNCHES.value
        # -------------------------------------------------------------------
    batches, batched = gc.batches - b0, gc.batched_requests - r0
    p50 = statistics.median(dt for *_, dt in results) * 1e3
    log(f"  [batch generate] {len(bodies)} concurrent greedy requests (prompts "
        f"{min(len(p) for p in prompts)}-{max(len(p) for p in prompts)}, "
        f"{BATCH_GEN_NEW_TOKENS} new): {len(bodies) * BATCH_GEN_NEW_TOKENS / wall:.1f} tok/s, "
        f"p50 {p50:.1f} ms (host clock); device calls {dev.calls - 1} + 1 seeded, rows "
        f"{dev.rows}; coalesced batches {batches} holding {batched} requests; paged "
        f"{paged} / verify {verify} / flash {flash} launches ({nvidia_smi_line()})")
    if batches < 1 or batched < 2:
        raise AssertionError("[batch generate] no coalesced batch of 2 or more requests")
    if paged or verify:
        raise AssertionError(f"[batch generate] paged {paged} / verify {verify} launches != 0")
    if dev.seeds[-1] != 1234 or dev.calls - 1 + batched - batches != len(bodies):
        raise AssertionError(f"[batch generate] the seeded request did not run solo "
                             f"(seeds {dev.seeds}, {dev.calls} calls)")
    worst = 0.0
    for prompt, (status, body, _dt) in zip(prompts, [*results, seeded_result]):
        if status != 200:
            raise AssertionError(f"[batch generate] answered {status}: {body}")
        tokens = np.asarray(body["tokens"][0], np.int64)
        if tokens.shape != (BATCH_GEN_NEW_TOKENS,):
            raise AssertionError(f"[batch generate] tokens {tokens.shape}")
        worst = max(worst, _check_greedy(art, prompt, tokens, LOGITS_TOL, "[batch generate]"))
    log(f"  [batch generate] every token within {worst:.4f} of its position's plain max "
        f"logit (tolerance {LOGITS_TOL}, teacher-forced)")
    scrape = _scrape(base)
    counted = scrape.get(("tpusc_coalesced_requests_total", (("kind", "generate"),)))
    if counted != gc.batched_requests:
        raise AssertionError(f"[batch generate] scrape counts {counted} coalesced requests, "
                             f"the coalescer {gc.batched_requests}")


def _check_logits(plain_model, shape, ids, pred):
    """A ``:predict`` answer's (B, V) last-token logits against the plain
    path on the card: the same weights, the same bucket-padded input,
    attention_reference in every layer. Within LOGITS_TOL, and argmax equal
    on every row whose top-2 margin exceeds twice its own |diff| (a
    narrower margin is a bf16 near-tie). -> the padded input."""
    import numpy as np
    import torch

    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.runtime.model_runtime import next_bucket

    padded = np.zeros((next_bucket(shape[0]), next_bucket(shape[1])), np.int32)
    padded[: shape[0], : shape[1]] = ids
    with torch.inference_mode():
        logits = plain_model(
            {"input_ids": torch.from_numpy(padded).cuda()},
            attention_fn=A.attention_reference,
        )["logits"]
        ref = logits[: shape[0], shape[1] - 1, :].cpu().numpy()
        del logits
    row_err = np.abs(pred - ref).max(axis=-1)
    err = float(row_err.max())
    top2 = np.sort(ref, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    decided = margin > 2 * row_err
    agree = pred.argmax(-1) == ref.argmax(-1)
    if len(agree) > 4:  # many rows (the batch phase): one summary line
        log(f"  {shape}: max|logits - plain| = {err:.5g} (tolerance {LOGITS_TOL}); argmax "
            f"equal on {int(agree.sum())} of {len(agree)} rows; smallest top-2 margin "
            f"{float(margin.min()):.4f}")
    else:
        log(f"  {shape}: max|logits - plain| = {err:.5g} (tolerance {LOGITS_TOL}); "
            f"argmax equal {agree.tolist()}; top-2 margins {np.round(margin, 4).tolist()}")
    if not err <= LOGITS_TOL:
        raise AssertionError(f"{shape}: logits differ from the plain path by {err}")
    if not agree[decided].all():
        raise AssertionError(f"{shape}: argmax differs from the plain path")
    if not decided.all():
        log(f"  {shape}: {int((~decided).sum())} row(s) with a top-2 margin under "
            "twice their max |diff| (a bf16 near-tie): argmax not binding")
    return padded


SURFACE_TENANTS = 10       # mnist_cnn copies, seeds 0..9 (BASELINE.json config #2)
SURFACE_CACHE = 3          # the mnist node's resident models (the config's cache size)
SURFACE_ROUNDS = 3         # round-robin :classify rounds over the tenants
SURFACE_IMAGES = 8         # images a :classify request
SURFACE_GEN = 4            # greedy :generate requests through the label
SURFACE_NEW_TOKENS = 32
SURFACE_TOL = 2.0**-7      # mnist scores against the plain forward (tests/test_torch_families.py)


def _mnist_plain(art: Artifact, tenant: str, images):
    """The mnist tenant's class probabilities by its plain forward on the
    card (the artifact's weights, no serving path), float64."""
    import numpy as np
    import torch

    from tfservingcache_tpu_torch.models import registry

    model_def, params = registry.load_artifact(os.path.join(art.store, tenant, "1"))
    module = model_def.make_module({k: {n: t.cuda() for n, t in v.items()}
                                    for k, v in params.items()}).eval()
    with torch.inference_mode():
        logits = module({"image": torch.from_numpy(images).cuda()})["logits"]
    logits = logits.double().cpu().numpy()
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def phase_surface(art: Artifact, seed: int, warm_reps: int, kernels: dict) -> None:
    """The serving surface of BASELINE.json configs #1 and #2 and the LM on
    the serve phase's disk cache: half_plus_two ``:predict`` / ``:regress``
    through /versions/1 and /labels/stable (exactly 0.5 x + 2); the
    llama-7b-width LM mapped as ``version_labels`` {llama7b: {canary: 1}}: a
    warm (1, 128) ``:predict`` through /labels/canary (the serve phase's
    logits check), SURFACE_GEN greedy ``:generate`` requests through the
    label on a continuous paged node, token for token those of /versions/1,
    and an unmapped label's 412; then SURFACE_TENANTS mnist_cnn tenants on a
    node that holds SURFACE_CACHE, ``:classify`` round robin, every round
    reloading every tenant, scores against the plain forward. Where
    ``grpc`` and ``google.protobuf`` import, the same requests go over
    Predict, Classify, Regress and GenerateStream and must answer as REST
    did. B2's and B1's launches are read over the phase's requests."""
    import numpy as np

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.models import registry
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.server import build_node

    name = art.model_id.name
    registry.export_artifact("half_plus_two", art.store, name="hpt", version=1)
    tenants = [f"mnist{i}" for i in range(SURFACE_TENANTS)]
    for i, tenant in enumerate(tenants):
        registry.export_artifact("mnist_cnn", art.store, name=tenant, version=1, seed=i)
    rng = np.random.default_rng(seed + 14)
    nodes = []
    try:
        lm = build_node(config_from_dict(art.node_config(
            "serve", generate_engine="continuous", generate_slots=8, generate_chunk_tokens=8,
            kv_page_tokens=16, version_labels={name: {"canary": 1}, "hpt": {"stable": 1}})),
            device="cuda")
        nodes.append(lm)
        base = f"http://127.0.0.1:{lm.start('127.0.0.1')}/v1/models"
        grpc_on = lm.grpc is not None  # build_node starts gRPC where grpcio and protobuf import
        ids = rng.integers(0, art.vocab, size=(1, 128), dtype=np.int64)
        prompts = [rng.integers(1, art.vocab, int(n)).astype(np.int32)
                   for n in rng.integers(64, 257, SURFACE_GEN)]
        xs = rng.standard_normal(8).astype(np.float32)
        # the cold load and the engine's first dispatch stay out of the phase
        for url, body in ((f"{base}/{name}/versions/1:predict", {"instances": ids.tolist()}),
                          (f"{base}/{name}/versions/1:generate",
                           {"input_ids": [prompts[0].tolist()], "max_new_tokens": 8}),
                          (f"{base}/hpt/versions/1:predict", {"instances": [0.0]})):
            status, body, _dt = _post(url, body, 900.0)
            if status != 200:
                raise AssertionError(f"[surface] warm-up {url} answered {status}: {body}")

        # --- the path: counters to 0, the phase's requests, counters read ---
        # (after the LM's gRPC requests; the mnist tenants run no attention)
        A.FLASH_LAUNCHES.reset()
        A.PAGED_LAUNCHES.reset()
        A.VERIFY_LAUNCHES.reset()
        steps0 = lm.engine.decode_steps
        hpt = {}
        for ref in ("versions/1", "labels/stable"):
            hpt[ref] = (_post(f"{base}/hpt/{ref}:predict", {"instances": xs.tolist()}, 900.0),
                        _post(f"{base}/hpt/{ref}:regress",
                              {"examples": [{"x": float(x)} for x in xs]}, 900.0))
        predicts = [_post(f"{base}/{name}/labels/canary:predict", {"instances": ids.tolist()},
                          900.0) for _ in range(1 + warm_reps)]
        gen = {ref: [_post(f"{base}/{name}/{ref}:generate",
                           {"input_ids": [p.tolist()], "max_new_tokens": SURFACE_NEW_TOKENS},
                           900.0) for p in prompts]
               for ref in ("labels/canary", "versions/1")}
        unmapped = _post_raw(f"{base}/{name}/labels/nope:predict",
                             json.dumps({"instances": ids.tolist()}).encode())

        want_y = 0.5 * xs + np.float32(2.0)
        for ref, ((ps, pb, _), (rs, rb, _)) in hpt.items():
            pred = np.asarray(pb.get("predictions"), np.float32)
            vals = np.asarray(rb.get("results"), np.float32)
            if ps != 200 or rs != 200 or not (np.array_equal(pred, want_y)
                                              and np.array_equal(vals, want_y)):
                raise AssertionError(f"[surface] half_plus_two via {ref}: {ps} {pb} / {rs} {rb}")
        log(f"  [surface] half_plus_two :predict and :regress via /versions/1 and "
            f"/labels/stable: {len(xs)} values each, exactly 0.5 x + 2")
        for status, body, _dt in predicts:
            if status != 200:
                raise AssertionError(f"[surface] labelled :predict answered {status}: {body}")
        pred = np.asarray(predicts[-1][1]["predictions"], np.float32)
        _check_logits(art.plain_model, ids.shape, ids, pred)
        for ref, results in gen.items():
            for status, body, _dt in results:
                if status != 200:
                    raise AssertionError(f"[surface] :generate via {ref} answered {status}: {body}")
        label_toks = [r[1]["tokens"][0] for r in gen["labels/canary"]]
        version_toks = [r[1]["tokens"][0] for r in gen["versions/1"]]
        if label_toks != version_toks:
            raise AssertionError("[surface] :generate through /labels/canary differs from "
                                 "/versions/1")
        worst = max(_check_greedy(art, p, np.asarray(t), LOGITS_TOL, "[surface generate]")
                    for p, t in zip(prompts, label_toks))
        if unmapped[0] != 412:
            raise AssertionError(f"[surface] unmapped label answered {unmapped[0]}: {unmapped[1]}")
        log(f"  [surface] /labels/nope:predict answered 412: {unmapped[1].decode()}")
        log(f"  [surface] {SURFACE_GEN} greedy :generate via /labels/canary equal to "
            f"/versions/1 token for token ({SURFACE_NEW_TOKENS} new each; largest teacher-forced "
            f"gap {worst:.4f}, tolerance {LOGITS_TOL})")
        lat = {"predict": [dt for *_, dt in predicts[1:]],
               "generate": [dt for ref in gen.values() for *_, dt in ref]}
        log(f"  [surface] warm p50: labelled (1, 128) :predict "
            f"{statistics.median(lat['predict']) * 1e3:.2f} ms over {len(lat['predict'])}, "
            f":generate ({SURFACE_NEW_TOKENS} new) "
            f"{statistics.median(lat['generate']) * 1e3:.2f} ms over {len(lat['generate'])} "
            f"(host clock, localhost HTTP; {nvidia_smi_line()})")
        grpc_predicts = 0
        if grpc_on:
            grpc_predicts = _surface_grpc_lm(art, lm, ids, pred, prompts, label_toks, xs,
                                             want_y, warm_reps, lat["predict"])
        else:
            log("  [surface] gRPC surface not driven: grpcio or protobuf is not installed on "
                "this machine (the node serves REST only); REST carried every check")
        flash, paged, verify = (A.FLASH_LAUNCHES.value, A.PAGED_LAUNCHES.value,
                                A.VERIFY_LAUNCHES.value)
        steps = lm.engine.decode_steps - steps0
        # --------------------------------------------------------------------
        predicts_run = 1 + warm_reps + grpc_predicts
        log(f"  [surface] launches over the LM's requests: flash_attention {flash} (n_layers "
            f"{art.layers} x {predicts_run} labelled predicts = {art.layers * predicts_run}), "
            f"paged_decode_attention {paged} (n_layers x decode steps {steps} = "
            f"{art.layers * steps}), paged_verify_attention {verify}")
        if flash != art.layers * predicts_run or paged != art.layers * steps or not paged \
                or verify:
            raise AssertionError(f"[surface] launches flash {flash} / paged {paged} / verify "
                                 f"{verify}")
        kernels["flash_attention"]["launches"] += flash
        kernels["flash_attention"]["launches_surface_phase"] = flash
        kernels["paged_decode_attention"]["launches"] += paged
        kernels["paged_decode_attention"]["launches_surface_phase"] = paged

        mcfg = art.node_config("serve", max_concurrent_models=SURFACE_CACHE)
        mcfg["cache"]["disk_capacity_bytes"] += sum(  # room for every tenant on disk
            os.path.getsize(os.path.join(art.store, t, "1", "params.bin")) for t in tenants)
        mn = build_node(config_from_dict(mcfg), device="cuda")
        nodes.append(mn)
        mbase = f"http://127.0.0.1:{mn.start('127.0.0.1')}/v1/models"
        m = mn.metrics
        images = rng.random((SURFACE_IMAGES, 28, 28, 1), dtype=np.float32)
        body = json.dumps({"examples": [{"image": img.reshape(-1).tolist()}
                                        for img in images]}).encode()
        plain = {tenant: _mnist_plain(art, tenant, images) for tenant in tenants}

        def reloads() -> tuple[float, float, float, float]:
            return (m.reload_source.labels("store").value, m.reload_source.labels("disk").value,
                    m.reload_source.labels("hbm").value, m.evictions.labels("hbm").value)

        times: dict[str, list[float]] = {"cold": [], "reload": [], "warm": []}
        worst = 0.0
        first = reloads()
        for rnd in range(SURFACE_ROUNDS):
            r0 = reloads()
            for tenant in tenants:
                status, raw, dt = _post_raw(f"{mbase}/{tenant}/versions/1:classify", body)
                if status != 200:
                    raise AssertionError(f"[surface] {tenant} :classify answered {status}: {raw}")
                times["cold" if rnd == 0 else "reload"].append(dt)
                rows = json.loads(raw)["results"]
                scores = np.asarray([[s for _l, s in row] for row in rows])
                if [[lab for lab, _s in row] for row in rows] != [
                        [str(j) for j in range(10)]] * SURFACE_IMAGES:
                    raise AssertionError(f"[surface] {tenant} :classify labels {rows[0]}")
                err = float(np.abs(scores - plain[tenant]).max())
                worst = max(worst, err)
                if not err <= SURFACE_TOL:
                    raise AssertionError(f"[surface] {tenant} scores differ from the plain "
                                         f"forward by {err}")
            r1 = reloads()
            loads = (r1[0] - r0[0]) + (r1[1] - r0[1])
            log(f"  [surface] mnist round {rnd}: {loads:.0f} reloads (store {r1[0] - r0[0]:.0f}, "
                f"disk {r1[1] - r0[1]:.0f}), hbm hits {r1[2] - r0[2]:.0f}, evictions "
                f"{r1[3] - r0[3]:.0f}")
            if loads != SURFACE_TENANTS or r1[2] != r0[2]:
                raise AssertionError(f"[surface] round {rnd} reloaded {loads} of "
                                     f"{SURFACE_TENANTS} tenants")
        for _ in range(warm_reps):  # the last tenant is resident: warm hits
            status, raw, dt = _post_raw(f"{mbase}/{tenants[-1]}/versions/1:classify", body)
            times["warm"].append(dt)
        last = reloads()
        log(f"  [surface] {SURFACE_TENANTS} mnist_cnn tenants, cache of {SURFACE_CACHE}, "
            f"{SURFACE_ROUNDS} rounds of :classify ({SURFACE_IMAGES} images): evictions "
            f"{last[3] - first[3]:.0f}, reloads from store {last[0] - first[0]:.0f} and disk "
            f"{last[1] - first[1]:.0f}; scores within {worst:.3g} of the plain forward "
            f"(tolerance {SURFACE_TOL}); p50 cold (store fetch + load) "
            f"{statistics.median(times['cold']) * 1e3:.2f} ms, reload (disk + load) "
            f"{statistics.median(times['reload']) * 1e3:.2f} ms, warm "
            f"{statistics.median(times['warm']) * 1e3:.2f} ms (host clock, localhost HTTP; "
            f"{nvidia_smi_line()})")
        if grpc_on:
            _surface_grpc_mnist(mn, tenants[-1], images, body, mbase)
    finally:
        for node in nodes:
            node.close()


def _surface_grpc_lm(art, node, ids, rest_pred, prompts, rest_toks, xs, want_y,
                     warm_reps, rest_lat) -> int:
    """The surface phase's LM and half_plus_two requests over gRPC:
    Predict with ``version_label`` canary (logits equal to the REST
    reply's, then ``warm_reps`` timed beside REST's p50), an unmapped label
    (FAILED_PRECONDITION), GenerateStream (a frame a token, the tokens REST
    answered), half_plus_two Predict and Regress (0.5 x + 2). -> the LM
    Predicts it made."""
    import grpc
    import numpy as np

    from tfservingcache_tpu_torch.protocol import codec
    from tfservingcache_tpu_torch.protocol.grpc_client import ServingStub, make_channel
    from tfservingcache_tpu_torch.protocol.grpc_server import PREDICTION_SERVICE
    from tfservingcache_tpu_torch.protocol.protos import tf_serving_pb2 as sv

    log(f"  [surface] gRPC: grpcio {grpc.__version__}, on :{node.grpc_port}")
    channel = make_channel(f"127.0.0.1:{node.grpc_port}")
    try:
        stub = ServingStub(channel)
        req = sv.PredictRequest()
        req.model_spec.name = art.model_id.name
        req.model_spec.version_label = "canary"
        req.inputs["input_ids"].CopyFrom(codec.numpy_to_tensorproto(ids.astype(np.int32)))
        req.output_filter.append("last_token_logits")
        resp = stub.method(PREDICTION_SERVICE, "Predict")(req, timeout=900)
        got = codec.tensorproto_to_numpy(resp.outputs["last_token_logits"])
        if resp.model_spec.version.value != 1 or not np.array_equal(got, rest_pred):
            raise AssertionError(f"[surface] gRPC Predict via the label: version "
                                 f"{resp.model_spec.version.value}, max|gRPC - REST| "
                                 f"{float(np.abs(got - rest_pred).max())}")
        grpc_lat = []
        for _ in range(warm_reps):
            t0 = time.monotonic()
            stub.method(PREDICTION_SERVICE, "Predict")(req, timeout=900)
            grpc_lat.append(time.monotonic() - t0)
        req.model_spec.version_label = "nope"
        try:
            stub.method(PREDICTION_SERVICE, "Predict")(req, timeout=900)
            raise AssertionError("[surface] gRPC Predict of an unmapped label answered")
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.FAILED_PRECONDITION:
                raise AssertionError(f"[surface] unmapped label over gRPC: {e.code()}") from e
        frames = 0
        for prompt, want in zip(prompts, rest_toks):
            sreq = sv.PredictRequest()
            sreq.model_spec.name = art.model_id.name
            sreq.model_spec.version_label = "canary"
            sreq.model_spec.signature_name = "generate"
            sreq.inputs["input_ids"].CopyFrom(codec.numpy_to_tensorproto(prompt[None]))
            sreq.inputs["max_new_tokens"].CopyFrom(
                codec.numpy_to_tensorproto(np.asarray(len(want), np.int32)))
            out = list(stub.generate_stream()(sreq, timeout=900))
            toks = [int(codec.tensorproto_to_numpy(f.outputs["token"])) for f in out[:-1]]
            final = codec.tensorproto_to_numpy(out[-1].outputs["tokens"]).tolist()
            if toks != want or final != [want]:
                raise AssertionError("[surface] GenerateStream differs from REST :generate")
            frames += len(out)
        hreq = sv.PredictRequest()
        hreq.model_spec.name = "hpt"
        hreq.model_spec.version_label = "stable"
        hreq.inputs["x"].CopyFrom(codec.numpy_to_tensorproto(xs))
        y = codec.tensorproto_to_numpy(
            stub.method(PREDICTION_SERVICE, "Predict")(hreq, timeout=900).outputs["y"])
        rreq = sv.RegressionRequest()
        rreq.model_spec.name = "hpt"
        rreq.model_spec.version.value = 1
        for x in xs:
            rreq.input.example_list.examples.add().features.feature["x"].float_list.value.append(
                float(x))
        vals = [r.value for r in stub.method(PREDICTION_SERVICE, "Regress")(
            rreq, timeout=900).result.regressions]
        if not (np.array_equal(y, want_y) and np.array_equal(np.asarray(vals, np.float32),
                                                             want_y)):
            raise AssertionError("[surface] half_plus_two over gRPC is not 0.5 x + 2")
    finally:
        channel.close()
    log(f"  [surface] gRPC Predict via version_label canary equal to REST's logits; unmapped "
        f"label FAILED_PRECONDITION; {len(prompts)} GenerateStream calls ({frames} frames) equal "
        f"to REST :generate; half_plus_two Predict and Regress exactly 0.5 x + 2")
    log(f"  [surface] warm (1, 128) labelled Predict p50 over gRPC "
        f"{statistics.median(grpc_lat) * 1e3:.2f} ms over {len(grpc_lat)}, over REST "
        f"{statistics.median(rest_lat) * 1e3:.2f} ms over {len(rest_lat)} (host clock, "
        f"localhost, the client in the node's process; gRPC answers TensorProto bytes, REST "
        f"JSON text; {nvidia_smi_line()})")
    return 1 + len(grpc_lat)


def _surface_grpc_mnist(node, tenant, images, rest_body, mbase) -> None:
    """One mnist tenant's :classify over gRPC Classify: the same scores (as
    f32) as the REST reply to the same examples."""
    import numpy as np

    from tfservingcache_tpu_torch.protocol.grpc_client import ServingStub, make_channel
    from tfservingcache_tpu_torch.protocol.grpc_server import PREDICTION_SERVICE
    from tfservingcache_tpu_torch.protocol.protos import tf_serving_pb2 as sv

    status, raw, _dt = _post_raw(f"{mbase}/{tenant}/versions/1:classify", rest_body)
    rest = [[s for _l, s in row] for row in json.loads(raw)["results"]]
    channel = make_channel(f"127.0.0.1:{node.grpc_port}")
    try:
        req = sv.ClassificationRequest()
        req.model_spec.name = tenant
        req.model_spec.version.value = 1
        for img in images:
            ex = req.input.example_list.examples.add()
            ex.features.feature["image"].float_list.value.extend(img.reshape(-1).tolist())
        resp = ServingStub(channel).method(PREDICTION_SERVICE, "Classify")(req, timeout=900)
    finally:
        channel.close()
    got = [[c.score for c in cls.classes] for cls in resp.result.classifications]
    if status != 200 or got != rest:
        raise AssertionError(f"[surface] gRPC Classify differs from REST ({status})")
    log(f"  [surface] gRPC Classify of {tenant} ({len(images)} images) equal to REST :classify")


def _spans_named(traces: list, name: str) -> list:
    """Every span called ``name`` in ``TRACER.query`` traces, oldest first."""
    found = []

    def walk(d):
        if d["name"] == name:
            found.append(d)
        for c in d.get("children", ()):
            walk(c)

    for trace in reversed(traces):
        walk(trace)
    return found


def _stage_ms(load: dict) -> dict:
    return {c["name"]: c["duration_s"] * 1e3 for c in load.get("children", ())}


def _reset_pinned() -> None:
    import torch

    from tfservingcache_tpu_torch.runtime.model_runtime import locked_chunk_bytes

    torch.cuda.reset_peak_host_memory_stats()
    locked_chunk_bytes(reset_peak=True)


def _pinned_peak() -> str:
    """Page-locked host memory since the last ``_reset_pinned``: the caching
    host allocator's peaks (``torch.cuda.host_memory_stats``: the staging
    buffers, a serialized load's artifact) and the host tier's chunks,
    which ``cudaHostRegister`` locks outside that allocator."""
    import torch

    from tfservingcache_tpu_torch.runtime.model_runtime import locked_chunk_bytes

    stats = torch.cuda.host_memory_stats()
    got = {k: int(v) for k, v in stats.items() if k in ("allocated_bytes.peak", "active_bytes.peak")}
    alloc = ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in got.items()) or "not reported"
    now, peak = locked_chunk_bytes()
    return (f"caching host allocator {alloc}; tier chunks (cudaHostRegister) peak "
            f"{peak / 2**20:.1f} MiB, now {now / 2**20:.1f} MiB")


def phase_tier(art: Artifact, seed: int, kernels: dict) -> None:
    """The pipelined cold load and the host RAM tier on the serve phase's
    disk cache, with the artifact and its exact copy ``copy``. A node with
    ``cold_load_pipeline: false`` loads both first (``copy`` is fetched into
    the disk cache there), then a pipelined node without a tier. Then a pipelined
    node whose device holds one of the two models (``max_concurrent_models``
    1) and whose ``cache.host_tier_bytes`` holds both runs TIER_SCHEDULE, a
    (1, 128) ``:predict`` a step: llama7b and copy from disk (each load
    retains its packed chunks, and each evicts the other to the tier), then
    both promoted from host RAM. ``tpusc_reload_source`` must count disk 2
    and host 2 and nothing else; each promoted model's reply must be its
    disk load's byte for byte (so its logits are equal) and pass the serve
    phase's logits check; B2's launches over the schedule must be n_layers
    x (4 requests + 2 warm-up forwards of the disk loads; a promotion runs
    none). Printed: each load's time by stage, the copies' rate, the
    overlap ratio and the page-locked memory each load held. Then the small
    models (``_tier_small_models``) and the loads beside a serving model
    (``_tier_busy_loads``)."""
    import numpy as np

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.server import build_node
    from tfservingcache_tpu_torch.utils.tracing import TRACER

    ids = np.random.default_rng(seed + 18).integers(0, art.vocab, size=TIER_SHAPE,
                                                       dtype=np.int64)
    body = json.dumps({"instances": ids.tolist()}).encode()
    names = [name for name, _tier in TIER_SCHEDULE[:2]]
    log(nvidia_smi_line())

    # cold loads without the tier: serialized (the whole artifact
    # page-locked, every leaf copied out of it), then pipelined (page-locked
    # staging buffers only)
    untiered = {}
    for arm, pipeline in (("serialized", False), ("pipelined", True)):
        node = build_node(config_from_dict(art.node_config(
            "serve", max_concurrent_models=1, cold_load_pipeline=pipeline)), device="cuda")
        try:
            base = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models"
            for name in names:
                TRACER.clear()
                _reset_pinned()
                status, raw, _dt = _post_raw(f"{base}/{name}/versions/1:predict", body)
                if status != 200:
                    raise AssertionError(f"{arm} :predict of {name} answered {status}: {raw!r}")
                (load,) = _spans_named(TRACER.query(n=8), "load")
                untiered[arm, name] = load
                attrs = next(c for c in load["children"]
                             if c["name"] == "device_transfer").get("attrs", {})
                log(f"{arm} cold load of {name} (no tier): {load['duration_s'] * 1e3:.1f} ms = "
                    + ", ".join(f"{k} {v:.1f}" for k, v in _stage_ms(load).items())
                    + f" ms; page-locked staging {attrs.get('staging_bytes', 0) / 2**20:.1f} "
                    f"MiB; page-locked: {_pinned_peak()} (the artifact is "
                    f"{art.nbytes / 2**20:.1f} MiB)")
        finally:
            node.close()

    raw_cfg = art.node_config("serve", max_concurrent_models=1)
    raw_cfg["cache"]["host_tier_bytes"] = 3 * art.nbytes
    node = build_node(config_from_dict(raw_cfg), device="cuda")
    try:
        if not (node.runtime.cold_pipeline_enabled and node.runtime.host_tier_enabled):
            raise AssertionError("the tier node neither pipelines nor has a host tier")
        base = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models"
        TRACER.clear()
        replies, peaks = [], []
        # --- the main path: counters to 0, the schedule, counters read -----
        A.FLASH_LAUNCHES.reset()
        for name, _tier in TIER_SCHEDULE:
            _reset_pinned()
            status, raw, dt = _post_raw(f"{base}/{name}/versions/1:predict", body)
            peaks.append(_pinned_peak())
            replies.append((status, raw, dt))
        launches = A.FLASH_LAUNCHES.value
        # -------------------------------------------------------------------
        node.runtime.drain_demotions()
        counts = {t: node.metrics.reload_source.labels(t).value
                  for t in ("hbm", "host", "disk", "store", "peer")}
        log(f"tpusc_reload_source over the schedule: {counts}")
        if counts != {"hbm": 0.0, "host": 2.0, "disk": 2.0, "store": 0.0, "peer": 0.0}:
            raise AssertionError(f"reload sources {counts} != disk 2, host 2")
        loads = _spans_named(TRACER.query(n=16), "load")
        tiers = [ld["attrs"]["tier"] for ld in loads]
        if tiers != [t for _n, t in TIER_SCHEDULE]:
            raise AssertionError(f"load tiers {tiers} != the schedule's")
        expected = art.layers * (len(TIER_SCHEDULE) + 2)
        log(f"flash_attention launches over the schedule: {launches} (n_layers {art.layers} x "
            f"({len(TIER_SCHEDULE)} requests + 2 warm-up forwards of the disk loads) = "
            f"{expected})")
        if launches != expected:
            raise AssertionError(f"kernel launch count {launches} != {expected}")
        kernels["flash_attention"]["launches_tier_phase"] = launches
        first = {}
        for (name, tier), (status, raw, dt), load, peak in zip(TIER_SCHEDULE, replies, loads,
                                                                 peaks):
            if status != 200:
                raise AssertionError(f":predict of {name} ({tier}) answered {status}: {raw!r}")
            pred = np.asarray(json.loads(raw)["predictions"], dtype=np.float32)
            if pred.shape != (1, art.vocab) or not np.isfinite(pred).all():
                raise AssertionError(f"{name} ({tier}): predictions {pred.shape}")
            st = _stage_ms(load)
            transfer = next(c for c in load["children"] if c["name"] == "device_transfer")
            attrs = transfer["attrs"]
            copy_s = (st["device_transfer"] + st["transfer_sync"]) / 1e3
            log(f"{tier} load of {name}: {load['duration_s'] * 1e3:.1f} ms = " + ", ".join(
                f"{k} {v:.1f}" for k, v in st.items()) + f" ms; {attrs['bytes']} bytes in "
                f"{attrs['chunks']} chunks copied at {attrs['bytes'] / copy_s / 1e9:.2f} GB/s "
                f"(device_transfer + transfer_sync); overlap ratio "
                f"{load['attrs'].get('cold_overlap_ratio', 'n/a')}; page-locked staging "
                f"{attrs.get('staging_bytes', 0) / 2**20:.1f} MiB; page-locked: {peak}; "
                f"request {dt * 1e3:.1f} ms")
            if tier == "disk":
                first[name] = (raw, pred)
                _check_logits(art.plain_model, TIER_SHAPE, ids, pred)
                continue
            want_raw, want_pred = first[name]
            if raw != want_raw or not np.array_equal(pred, want_pred):
                raise AssertionError(f"{name}: the promoted model's reply differs from its "
                                     "disk load's")
            _check_logits(art.plain_model, TIER_SHAPE, ids, pred)
            log(f"  {name} promoted: reply byte for byte its disk load's")
        for name in names:
            tiered = next(ld for ld, (n, _t) in zip(loads, TIER_SCHEDULE) if n == name)
            log(f"cold load of {name}: serialized "
                f"{untiered['serialized', name]['duration_s'] * 1e3:.1f} ms, pipelined "
                f"{untiered['pipelined', name]['duration_s'] * 1e3:.1f} ms, pipelined with the "
                f"tier's capture {tiered['duration_s'] * 1e3:.1f} ms (one call, one card; "
                "the artifact read from a warm page cache)")
        log(f"host tier: {node.runtime._host_tier.total_bytes} bytes page-locked for "
            f"{len(node.runtime._host_tier)} models")
    finally:
        node.close()
    _tier_small_models(art, seed)
    _tier_busy_loads(art, seed, body)


def _tier_small_models(art: Artifact, seed: int) -> None:
    """TIER_SMALL through the tier on a node of their own (a disk cache of
    its own, so each first load is a store fetch) that holds one model on
    the device and all three in host RAM: each loaded, then each promoted.
    ``tpusc_reload_source`` must count store 3 and host 3 and nothing else
    (a chunk that failed to page-lock would leave its model out of the
    tier, and its second load would come from disk); every promoted reply
    must be its first load's byte for byte, half_plus_two exactly 0.5 x +
    2 and the mnist scores within SURFACE_TOL of the plain forward."""
    import numpy as np

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.models import registry
    from tfservingcache_tpu_torch.server import build_node

    if not os.path.isdir(os.path.join(art.store, "hpt")):
        registry.export_artifact("half_plus_two", art.store, name="hpt", version=1)
    for i, name in enumerate(TIER_SMALL[1:]):  # the surface phase's tenants, seeds 0, 1
        if not os.path.isdir(os.path.join(art.store, name)):
            registry.export_artifact("mnist_cnn", art.store, name=name, version=1, seed=i)
    rng = np.random.default_rng(seed + 181)
    xs = rng.standard_normal(8).astype(np.float32)
    images = rng.random((SURFACE_IMAGES, 28, 28, 1), dtype=np.float32)
    requests = {"hpt": ("predict", json.dumps({"instances": xs.tolist()}).encode())}
    mnist_body = json.dumps({"examples": [{"image": img.reshape(-1).tolist()}
                                          for img in images]}).encode()
    requests.update({name: ("classify", mnist_body) for name in TIER_SMALL[1:]})
    cfg = art.node_config("tiersmall", max_concurrent_models=1)
    cfg["cache"]["disk_capacity_bytes"] = 2 * sum(  # every artifact stays on disk
        os.path.getsize(os.path.join(d, f)) for name in TIER_SMALL
        for d, _sub, files in os.walk(os.path.join(art.store, name)) for f in files)
    cfg["cache"]["host_tier_bytes"] = 64 << 20
    node = build_node(config_from_dict(cfg), device="cuda")
    try:
        base = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models"
        _reset_pinned()
        replies = {}
        for rnd in ("first", "promoted"):
            for name in TIER_SMALL:
                verb, body = requests[name]
                status, raw, dt = _post_raw(f"{base}/{name}/versions/1:{verb}", body)
                if status != 200:
                    raise AssertionError(f"[tier small] {name} :{verb} ({rnd}) answered "
                                         f"{status}: {raw!r}")
                replies[rnd, name] = raw
                log(f"  [tier small] {name} :{verb} ({rnd} load) {dt * 1e3:.1f} ms")
        node.runtime.drain_demotions()
        counts = {t: node.metrics.reload_source.labels(t).value
                  for t in ("hbm", "host", "disk", "store", "peer")}
        log(f"  [tier small] tpusc_reload_source: {counts}; page-locked: {_pinned_peak()}; "
            f"tier {node.runtime._host_tier.total_bytes} bytes for "
            f"{len(node.runtime._host_tier)} models")
        if counts != {"hbm": 0.0, "host": 3.0, "disk": 0.0, "store": 3.0, "peer": 0.0}:
            raise AssertionError(f"[tier small] reload sources {counts} != store 3, host 3")
        for name in TIER_SMALL:
            if replies["promoted", name] != replies["first", name]:
                raise AssertionError(f"[tier small] {name}: the promoted reply differs from "
                                     "its first load's")
        pred = np.asarray(json.loads(replies["promoted", "hpt"])["predictions"], np.float32)
        if not np.array_equal(pred, 0.5 * xs + np.float32(2.0)):
            raise AssertionError(f"[tier small] promoted half_plus_two answered {pred}")
        worst = 0.0
        for name in TIER_SMALL[1:]:
            rows = json.loads(replies["promoted", name])["results"]
            scores = np.asarray([[sc for _l, sc in row] for row in rows])
            worst = max(worst, float(np.abs(scores - _mnist_plain(art, name, images)).max()))
        if not worst <= SURFACE_TOL:
            raise AssertionError(f"[tier small] promoted mnist scores differ from the plain "
                                 f"forward by {worst}")
        log(f"  [tier small] promoted replies byte for byte the first loads'; half_plus_two "
            f"exactly 0.5 x + 2; mnist scores within {worst:.3g} of the plain forward "
            f"(tolerance {SURFACE_TOL})")
    finally:
        node.close()


def _tier_busy_loads(art: Artifact, seed: int, copy_body: bytes) -> None:
    """Loads of ``copy`` while llama7b serves. A node that holds both models
    on the device and in host RAM answers a TIER_BUSY_SHAPE llama7b
    ``:predict`` twice and a TIER_SHAPE ``copy`` one (the quiet replies; the
    first llama7b reply passes the serve phase's logits check, the second
    must equal it). Then a client thread posts the llama7b request back to
    back while ``copy`` goes through TIER_BUSY_LOADS: unloaded to the tier
    and promoted, or (``disk``) unloaded with its tier entry discarded and
    loaded from the disk cache, one ``:predict`` each, every load started
    while a llama7b request is under way. Every reply of either model must
    be its quiet reply byte for byte: a chunk landing in device memory that
    a forward still reads would change them. ``tpusc_reload_source`` over
    the loads must count host 3 and disk 1."""
    import threading

    import numpy as np

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.server import build_node
    from tfservingcache_tpu_torch.types import ModelId

    ids = np.random.default_rng(seed + 182).integers(0, art.vocab, size=TIER_BUSY_SHAPE,
                                                        dtype=np.int64)
    busy_body = json.dumps({"instances": ids.tolist()}).encode()
    cfg = art.node_config("serve", max_concurrent_models=2)
    cfg["cache"]["host_tier_bytes"] = 3 * art.nbytes
    node = build_node(config_from_dict(cfg), device="cuda")
    copy_id = ModelId("copy", 1)
    try:
        base = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models"
        busy_url, copy_url = (f"{base}/llama7b/versions/1:predict",
                              f"{base}/copy/versions/1:predict")
        quiet = [_post_raw(busy_url, busy_body) for _ in range(2)]
        quiet_copy = _post_raw(copy_url, copy_body)
        for status, raw, _dt in (*quiet, quiet_copy):
            if status != 200:
                raise AssertionError(f"[tier busy] quiet :predict answered {status}: {raw!r}")
        if quiet[0][1] != quiet[1][1]:
            raise AssertionError("[tier busy] two quiet llama7b replies differ")
        pred = np.asarray(json.loads(quiet[0][1])["predictions"], np.float32)
        _check_logits(art.plain_model, TIER_BUSY_SHAPE, ids, pred)
        node.runtime.unload(copy_id)
        node.runtime.drain_demotions()
        if not node.runtime.host_tier_contains(copy_id):
            raise AssertionError("[tier busy] copy is not in the host tier after its unload")
        m = node.metrics

        def sources() -> dict:
            return {t: m.reload_source.labels(t).value for t in ("host", "disk", "store")}

        before = sources()
        stop = threading.Event()
        served: list = []   # (start, end, status, reply) of the llama7b requests
        started = [0.0]     # when the request under way was posted

        def client() -> None:
            while not stop.is_set():
                started[0] = t0 = time.monotonic()
                status, raw, _dt = _post_raw(busy_url, busy_body)
                served.append((t0, time.monotonic(), status, raw))

        worker = threading.Thread(target=client, name="tier-busy-client", daemon=True)
        loads = []
        worker.start()
        try:
            for tier in TIER_BUSY_LOADS:
                if tier == "disk":
                    node.runtime.unload_and_discard(copy_id)
                    node.runtime.drain_demotions()
                # start the load once a llama7b request posted after the last
                # load has been under way a few ms
                last_end = loads[-1][2] if loads else 0.0
                deadline = time.monotonic() + 600.0
                while started[0] <= last_end and worker.is_alive():
                    if time.monotonic() > deadline:
                        raise AssertionError("[tier busy] the client posted nothing")
                    time.sleep(0.002)
                time.sleep(0.005)
                t0 = time.monotonic()
                status, raw, dt = _post_raw(copy_url, copy_body)
                loads.append((tier, t0, time.monotonic(), status, raw))
                node.runtime.unload(copy_id)
                node.runtime.drain_demotions()
            n_done = len(served)
            while len(served) == n_done and worker.is_alive():  # one more after the last
                time.sleep(0.002)
        finally:
            stop.set()
            worker.join(timeout=900.0)
        if worker.is_alive():
            raise AssertionError("[tier busy] the client thread did not stop")
        counted = {t: v - before[t] for t, v in sources().items()}
        for tier, t0, t1, status, raw in loads:
            overlapped = sum(1 for s0, s1, *_ in served if s0 < t1 and s1 > t0)
            log(f"  [tier busy] {tier} load of copy + :predict {1e3 * (t1 - t0):.1f} ms beside "
                f"{overlapped} llama7b {TIER_BUSY_SHAPE} request(s) under way")
            if status != 200 or raw != quiet_copy[1]:
                raise AssertionError(f"[tier busy] copy's reply after its {tier} load "
                                     f"(status {status}) differs from its quiet reply")
            if not overlapped:
                raise AssertionError(f"[tier busy] no llama7b request overlapped the {tier} "
                                     "load")
        bad = [i for i, (_s0, _s1, status, raw) in enumerate(served)
               if status != 200 or raw != quiet[0][1]]
        log(f"  [tier busy] {len(served)} llama7b requests during the loads, {len(bad)} "
            f"differing from the quiet reply; reload sources over the loads {counted}")
        if bad:
            raise AssertionError(f"[tier busy] llama7b replies {bad} differ from the quiet "
                                 "reply")
        if counted != {"host": 3.0, "disk": 1.0, "store": 0.0}:
            raise AssertionError(f"[tier busy] reload sources {counted} != host 3, disk 1")
    finally:
        node.close()


QUANT_NAME = "llama7b_int8"
QUANT_SHAPES = [(1, 128), (2, 1024)]
QUANT_PROMPTS = 4                # greedy :generate requests on the paged engine
QUANT_PROMPT_RANGE = (64, 512)
QUANT_NEW_TOKENS = 32
# the tier schedule: int8 and bf16 from disk, then both promoted, int8 twice
QUANT_TIER_SCHEDULE = ((QUANT_NAME, "disk"), ("llama7b", "disk"), (QUANT_NAME, "host"),
                       ("llama7b", "host"), (QUANT_NAME, "host"))


def _quant_load(base: str, name: str, body: bytes) -> tuple[bytes, dict]:
    """One ``:predict`` of ``name`` that loads it. -> (the reply's bytes, the
    ``load`` span, whose attrs gain ``host_allocs``: the page-locked blocks
    the caching host allocator had to allocate (not reuse) meanwhile, and
    the ms it spent on them)."""
    import torch

    from tfservingcache_tpu_torch.utils.tracing import TRACER

    def allocs() -> tuple[int, float] | None:
        st = torch.cuda.host_memory_stats()
        if "num_host_alloc" not in st:
            return None
        # host_alloc_time is in microseconds
        return int(st["num_host_alloc"]), float(st.get("host_alloc_time.total", 0)) / 1e3

    TRACER.clear()
    before = allocs()
    status, raw, _dt = _post_raw(f"{base}/{name}/versions/1:predict", body)
    if status != 200:
        raise AssertionError(f":predict of {name} answered {status}: {raw!r}")
    (load,) = _spans_named(TRACER.query(n=8), "load")
    after = allocs()
    load["attrs"]["host_allocs"] = "not reported" if before is None or after is None else (
        f"{after[0] - before[0]} new page-locked blocks in {after[1] - before[1]:.1f} ms")
    return raw, load


def _load_line(what: str, load: dict) -> str:
    st = _stage_ms(load)
    attrs = next(c for c in load["children"] if c["name"] == "device_transfer").get("attrs", {})
    nbytes = f", {attrs['bytes']} bytes in {attrs['chunks']} chunks" if "bytes" in attrs else ""
    return (f"{what}: {load['duration_s'] * 1e3:.1f} ms = "
            + ", ".join(f"{k} {v:.1f}" for k, v in st.items()) + f" ms{nbytes}; caching "
            f"host allocator: {load['attrs']['host_allocs']}")


def phase_quant(art: Artifact, seed: int, kernels: dict) -> None:
    """int8 artifacts end to end (``save_artifact(quantize="int8")``, the
    on-device dequant of every load path). The artifact's weights are written
    again as ``llama7b_int8`` (each weight of 2+ axes and >= 65536 elements
    as int8 + per-output-channel f32 scales) into the store, its
    ``params.bin`` bytes printed beside the bf16 artifact's. A plain module
    is built on the card from the host-dequantized weights. Then, on the
    serve phase's disk cache: (1) serialized and pipelined nodes cold-load
    llama7b and llama7b_int8 (load stages printed: transfer, device_dequant,
    total), the int8 replies of both equal byte for byte; (2) on the
    pipelined node, int8 ``:predict`` at QUANT_SHAPES, each held by the
    serve phase's logits check to the plain module; (3) a continuous paged
    node serves QUANT_PROMPTS greedy ``:generate`` requests of
    QUANT_NEW_TOKENS on the int8 model, every token held to the generate
    phase's teacher-forced check, paged launches = n_layers x decode
    steps; (4) a node with a host tier that holds both models runs
    QUANT_TIER_SCHEDULE: reload sources disk 2 and host 3, every promoted
    reply its disk load's byte for byte, the int8 entry's bytes and its
    promotions' dequant time printed. B2's launches = n_layers x (requests
    + the disk loads' warm-up forwards) on every predict node. The int8
    artifact and its disk-cache copies are deleted at the end."""
    import types

    import numpy as np
    import torch

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.models import registry
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.server import build_node

    log(nvidia_smi_line())
    qdir = os.path.join(art.store, QUANT_NAME, "1")
    model_def = registry.build("transformer_lm", dict(art.model_cfg))
    flash = paged = 0
    plain_q = None
    try:
        t0 = time.monotonic()
        registry.save_artifact(qdir, model_def, art.params, quantize="int8")
        qbytes = os.path.getsize(os.path.join(qdir, "params.bin"))
        with open(os.path.join(qdir, "model.json")) as f:
            n_quant = sum("quant" in e for e in json.load(f)["params"]["manifest"])
        log(f"wrote {QUANT_NAME} (save_artifact(quantize='int8'), {n_quant} int8 leaves) in "
            f"{time.monotonic() - t0:.2f}s: params.bin {qbytes} bytes against the bf16 "
            f"artifact's {art.nbytes} ({qbytes / art.nbytes:.4f}x); device bytes once "
            f"dequantized {registry.resident_bytes_estimate(qdir)}")
        _md, host = registry.load_artifact(qdir)  # host dequant: the plain path's weights
        plain_q = model_def.make_module(_tree_cuda(host)).eval()
        del host
        qart = types.SimpleNamespace(plain_model=plain_q, vocab=art.vocab, layers=art.layers,
                                     model_id=_mid(QUANT_NAME))
        ids = np.random.default_rng(seed + 21).integers(0, art.vocab, size=TIER_SHAPE,
                                                           dtype=np.int64)
        body = json.dumps({"instances": ids.tolist()}).encode()

        # (1) + (2): cold loads, serialized then pipelined; int8 :predict
        loads, int8_replies = {}, {}
        for arm, pipeline in (("serialized", False), ("pipelined", True)):
            node = build_node(config_from_dict(art.node_config(
                "serve", max_concurrent_models=1, cold_load_pipeline=pipeline)), device="cuda")
            try:
                base = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models"
                A.FLASH_LAUNCHES.reset()
                requests = 0
                for name in ("llama7b", QUANT_NAME):
                    raw, load = _quant_load(base, name, body)
                    requests += 1
                    loads[arm, name] = load
                    log(_load_line(f"{arm} cold load of {name}", load))
                    stages = [c["name"] for c in load["children"]]
                    if ("device_dequant" in stages) != (name == QUANT_NAME):
                        raise AssertionError(f"{arm} {name}: load stages {stages}")
                int8_replies[arm] = raw
                pred = np.asarray(json.loads(raw)["predictions"], dtype=np.float32)
                _check_logits(plain_q, TIER_SHAPE, ids, pred)
                if arm == "pipelined":
                    rng = np.random.default_rng(seed + 22)
                    url = f"{base}/{QUANT_NAME}/versions/1:predict"
                    for shape in QUANT_SHAPES:
                        sids = rng.integers(0, art.vocab, size=shape, dtype=np.int64)
                        status, out, dt = _post(url, {"instances": sids.tolist()}, 900.0)
                        requests += 1
                        if status != 200:
                            raise AssertionError(f"int8 :predict {shape} answered {status}")
                        spred = np.asarray(out["predictions"], dtype=np.float32)
                        if spred.shape != (shape[0], art.vocab) or not np.isfinite(spred).all():
                            raise AssertionError(f"int8 :predict {shape}: {spred.shape}")
                        _check_logits(plain_q, shape, sids, spred)
                        log(f"  int8 :predict {shape}: {dt * 1e3:.1f} ms (warm, host clock)")
                launches = A.FLASH_LAUNCHES.value
                want = art.layers * (requests + 2)  # + the two disk loads' warm-ups
                log(f"[{arm}] flash_attention launches {launches} (n_layers {art.layers} x "
                    f"({requests} requests + 2 warm-up forwards) = {want})")
                if launches != want:
                    raise AssertionError(f"[{arm}] flash launches {launches} != {want}")
                flash += launches
            finally:
                node.close()
        if int8_replies["serialized"] != int8_replies["pipelined"]:
            raise AssertionError("the int8 model's serialized and pipelined replies differ")
        log("int8 replies of the serialized and the pipelined load: byte for byte equal")

        # (3) greedy :generate on the continuous paged engine
        cfg = config_from_dict(art.node_config(
            "serve", generate_engine="continuous", generate_slots=8, generate_chunk_tokens=8,
            kv_page_tokens=16))
        node = build_node(cfg, device="cuda")
        try:
            url = (f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models/{QUANT_NAME}"
                   "/versions/1:generate")
            rng = np.random.default_rng(seed + 23)
            prompts = [rng.integers(0, art.vocab, size=int(n), dtype=np.int64)
                       for n in rng.integers(*QUANT_PROMPT_RANGE, size=QUANT_PROMPTS)]
            bodies = [{"input_ids": [p.tolist()], "max_new_tokens": QUANT_NEW_TOKENS}
                      for p in prompts]
            status, out, _dt = _post(url, {"input_ids": [list(range(1, 33))],
                                           "max_new_tokens": 8}, 900.0)  # the cold load
            if status != 200:
                raise AssertionError(f"int8 warm-up :generate answered {status}: {out}")
            with _Counted(qart, node.engine, "quant: int8 generate") as counted:
                t0 = time.monotonic()
                results = _post_many(url, bodies, QUANT_PROMPTS)
                wall = time.monotonic() - t0
            paged += counted.check()
            _check_answers(qart, "quant: int8 generate", prompts, results, QUANT_NEW_TOKENS,
                           LOGITS_TOL)
            _check_drained(node, qart, "quant: int8 generate")
            log(f"  [quant: int8 generate] {QUANT_PROMPTS} greedy requests x "
                f"{QUANT_NEW_TOKENS} tokens: wall {wall * 1e3:.1f} ms, every token within "
                f"{LOGITS_TOL} of the plain path's max logit (teacher-forced), census green")
        finally:
            node.close()

        # (4) the host tier: int8 and bf16 from disk, then promoted
        raw_cfg = art.node_config("serve", max_concurrent_models=1)
        raw_cfg["cache"]["host_tier_bytes"] = 3 * art.nbytes
        node = build_node(config_from_dict(raw_cfg), device="cuda")
        try:
            base = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models"
            A.FLASH_LAUNCHES.reset()
            first, tier_loads = {}, []
            for name, tier in QUANT_TIER_SCHEDULE:
                raw, load = _quant_load(base, name, body)
                if load["attrs"]["tier"] != tier:
                    raise AssertionError(f"{name}: loaded from {load['attrs']['tier']}, "
                                         f"the schedule says {tier}")
                tier_loads.append((name, load))
                if tier == "disk":
                    first[name] = raw
                elif raw != first[name]:
                    raise AssertionError(f"{name}: the promoted reply differs from its disk "
                                         "load's")
                log(_load_line(f"{tier} load of {name}", load))
            launches = A.FLASH_LAUNCHES.value
            node.runtime.drain_demotions()
            counts = {t: node.metrics.reload_source.labels(t).value
                      for t in ("hbm", "host", "disk", "store", "peer")}
            if counts["disk"] != 2 or counts["host"] != 3 or counts["peer"]:
                raise AssertionError(f"reload sources {counts} != disk 2, host 3")
            want = art.layers * (len(QUANT_TIER_SCHEDULE) + 2)
            log(f"[tier] reload sources {counts}; flash_attention launches {launches} "
                f"(n_layers {art.layers} x ({len(QUANT_TIER_SCHEDULE)} requests + 2 warm-up "
                f"forwards) = {want}); every promoted reply its disk load's byte for byte")
            if launches != want:
                raise AssertionError(f"[tier] flash launches {launches} != {want}")
            flash += launches
            entry = node.runtime._host_tier.get(_mid(QUANT_NAME))
            if entry is None or not entry.quant_dtypes:
                raise AssertionError("the tier holds no int8 entry of the int8 model")
            log(f"int8 tier entry: {entry.nbytes} bytes in {len(entry.chunks)} chunks, "
                f"{len(entry.quant_dtypes)} quantized leaves, {entry.hbm_bytes} device bytes "
                f"once dequantized")
            _quant_summary(art, qbytes, loads, tier_loads)
        finally:
            node.close()
        log(f"quant phase launches: flash_attention {flash}, paged_decode_attention {paged}")
        if not flash or not paged:
            raise AssertionError("a kernel of the int8 path never launched")
        kernels["flash_attention"]["launches"] += flash
        kernels["flash_attention"]["launches_quant_phase"] = flash
        kernels["paged_decode_attention"]["launches"] += paged
        kernels["paged_decode_attention"]["launches_quant_phase"] = paged
    finally:
        del plain_q
        torch.cuda.empty_cache()
        # the card's machine caps a run's disk writes: the int8 copies go
        shutil.rmtree(os.path.join(art.store, QUANT_NAME), ignore_errors=True)
        shutil.rmtree(os.path.join(art.work, "cache_serve", QUANT_NAME), ignore_errors=True)


def _mid(name: str):
    from tfservingcache_tpu_torch.types import ModelId

    return ModelId(name, 1)


def _tree_cuda(tree):
    if isinstance(tree, dict):
        return {k: _tree_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_cuda(v) for v in tree]
    return tree.cuda()


def _quant_summary(art, qbytes: int, loads: dict, tier_loads: list) -> None:
    """One line a load path: the int8 model's transfer, dequant and total
    ms beside the bf16 model's, from this call's load spans."""
    def ms(load, stage):
        return _stage_ms(load).get(stage, 0.0)

    def row(what, q, b):
        return (f"  {what}: int8 total {q['duration_s'] * 1e3:.1f} ms (device_transfer "
                f"{ms(q, 'device_transfer'):.1f}, device_dequant {ms(q, 'device_dequant'):.1f}, "
                f"transfer_sync {ms(q, 'transfer_sync'):.1f}) | bf16 total "
                f"{b['duration_s'] * 1e3:.1f} ms (device_transfer "
                f"{ms(b, 'device_transfer'):.1f}, transfer_sync {ms(b, 'transfer_sync'):.1f})")

    log(f"int8 cold path ({nvidia_smi_line()}): params.bin {qbytes} bytes vs bf16 "
        f"{art.nbytes}, {art.layers} layers")
    for arm in ("serialized", "pipelined"):
        log(row(f"{arm} load", loads[arm, QUANT_NAME], loads[arm, "llama7b"]))
    promoted = {name: [ld for n, ld in tier_loads if n == name and ld["attrs"]["tier"] == "host"]
                for name in (QUANT_NAME, "llama7b")}
    for i, ld in enumerate(promoted[QUANT_NAME]):
        log(row(f"promotion {i + 1}", ld, promoted["llama7b"][0]))


def phase_ring(art: Artifact, seed: int, warm_reps: int, kernels: dict) -> None:
    """REST :predict of the "ring" artifact on a node whose runtime is bound
    to RING_SHARDS copies of the card (``TorchModelRuntime(devices=...)``
    behind ``CacheNode``): cold, then warm, at RING_REQUEST_SHAPES. Every
    answer is checked against the plain single-device path, and the
    launches must be n_layers x RING_SHARDS^2 carry launches a ring request
    and n_layers flash launches a fall-through request (+ the load's seq-1
    warm-up forward, which no ring divides). Then one warm (1, 4096) ring
    forward's profile beside the same forward of the one-card "auto" model
    (B2)."""
    import numpy as np
    import torch

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime, next_bucket
    from tfservingcache_tpu_torch.server import CacheNode

    cfg = config_from_dict(art.node_config("ring"))
    runtime = TorchModelRuntime(cfg.serving, devices=[RING_DEVICE] * RING_SHARDS)
    node = CacheNode(cfg, runtime)
    try:
        port = node.start("127.0.0.1")
        url = f"http://127.0.0.1:{port}/v1/models/{art.ring_id.name}/versions/1:predict"
        rng = np.random.default_rng(seed + 5)
        requests = []
        for shape in RING_REQUEST_SHAPES:
            ids = rng.integers(0, art.vocab, size=shape, dtype=np.int64)
            requests += [(shape, ids) for _ in range(1 + warm_reps)]

        # --- the main path: counters to 0, REST requests, counters read ----
        A.CARRY_LAUNCHES.reset()
        A.FLASH_LAUNCHES.reset()
        results = []
        for shape, ids in requests:
            status, body, dt = _post(url, {"instances": ids.tolist()}, timeout=900.0)
            results.append((shape, ids, status, body, dt))
        carry, flash = A.CARRY_LAUNCHES.value, A.FLASH_LAUNCHES.value
        # -------------------------------------------------------------------

        rings = sum(next_bucket(shape[1]) % RING_SHARDS == 0 for shape, _ in requests)
        falls = len(requests) - rings
        want_carry = art.layers * RING_SHARDS**2 * rings
        want_flash = art.layers * (falls + 1)
        log(f"carry launches on the ring path: {carry} (n_layers {art.layers} x "
            f"{RING_SHARDS}^2 hops x {rings} ring requests = {want_carry}); flash launches: "
            f"{flash} (n_layers x ({falls} fall-through requests + the load's warm-up "
            f"forward) = {want_flash})")
        if carry != want_carry or flash != want_flash or not carry:
            raise AssertionError(f"ring phase launches carry {carry} / flash {flash} != "
                                 f"{want_carry} / {want_flash}")
        kernels["flash_attention_carry"]["launches"] = carry
        kernels["flash_attention"]["launches"] += flash
        log(f"cold ring :predict (fetch + load + first request, shape {requests[0][0]}): "
            f"{results[0][4] * 1e3:.1f} ms")
        for shape in RING_REQUEST_SHAPES:
            warm = [r[4] for r in results if r[0] == shape][1:]
            kind = "ring" if next_bucket(shape[1]) % RING_SHARDS == 0 else "falls through to B2"
            log(f"warm ring-node :predict {shape} ({kind}): p50 "
                f"{statistics.median(warm) * 1e3:.2f} ms over {len(warm)} requests (host "
                "clock, localhost HTTP, JSON)")
        checked = set()
        for shape, ids, status, body, _dt in results:
            if status != 200:
                raise AssertionError(f"ring :predict {shape} answered {status}: {body}")
            pred = np.asarray(body["predictions"], dtype=np.float32)
            if pred.shape != (shape[0], art.vocab) or not np.isfinite(pred).all():
                raise AssertionError(f"ring :predict {shape}: predictions {pred.shape}, finite="
                                     f"{bool(np.isfinite(pred).all())}")
            if shape not in checked:
                checked.add(shape)
                _check_logits(art.plain_model, shape, ids, pred)
        torch.cuda.empty_cache()

        # one warm (1, 4096) forward: the ring module (B4 apart) and the
        # one-card "auto" model on the same weights (B2)
        ring_model = runtime._resident.get(art.ring_id, touch=False).module
        dev_in = {"input_ids": torch.from_numpy(
            rng.integers(0, art.vocab, size=RING_REQUEST_SHAPES[0], dtype=np.int64)).cuda()}
        for name, model, matches in (
                ("ring, 4 shards on one card", ring_model, ("flash_attention_carry",)),
                ("one-card auto (B2)", art.plain_model, ("flash_fwd_kernel",))):
            def forward():
                with torch.inference_mode():
                    model(dev_in)
                torch.cuda.synchronize()

            fwd_ms = host_ms(forward, reps=3)
            by_kernel = device_kernels(lambda: model(dev_in))
            prof = device_kernel_ms(None, matches, by_kernel)
            if prof is None:
                log(f"  (1, 4096) forward, {name}: {fwd_ms:.2f} ms host clock; device time "
                    "not measured (the profiler saw none)")
                continue
            busy, (attn,) = prof
            log(f"  (1, 4096) forward, {name}: {fwd_ms:.2f} ms host clock; device kernels "
                f"{busy:.2f} ms (busy share {busy / fwd_ms:.3f}, torch.profiler); "
                f"{matches[0]} {attn:.3f} ms = {attn / busy:.3f} of device time, "
                f"{attn / art.layers:.4f} ms a layer")
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
            log("    largest kernels: " + "; ".join(
                f"{ms / busy:.3f} {key[:60]}" for key, ms in top))
        log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finally:
        node.close()


def _teacher_forced_logits(plain_model, prompt, tokens):
    """The plain path's logits (``attention_reference`` in every layer) over
    prompt + emitted tokens: row j is the distribution token j was drawn
    from. -> (len(tokens), V) f32 on the host."""
    import numpy as np
    import torch

    from tfservingcache_tpu_torch.ops import attention as A

    seq = np.concatenate([prompt, tokens[:-1]]).astype(np.int32)[None]
    with torch.inference_mode():
        logits = plain_model({"input_ids": torch.from_numpy(seq).cuda()},
                             attention_fn=A.attention_reference)["logits"][0]
        return logits[len(prompt) - 1:].cpu().numpy()


def _check_greedy(art, prompt, tokens, tol, what) -> float:
    """Every emitted token's plain logit lies within ``tol`` of its
    position's maximum (a served argmax, up to bf16/int8 near-ties).
    -> the largest gap."""
    import numpy as np

    logits = _teacher_forced_logits(art.plain_model, prompt, tokens)
    gap = logits.max(-1) - logits[np.arange(len(tokens)), tokens]
    worst = float(gap.max())
    if not worst <= tol:
        j = int(gap.argmax())
        raise AssertionError(f"{what}: token {j} ({tokens[j]}) is {worst} below the plain "
                             f"path's max logit (tolerance {tol})")
    return worst


def _post_many(url, bodies, clients):
    """POST every body from ``clients`` threads at once. -> [(status, body,
    seconds)] in the order of ``bodies``."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=clients) as pool:
        return list(pool.map(lambda b: _post(url, b, timeout=900.0), bodies))


def _decode_chunk_breakdown(rt, model_id, layers: int, chunk: int = 8,
                            prompt_tokens: int = 600) -> None:
    """One warm decode chunk with every lane live at ``prompt_tokens``
    (the arena rows are whatever earlier rows left, fine for timing): host
    clock, device kernel time under torch.profiler, the paged kernel's
    share. Runs on the runtime directly while the engine is idle, and
    hands every page back."""
    st = rt._slot_states[model_id]
    for lane in range(st.slots):
        if not st.reserve_pages(lane, prompt_tokens + 8 * chunk):
            raise AssertionError("arena too small for the chunk breakdown")
        st.pos[lane], st.tok[lane], st.active[lane] = prompt_tokens, 1, True
        st.temps[lane], st.topks[lane] = 0.0, 0
    try:
        def one_chunk():
            rt.slot_decode_chunk(st, chunk)  # ends in a device-to-host copy

        ms = host_ms(one_chunk, reps=3)
        # the name family: the kernel and, with the page axis split, its combine kernel
        prof = device_kernel_ms(one_chunk, ("paged_decode_attention",))
    finally:
        for lane in range(st.slots):
            st.release_pages(lane)
        st.active[:] = False
        st.pos[:] = 0
    st.check_page_conservation()
    if prof is None:
        log(f"  warm decode chunk ({st.slots} lanes at {prompt_tokens} tokens, {chunk} steps): "
            f"{ms:.2f} ms host clock; device time not measured (the profiler saw none)")
        return
    busy, (paged,) = prof
    log(f"  warm decode chunk ({st.slots} lanes at {prompt_tokens} tokens, {chunk} steps): "
        f"{ms:.2f} ms host clock; device kernels {busy:.2f} ms (busy share {busy / ms:.3f}, "
        f"torch.profiler); paged kernel {paged:.3f} ms = {paged / busy:.3f} of device time, "
        f"{paged / (chunk * layers):.4f} ms a launch")


def _spec_round_breakdown(rt, model_id, layers: int, prompt_tokens: int = 600) -> None:
    """One warm speculative round with every lane live at
    ``prompt_tokens`` on both arenas (rows are whatever earlier rows left,
    fine for timing): host clock, device kernel time under torch.profiler,
    the draft's decode kernel's (B1) and the target's verify kernel's (B3)
    shares. Runs on the runtime directly while the engine is idle,
    and hands every page back."""
    st = rt._slot_states[model_id]
    d_st = st.spec_draft
    budget = prompt_tokens + 64  # the rounds below advance pos by <= spec + 1 each
    for lane in range(st.slots):
        if not (st.reserve_pages(lane, budget) and d_st.reserve_pages(lane, budget)):
            raise AssertionError("arena too small for the round breakdown")
        st.pos[lane], st.tok[lane], st.active[lane] = prompt_tokens, 1, True
        st.temps[lane], st.topks[lane] = 0.0, 0
    try:
        def one_round():
            rt.slot_decode_spec_round(st)  # ends in a device-to-host copy

        ms = host_ms(one_round, reps=3)
        prof = device_kernel_ms(
            one_round, ("paged_decode_attention", "paged_verify_attention"))
    finally:
        for lane in range(st.slots):
            st.release_pages(lane)
            d_st.release_pages(lane)
        st.active[:] = False
        st.pos[:] = 0
    st.check_page_conservation()
    d_st.check_page_conservation()
    what = (f"  warm spec round ({st.slots} lanes at {prompt_tokens} tokens, spec "
            f"{st.spec_tokens}): {ms:.2f} ms host clock")
    if prof is None:
        log(f"{what}; device time not measured (the profiler saw none)")
        return
    busy, (decode, verify) = prof
    log(f"{what}; device kernels {busy:.2f} ms (busy share {busy / ms:.3f}, torch.profiler); "
        f"draft decode kernel (B1) {decode:.3f} ms = {decode / busy:.3f} of device time; "
        f"target verify kernel (B3) {verify:.3f} ms = {verify / busy:.3f}, "
        f"{verify / layers:.4f} ms a launch")


def _continuous_arm(art, name, serving, prompts, tol, top1: bool, draft_layers: int = 0,
                    repeats=()):
    """One continuous-engine arm on a fresh node: a warm-up request, the
    concurrent greedy burst, then ``repeats`` one after another, optionally
    an unseeded top_k=1 request. Every response checked; the census must be
    green (on both arenas with a draft; with the index's holds counted when
    prefix sharing is on, and then a full reclaim must hand back every
    page) and the kernels' launches must equal what the engine ran: paged =
    n_layers x plain decode steps + draft_layers x (spec + 1) x spec rounds,
    verify = n_layers x (spec rounds + prefill chunks), where the prefill
    chunks are also counted from the prompts: ceil(p / chunk) of every
    prompt longer than the chunk (none with a draft, whose engine prefills
    in one dispatch). -> (node, its :generate url, the arm's paged
    launches, its verify launches, greedy tokens of prompts + repeats)."""
    import numpy as np

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.server import build_node

    # one disk cache for the arms' nodes, one after another: each node of
    # its own would copy the artifact and its drafts again, and the card's
    # machine caps what a run writes to its disk
    cfg = config_from_dict(art.node_config(
        "gen", generate_engine="continuous", generate_slots=8, generate_chunk_tokens=8,
        kv_page_tokens=16, **serving))
    spec = cfg.serving.spec_tokens
    node = build_node(cfg, device="cuda")
    url = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models/llama7b/versions/1:generate"
    n_new = GEN_NEW_TOKENS
    bodies = [{"input_ids": [p.tolist()], "max_new_tokens": n_new} for p in prompts]
    warm_prompt = prompts[0][:32]
    peak = _watch_page_stats(node.runtime)
    # --- the main path: counters to 0, the arm's requests, counters read ---
    A.PAGED_LAUNCHES.reset()
    A.VERIFY_LAUNCHES.reset()
    t0 = time.monotonic()
    warm = _post(url, {"input_ids": [warm_prompt.tolist()], "max_new_tokens": 8}, 900.0)
    cold_s = time.monotonic() - t0
    t0 = time.monotonic()
    results = _post_many(url, bodies, GEN_CLIENTS)
    wall = time.monotonic() - t0
    results += [_post(url, {"input_ids": [p.tolist()], "max_new_tokens": n_new}, 900.0)
                for p in repeats]
    top1_res = None
    if top1:
        top1_res = _post(url, dict(bodies[0], temperature=0.8, top_k=1), 900.0)
    launches = A.PAGED_LAUNCHES.value
    verify = A.VERIFY_LAUNCHES.value
    # ------------------------------------------------------------------------
    eng = node.engine
    size = eng.prefill_chunk_tokens
    sent = [warm_prompt, *prompts, *repeats] + ([prompts[0]] if top1 else [])
    want_chunks = 0 if draft_layers or not size else sum(
        -(-len(p) // size) for p in sent if len(p) > size)
    expected = art.layers * eng.decode_steps + draft_layers * (spec + 1) * eng.spec_rounds
    expected_verify = art.layers * (eng.spec_rounds + eng.prefill_chunks)
    log(f"  [{name}] paged kernel launches: {launches} (n_layers {art.layers} x decode steps "
        f"{eng.decode_steps} + draft layers {draft_layers} x (spec + 1) x spec rounds "
        f"{eng.spec_rounds} = {expected}); verify kernel launches: {verify} (n_layers "
        f"{art.layers} x (spec rounds {eng.spec_rounds} + prefill chunks {eng.prefill_chunks}) "
        f"= {expected_verify}; prefill chunks from the prompts at chunk {size}: {want_chunks}); "
        f"chunks {eng.chunks}, admitted {eng.admitted}, mean lanes per plain decode step "
        f"{eng.lane_steps / max(1, eng.decode_steps):.2f} (warm-up request included)")
    if launches != expected or launches == 0 or verify != expected_verify:
        raise AssertionError(f"[{name}] launches paged {launches} / verify {verify} != "
                             f"{expected} / {expected_verify}")
    if eng.prefill_chunks != want_chunks:
        raise AssertionError(f"[{name}] {eng.prefill_chunks} prefill chunks, the prompts "
                             f"need {want_chunks}")
    if draft_layers and not verify:
        raise AssertionError(f"[{name}] no speculative round ran")
    if warm[0] != 200:
        raise AssertionError(f"[{name}] warm-up :generate answered {warm[0]}: {warm[1]}")
    greedy = []
    worst = 0.0
    for p, (status, body, _dt) in zip([*prompts, *repeats], results):
        if status != 200:
            raise AssertionError(f"[{name}] :generate answered {status}: {body}")
        toks = np.asarray(body["tokens"])
        if toks.shape != (1, n_new) or not ((toks >= 0) & (toks < art.vocab)).all():
            raise AssertionError(f"[{name}] tokens {toks.shape}, in vocab "
                                 f"{bool(((toks >= 0) & (toks < art.vocab)).all())}")
        greedy.append(toks[0])
        worst = max(worst, _check_greedy(art, p, toks[0], tol, name))
    st = node.runtime._slot_states[art.model_id]
    for s in (st, st.spec_draft) if draft_layers else (st,):
        s.check_page_conservation()
        if s.prefix_index is not None:
            _check_drained_with_index(node.runtime, s, name, peak)
        if sorted(s.free_pages) != list(range(1, s.arena_pages + 1)):
            raise AssertionError(f"[{name}] pages of {s.model_id} still held after the drain")
    lat = [dt for *_, dt in results[:len(prompts)]]
    ARM_TOK_S[name] = len(prompts) * n_new / wall
    log(f"  [{name}] {len(prompts)} requests x {n_new} tokens from {GEN_CLIENTS} clients: "
        f"wall {wall * 1e3:.1f} ms, {len(prompts) * n_new / wall:.1f} generated tok/s, "
        f"per-request p50 {statistics.median(lat) * 1e3:.1f} ms (host clock, localhost HTTP); "
        f"first request (the node's load, from the arms' shared disk cache after the "
        f"first arm) {cold_s * 1e3:.1f} ms; teacher-forced max gap to the plain "
        f"path's max logit {worst:.4f} (tolerance {tol}); census green, "
        f"{st.arena_pages} pages free ({st.arena_dtype or 'model dtype'} arena, "
        f"{(st.k.nbytes + st.v.nbytes + sum(t.nbytes for t in (st.scales or {}).values())) / 2**30:.2f} GiB)")
    if draft_layers:
        lane_rounds = eng.drafted / spec
        per_round = eng.accepted / max(1.0, lane_rounds)
        log(f"  [{name}] spec rounds {eng.spec_rounds} (lane-rounds {lane_rounds:.0f}), "
            f"{per_round:.3f} tokens emitted per lane-round (spec {spec}: at most {spec + 1}), "
            f"plain decode steps {eng.decode_steps}; draft census green "
            f"({st.spec_draft.arena_pages} pages)")
    if top1_res is not None:
        status, body, _dt = top1_res
        if status != 200:
            raise AssertionError(f"[{name}] top_k=1 :generate answered {status}: {body}")
        t1 = np.asarray(body["tokens"])[0]
        diff = np.nonzero(t1 != greedy[0])[0]
        if diff.size:
            # only an exact tie at the top lets a top_k=1 draw leave greedy
            j = int(diff[0])
            logits = _teacher_forced_logits(art.plain_model, prompts[0], greedy[0])[j]
            top = logits.max()
            if not (top - logits[t1[j]] <= tol and top - logits[greedy[0][j]] <= tol):
                raise AssertionError(f"[{name}] top_k=1 left greedy at token {j} off a near-tie")
            log(f"  [{name}] top_k=1 at t=0.8 equals greedy up to token {j}, a near-tie")
        else:
            log(f"  [{name}] top_k=1 at t=0.8 equals greedy ({n_new} tokens)")
    if draft_layers:
        _spec_round_breakdown(node.runtime, art.model_id, art.layers)
    elif size:
        _prefill_chunk_breakdown(node.runtime, art.model_id, art.layers, size)
    else:
        _decode_chunk_breakdown(node.runtime, art.model_id, art.layers)
    return node, url, launches, verify, greedy


def _watch_page_stats(rt) -> dict:
    """Wrap ``rt.slot_decode_chunk`` so that the scheduler thread records the
    arena's ``page_stats()`` before every decode chunk (host bookkeeping
    only) and keep the record with the most shared pages. -> that record,
    filled in as the arm runs."""
    peak: dict = {}
    real = rt.slot_decode_chunk

    def watched(state, chunk):
        stats = state.page_stats()
        if stats["shared"] >= peak.get("shared", -1):
            peak.clear()
            peak.update(stats)
        return real(state, chunk)

    rt.slot_decode_chunk = watched
    return peak


def _check_drained_with_index(rt, st, name, peak) -> None:
    """After a drain with prefix sharing on: every page free or held by the
    index alone (census green), then a full reclaim hands every page back."""
    stats = st.page_stats()
    idx = st.prefix_index
    log(f"  [{name}] after the drain: {stats} (index: {len(idx.held_pages())} pages held, "
        f"{idx.total_bytes} bytes, lookups {idx.hits} hits / {idx.exact_hits} exact / "
        f"{idx.misses} misses); peak before a decode chunk {peak}")
    if stats["shared"] or stats["private"] or stats["free"] + stats["cached"] != st.arena_pages:
        raise AssertionError(f"[{name}] drained arena {stats}: free + cached != "
                             f"{st.arena_pages}")
    freed = rt.reclaim_prefix_pages(st, st.arena_pages)
    st.check_page_conservation()
    log(f"  [{name}] reclaim_prefix_pages(state, {st.arena_pages}) freed {freed} pages; "
        f"{len(st.free_pages)} of {st.arena_pages} free")
    if freed != stats["cached"]:
        raise AssertionError(f"[{name}] reclaim freed {freed} of {stats['cached']} cached pages")


def _prefill_chunk_breakdown(rt, model_id, layers: int, chunk: int,
                             prompt_tokens: int = 1024) -> None:
    """A warm chunked prefill of one ``prompt_tokens``-token prompt on a lane
    of the idle engine's state (``slot_prefill_chunk`` chunk by chunk, the
    last chunk's logits read back): host clock, device kernel time under
    torch.profiler and the verify kernel's (B3) share and ms a launch,
    beside a one-dispatch prefill of the same prompt (``slot_prefill``,
    plain einsum attention as in the reference). Hands every page back."""
    import numpy as np
    import torch

    st = rt._slot_states[model_id]
    prompt = np.random.default_rng(1).integers(0, 32000, prompt_tokens).astype(np.int32)
    if not st.reserve_pages(0, prompt_tokens + 8):
        raise AssertionError("arena too small for the prefill breakdown")
    n_chunks = -(-prompt_tokens // chunk)
    try:
        def chunked():
            for start in range(0, prompt_tokens, chunk):
                last = rt.slot_prefill_chunk(model_id, st, 0, prompt[start:start + chunk],
                                             start, chunk)
            last.cpu()

        ms = host_ms(chunked, reps=3)
        prof = device_kernel_ms(chunked, ("paged_verify_attention",))

        def monolithic():
            rt.slot_prefill(model_id, prompt, 0.0, 0, 0)
            torch.cuda.synchronize()

        mono_ms = host_ms(monolithic, reps=3)
    finally:
        st.release_pages(0)
    st.check_page_conservation()
    what = (f"  warm chunked prefill ({prompt_tokens} tokens in {n_chunks} chunks of {chunk}, "
            f"{st.arena_dtype or 'model dtype'} arena): {ms:.2f} ms host clock "
            f"({ms / n_chunks:.2f} ms a chunk); one-dispatch prefill of the same prompt "
            f"{mono_ms:.2f} ms")
    if prof is None:
        log(f"{what}; device time not measured (the profiler saw none)")
        return
    busy, (verify,) = prof
    log(f"{what}; device kernels {busy:.2f} ms (busy share {busy / ms:.3f}, torch.profiler); "
        f"verify kernel (B3) {verify:.3f} ms = {verify / busy:.3f} of device time, "
        f"{verify / (n_chunks * layers):.4f} ms a launch (T = {chunk})")


def _compare_to_plain_arm(art, name, prompts, plain, spec_toks, tol) -> None:
    """Spec-on tokens against the plain arm's: identical up to a first
    divergence, where the shared prefix's teacher-forced logits must make
    both tokens a near-tie (each within ``tol`` of the step's max)."""
    import numpy as np

    same = 0
    for p, a, b in zip(prompts, plain, spec_toks):
        diff = np.nonzero(a != b)[0]
        if not diff.size:
            same += 1
            continue
        j = int(diff[0])
        logits = _teacher_forced_logits(art.plain_model, p, a)[j]
        top = logits.max()
        if not (top - logits[a[j]] <= tol and top - logits[b[j]] <= tol):
            raise AssertionError(f"[{name}] leaves the plain arm's tokens at {j} off a near-tie")
    log(f"  [{name}] tokens identical to the plain arm's in {same} of {len(prompts)} "
        "requests; every divergence starts at a near-tie of the plain path")


def _gen_prompts(art, seed: int) -> list:
    """Arm (a)'s GEN_REQUESTS prompts (lengths in GEN_PROMPT_RANGE)."""
    import numpy as np

    rng = np.random.default_rng(seed + 2)
    lo, hi = GEN_PROMPT_RANGE
    return [rng.integers(0, art.vocab, int(n)) for n in rng.integers(lo, hi + 1, GEN_REQUESTS)]


def phase_generate(art: Artifact, seed: int, kernels: dict) -> None:
    """REST :generate: (a) continuous engine over a bf16 arena, (b) the solo
    path, (c) continuous engine over an int8 arena, (d) (a) with speculative
    rounds drafted by an exact copy of the target, (e) (c) with rounds
    drafted by the 1-layer draft, (f) two solo "draft_model" requests, (g)
    (d) over an int8 arena on the first SPEC_INT8_REQUESTS prompts, (h) (a)
    with chunked prefill, (i) (c) with chunked prefill on the first
    CHUNKED_INT8_REQUESTS prompts, (j) shared-prefix prompts with sharing on
    and off, (k) the solo path's prefix cache over two-turn conversations,
    (l) / (l0) / (l8) conversation park and resume, (m) / (m0) priority and
    preemption, (n) streams and (o) crash recovery."""
    import numpy as np

    from tfservingcache_tpu_torch.ops import attention as A

    prompts = _gen_prompts(art, seed)
    log(f"prompt lengths {[len(p) for p in prompts]}, {GEN_NEW_TOKENS} new tokens each")
    node = None
    launches = verify = 0
    try:
        node, url, n, v, plain_greedy = _continuous_arm(art, "a: bf16 arena", {}, prompts,
                                                        LOGITS_TOL, top1=True)
        launches += n
        verify += v
        # (b) the solo path: seeded requests bypass the engine
        body = {"input_ids": [prompts[1].tolist()], "max_new_tokens": GEN_NEW_TOKENS,
                "temperature": 0.8, "top_k": 40, "seed": 7}
        A.PAGED_LAUNCHES.reset()
        solo = [_post(url, body, 900.0) for _ in range(2)]
        solo_launches = A.PAGED_LAUNCHES.value
        for status, out, _dt in solo:
            if status != 200:
                raise AssertionError(f"[b: solo] :generate answered {status}: {out}")
        a, b = (np.asarray(out["tokens"]) for _s, out, _dt in solo)
        if a.shape != (1, GEN_NEW_TOKENS) or not (a == b).all():
            raise AssertionError("[b: solo] the same seed gave other tokens")
        if solo_launches != 0:
            raise AssertionError(f"[b: solo] the paged kernel ran {solo_launches} times")
        logits = _teacher_forced_logits(art.plain_model, prompts[1], a[0])
        kth = np.sort(logits, axis=-1)[:, -40]
        gap = float((kth - logits[np.arange(GEN_NEW_TOKENS), a[0]]).max())
        if not gap <= LOGITS_TOL:
            raise AssertionError(f"[b: solo] a sampled token is {gap} below its step's top-40")
        log(f"  [b: solo] 2 seeded requests (t=0.8, top_k=40, seed=7): identical; every token "
            f"in its step's top-40 of the plain path (largest shortfall {max(gap, 0.0):.4f}, "
            f"tolerance {LOGITS_TOL}); {solo[0][2] * 1e3:.1f} / {solo[1][2] * 1e3:.1f} ms; "
            f"paged kernel launches {solo_launches}")
        node.close()
        node = None
        node, _url, n, v, int8_greedy = _continuous_arm(
            art, "c: int8 arena", {"kv_arena_dtype": "int8"}, prompts, LOGITS_TOL_INT8,
            top1=False)
        launches += n
        verify += v
        node.close()
        node = None
        # (d) speculative rounds drafted by an exact copy of the target: every
        # proposal should be accepted, up to bf16 near-ties between the
        # draft's width-1 and the target's width-(spec+1) forwards
        name = "d: spec, exact-copy draft"
        node, _url, n, v, spec_greedy = _continuous_arm(
            art, name, {"spec_draft_model": "copy", "spec_tokens": SPEC_TOKENS}, prompts,
            LOGITS_TOL, top1=False, draft_layers=art.layers)
        launches += n
        verify += v
        eng = node.engine
        per_round = eng.accepted / max(1.0, eng.drafted / SPEC_TOKENS)
        if not per_round >= 0.8 * (SPEC_TOKENS + 1):
            raise AssertionError(f"[{name}] {per_round:.3f} tokens per lane-round < "
                                 f"0.8 x (spec + 1) = {0.8 * (SPEC_TOKENS + 1)}")
        _compare_to_plain_arm(art, name, prompts, plain_greedy, spec_greedy, LOGITS_TOL)
        node.close()
        node = None
        # (e) the int8 arena with the 1-layer draft (acceptance reported as is)
        node, _url, n, v, _g = _continuous_arm(
            art, "e: spec, 1-layer draft, int8 arena",
            {"kv_arena_dtype": "int8", "spec_draft_model": "layer0", "spec_tokens": SPEC_TOKENS},
            prompts, LOGITS_TOL_INT8, top1=False, draft_layers=art.draft_layers)
        launches += n
        verify += v
        node.close()
        node = None
        node = _solo_draft_arm(art, prompts)
        node.close()
        node = None
        # (g) the exact-copy draft over an int8 arena: accepted rows of B3
        # over int8 pages decide served tokens under the teacher-forced check
        name = "g: spec, exact-copy draft, int8 arena"
        few = prompts[:SPEC_INT8_REQUESTS]
        node, _url, n, v, spec8_greedy = _continuous_arm(
            art, name,
            {"kv_arena_dtype": "int8", "spec_draft_model": "copy", "spec_tokens": SPEC_TOKENS},
            few, LOGITS_TOL_INT8, top1=False, draft_layers=art.layers)
        launches += n
        verify += v
        eng = node.engine
        per_round = eng.accepted / max(1.0, eng.drafted / SPEC_TOKENS)
        if not per_round >= 0.8 * (SPEC_TOKENS + 1):
            raise AssertionError(f"[{name}] {per_round:.3f} tokens per lane-round < "
                                 f"0.8 x (spec + 1) = {0.8 * (SPEC_TOKENS + 1)}")
        _compare_to_plain_arm(art, name, few, int8_greedy, spec8_greedy, LOGITS_TOL_INT8)
        node.close()
        node = None
        # (h) chunked prefill over a bf16 arena: every prompt past the chunk
        # prefills PREFILL_CHUNK tokens a boundary through B3 at T = chunk
        name = "h: chunked prefill, bf16 arena"
        node, _url, n, v, chunked_greedy = _continuous_arm(
            art, name, {"prefill_chunk_tokens": PREFILL_CHUNK}, prompts, LOGITS_TOL, top1=False)
        launches += n
        verify += v
        if not node.engine.prefill_chunks:
            raise AssertionError(f"[{name}] no prefill chunk ran")
        _compare_to_plain_arm(art, name, prompts, plain_greedy, chunked_greedy, LOGITS_TOL)
        node.close()
        node = None
        # (i) the same over an int8 arena: B3 on its SIMT path at T = chunk
        name = "i: chunked prefill, int8 arena"
        few = prompts[:CHUNKED_INT8_REQUESTS]
        node, _url, n, v, chunked8_greedy = _continuous_arm(
            art, name, {"prefill_chunk_tokens": PREFILL_CHUNK, "kv_arena_dtype": "int8"}, few,
            LOGITS_TOL_INT8, top1=False)
        launches += n
        verify += v
        if not node.engine.prefill_chunks:
            raise AssertionError(f"[{name}] no prefill chunk ran")
        _compare_to_plain_arm(art, name, few, int8_greedy, chunked8_greedy, LOGITS_TOL_INT8)
        node.close()
        node = None
        n, v = _shared_prefix_arms(art, seed)
        launches += n
        verify += v
        _solo_prefix_arm(art, prompts)
        launches += _conversation_arms(art, seed)
        launches += _priority_arm(art, seed)
        launches += _stream_and_kill_arms(art, prompts)
    finally:
        if node is not None:
            node.close()
    kernels["paged_decode_attention"]["launches"] += launches
    kernels["paged_verify_attention"]["launches"] += verify


def _shared_prefix_arms(art, seed: int) -> tuple[int, int]:
    """(j) shared prefix over a bf16 arena (``kv_share_prefix_bytes``):
    GEN_REQUESTS prompts of one seeded SHARED_PREFIX_TOKENS-token system
    prompt + a distinct seeded suffix from GEN_CLIENTS clients, then
    SHARED_REPEATS exact repeats of earlier prompts (no prefill at all);
    then the same prompts on a node with sharing off, whose tokens the
    sharing arm must equal up to near-ties. Prints the hits by kind, the
    prefill tokens saved and the arena's page split at its peak. -> (paged,
    verify) launches of both arms."""
    import numpy as np

    rng = np.random.default_rng(seed + 7)
    system = rng.integers(0, art.vocab, SHARED_PREFIX_TOKENS)
    lo, hi = SHARED_SUFFIX_RANGE
    prompts = [np.concatenate([system, rng.integers(0, art.vocab, int(n))])
               for n in rng.integers(lo, hi + 1, GEN_REQUESTS)]
    repeats = [prompts[int(i)] for i in rng.choice(GEN_REQUESTS, SHARED_REPEATS, replace=False)]
    log(f"(j) prompts: a {SHARED_PREFIX_TOKENS}-token system prompt + suffixes of "
        f"{[len(p) - SHARED_PREFIX_TOKENS for p in prompts]} tokens, then {SHARED_REPEATS} "
        "exact repeats")
    name = "j: shared prefix, bf16 arena"
    node = None
    try:
        node, _url, n1, v1, shared = _continuous_arm(
            art, name, {"kv_share_prefix_bytes": SHARE_BYTES}, prompts, LOGITS_TOL, top1=False,
            repeats=repeats)
        eng = node.engine
        sent = [prompts[0][:32], *prompts, *repeats]
        total = sum(len(p) for p in sent)
        log(f"  [{name}] prefix hits: exact {eng.prefix_hits_exact}, shared "
            f"{eng.prefix_hits_shared}, dense {eng.prefix_hits_dense}; prefill tokens "
            f"{eng.prefill_tokens} of {total} prompt tokens ({total - eng.prefill_tokens} "
            f"saved, {(total - eng.prefill_tokens) / total:.3f})")
        if eng.prefix_hits_exact < 1 or eng.prefix_hits_shared < 1:
            raise AssertionError(f"[{name}] hits exact {eng.prefix_hits_exact} / shared "
                                 f"{eng.prefix_hits_shared}: want at least one of each")
        node.close()
        node = None
        off = "j0: sharing off, bf16 arena"
        node, _url, n2, v2, plain = _continuous_arm(
            art, off, {}, prompts, LOGITS_TOL, top1=False, repeats=repeats)
        _compare_to_plain_arm(art, name, [*prompts, *repeats], plain, shared, LOGITS_TOL)
    finally:
        if node is not None:
            node.close()
    return n1 + n2, v1 + v2


def _solo_prefix_arm(art, prompts) -> None:
    """(k) the solo path's prefix cache (``prefix_cache_bytes``) on a
    "coalesce" node: a greedy two-turn conversation (turn 2 = turn 1's
    prompt + its GEN_NEW_TOKENS tokens + TURN2_NEW_TOKENS new ones) whose
    turn 2 must hit turn 1's entry, then the same with the 1-layer
    ``"draft_model"``; every turn's tokens equal a cache-off node's up to
    near-ties and pass the teacher-forced check, and no paged kernel runs
    (the solo path keeps dense caches)."""
    import numpy as np

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.server import build_node

    name = "k: solo prefix cache"
    rng = np.random.default_rng(len(prompts))
    turns = {}
    hits = {}
    lookups = []  # (kind, turn, hit) on the cache-on node
    for arm, serving in (("on", {"prefix_cache_bytes": PREFIX_CACHE_BYTES}), ("off", {})):
        node = build_node(config_from_dict(art.node_config(f"k_{arm}", **serving)), device="cuda")
        try:
            url = (f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models/llama7b/"
                   "versions/1:generate")
            A.PAGED_LAUNCHES.reset()
            A.VERIFY_LAUNCHES.reset()
            for kind, first, extra in (("plain", prompts[3], {}),
                                       ("draft_model", prompts[4],
                                        {"draft_model": "layer0", "spec_tokens": SPEC_TOKENS})):
                new = turns.setdefault((kind, "new"),
                                       rng.integers(0, art.vocab, TURN2_NEW_TOKENS))
                out = []
                prompt = first
                for turn in range(2):
                    t0 = time.monotonic()
                    status, body, _dt = _post(url, {"input_ids": [prompt.tolist()],
                                                    "max_new_tokens": GEN_NEW_TOKENS, **extra},
                                              900.0)
                    dt = time.monotonic() - t0
                    if status != 200:
                        raise AssertionError(f"[{name}] {arm} {kind} turn {turn + 1} answered "
                                             f"{status}: {body}")
                    toks = np.asarray(body["tokens"])[0]
                    pc = node.runtime._prefix_cache
                    if pc is not None:
                        lookups.append((kind, turn + 1, pc.hits - sum(h for *_, h in lookups)))
                    worst = _check_greedy(art, prompt, toks, LOGITS_TOL, name)
                    log(f"  [{name}] cache {arm}, {kind}, turn {turn + 1} (prompt {len(prompt)} "
                        f"tokens): {dt * 1e3:.1f} ms host clock, teacher-forced max gap "
                        f"{worst:.4f}")
                    out.append((prompt, toks))
                    prompt = np.concatenate([prompt, toks, new])
                turns[(kind, arm)] = out
            if A.PAGED_LAUNCHES.value or A.VERIFY_LAUNCHES.value:
                raise AssertionError(f"[{name}] the solo path launched paged kernels")
            pc = node.runtime._prefix_cache
            hits[arm] = None if pc is None else (pc.hits, pc.misses, len(pc), pc.total_bytes)
        finally:
            node.close()
    log(f"  [{name}] prefix cache (hits, misses, entries, bytes): {hits['on']}; hits by "
        f"(path, turn): {lookups}")
    want = [("plain", 1, 0), ("plain", 2, 1), ("draft_model", 1, 0), ("draft_model", 2, 1)]
    if lookups != want or hits["on"][:2] != (2, 2):
        raise AssertionError(f"[{name}] want a miss at turn 1 and a hit at turn 2 on both "
                             f"paths: {lookups}, {hits['on']}")
    for kind in ("plain", "draft_model"):
        on, off = turns[(kind, "on")], turns[(kind, "off")]
        # turn 1 runs the same path cache on or off; turn 2's prompt follows
        # each node's own turn 1, so compare it only when turn 1 agreed
        _compare_to_plain_arm(art, f"{name}, {kind}, turn 1", [on[0][0]], [off[0][1]],
                              [on[0][1]], LOGITS_TOL)
        if np.array_equal(on[0][1], off[0][1]):
            _compare_to_plain_arm(art, f"{name}, {kind}, turn 2", [on[1][0]], [off[1][1]],
                                  [on[1][1]], LOGITS_TOL)


def _solo_draft_arm(art, prompts):
    """(f) two solo "draft_model" requests with the 1-layer draft on a fresh
    continuous node: greedy tokens checked against the plain path, identical
    to each other; the engine's counters and the paged kernels' launches
    must not move (the solo path runs dense caches, no kernel). -> the
    node."""
    import numpy as np

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.server import build_node

    name = "f: solo draft_model"
    cfg = config_from_dict(art.node_config(  # the arms' shared disk cache
        "gen", generate_engine="continuous", generate_slots=8, kv_page_tokens=16))
    node = build_node(cfg, device="cuda")
    url = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models/llama7b/versions/1:generate"
    body = {"input_ids": [prompts[2].tolist()], "max_new_tokens": GEN_NEW_TOKENS,
            "draft_model": "layer0", "spec_tokens": SPEC_TOKENS}
    eng, rt = node.engine, node.runtime
    before = (eng.admitted, eng.chunks, eng.spec_rounds, eng.decode_steps)
    A.PAGED_LAUNCHES.reset()
    A.VERIFY_LAUNCHES.reset()
    res = [_post(url, body, 900.0) for _ in range(2)]
    paged, verify = A.PAGED_LAUNCHES.value, A.VERIFY_LAUNCHES.value
    after = (eng.admitted, eng.chunks, eng.spec_rounds, eng.decode_steps)
    for status, out, _dt in res:
        if status != 200:
            raise AssertionError(f"[{name}] :generate answered {status}: {out}")
    a, b = (np.asarray(out["tokens"]) for _s, out, _dt in res)
    if a.shape != (1, GEN_NEW_TOKENS) or not (a == b).all():
        raise AssertionError(f"[{name}] two greedy requests gave other tokens")
    worst = _check_greedy(art, prompts[2], a[0], LOGITS_TOL, name)
    if after != before or paged or verify:
        raise AssertionError(f"[{name}] the engine path moved: counters {before} -> {after}, "
                             f"paged {paged}, verify {verify} launches")
    rounds, emitted = rt.spec_rounds["solo"], rt.spec_emitted["solo"]
    if not rounds:
        raise AssertionError(f"[{name}] no speculative round ran")
    log(f"  [{name}] 2 greedy requests with the 1-layer draft (spec {SPEC_TOKENS}): identical; "
        f"teacher-forced max gap {worst:.4f} (tolerance {LOGITS_TOL}); {rounds} rounds, "
        f"{emitted / rounds:.3f} tokens a round; {res[0][2] * 1e3:.1f} / {res[1][2] * 1e3:.1f} "
        f"ms; engine counters and paged/verify launches unchanged ({paged}, {verify})")
    return node


def _gen_node(art, name, **serving):
    """A fresh continuous node like arm (a)'s (8 slots, chunk 8, pages of
    16) with ``serving`` on top, and one warm request (32 tokens, 8 new)
    through it, so that the cold load stays out of the arm's numbers. The
    nodes of arms (l)-(o) share one disk cache, so that the artifact is
    copied once for all of them (the card's machine counts every byte the
    run writes). -> (node, its :generate url)."""
    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.server import build_node

    cfg = config_from_dict(art.node_config(
        "slo", generate_engine="continuous", generate_slots=8, generate_chunk_tokens=8,
        kv_page_tokens=16, **serving))
    node = build_node(cfg, device="cuda")
    url = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models/llama7b/versions/1:generate"
    status, body, _dt = _post(url, {"input_ids": [list(range(1, 33))], "max_new_tokens": 8},
                              900.0)
    if status != 200:
        node.close()
        raise AssertionError(f"[{name}] warm-up :generate answered {status}: {body}")
    return node, url


class _Counted:
    """The paged and verify launches and the engine's decode steps over a
    window: counters to 0 at ``__enter__``, read at ``__exit__``; ``check``
    holds paged = n_layers x plain decode steps and verify = 0 (these arms
    run neither rounds nor chunked prefill)."""

    def __init__(self, art, eng, name):
        self.art, self.eng, self.name = art, eng, name

    def __enter__(self):
        from tfservingcache_tpu_torch.ops import attention as A

        A.PAGED_LAUNCHES.reset()
        A.VERIFY_LAUNCHES.reset()
        self.steps0 = self.eng.decode_steps
        return self

    def __exit__(self, *exc):
        from tfservingcache_tpu_torch.ops import attention as A

        self.paged, self.verify = A.PAGED_LAUNCHES.value, A.VERIFY_LAUNCHES.value
        self.steps = self.eng.decode_steps - self.steps0
        return False

    def check(self) -> int:
        want = self.art.layers * self.steps
        log(f"  [{self.name}] paged kernel launches {self.paged} (n_layers {self.art.layers} x "
            f"plain decode steps {self.steps} = {want}); verify launches {self.verify}")
        if self.paged != want or not self.paged or self.verify:
            raise AssertionError(f"[{self.name}] launches paged {self.paged} / verify "
                                 f"{self.verify} != {want} / 0")
        return self.paged


class _ParkWatch:
    """Wraps a runtime's ``park_lane`` and ``slot_resume_prefill`` (host
    bookkeeping around the real calls): every park's history length, pages,
    bytes and host ms, with a device copy of the lane's pages at the park;
    every resume's (p, covered, n_pages) and host ms (synchronized), and
    whether the pages it wrote equal the copy taken at the park bit for bit
    (``torch.equal``, values and int8 scales)."""

    def __init__(self, rt):
        import torch

        from tfservingcache_tpu_torch.models import generation as G
        from tfservingcache_tpu_torch.runtime.model_runtime import _arena

        self.parks: list[tuple] = []    # (key, history len, pages, nbytes, ms)
        self.resumes: list[tuple] = []  # (key, p, covered, n_pages, ms)
        self.mismatches = 0
        self._snap: dict[bytes, dict] = {}
        self.real_park, self.real_resume = rt.park_lane, rt.slot_resume_prefill

        def park(state, lane, history):
            t0 = time.monotonic()
            parked = self.real_park(state, lane, history)
            ms = (time.monotonic() - t0) * 1e3
            if parked is not None:
                n = parked.pages_k.shape[1]
                rows = G.pages_export(_arena(state), state.lane_pages[lane][:n])
                self._snap[parked.history.tobytes()] = {k: t.clone() for k, t in rows.items()}
                self.parks.append((_key(history), len(history), n, parked.nbytes, ms))
            return parked

        def resume(model_id, state, lane, prompt, parked, covered, n_pages, *rest):
            t0 = time.monotonic()
            out = self.real_resume(model_id, state, lane, prompt, parked, covered, n_pages,
                                   *rest)
            torch.cuda.synchronize()
            ms = (time.monotonic() - t0) * 1e3
            rows = G.pages_export(_arena(state), state.lane_pages[lane][:n_pages])
            want = self._snap.get(parked.history.tobytes())
            if want is None or not all(torch.equal(t, want[k][:, :n_pages])
                                       for k, t in rows.items()):
                self.mismatches += 1
            self.resumes.append((_key(prompt), len(prompt), covered, n_pages, ms))
            return out

        rt.park_lane, rt.slot_resume_prefill = park, resume


def _key(prompt) -> bytes:
    import numpy as np

    return bytes(np.asarray(prompt[:8], np.int32))


def _check_answers(art, name, prompts, results, n_new, tol) -> list:
    """Every answer 200 with (1, n_new) in-vocab tokens that pass the
    teacher-forced check. -> the token rows."""
    import numpy as np

    rows = []
    for p, (status, body, _dt) in zip(prompts, results):
        if status != 200:
            raise AssertionError(f"[{name}] :generate answered {status}: {body}")
        toks = np.asarray(body["tokens"])
        if toks.shape != (1, n_new) or not ((toks >= 0) & (toks < art.vocab)).all():
            raise AssertionError(f"[{name}] tokens {toks.shape} out of shape or vocab")
        _check_greedy(art, p, toks[0], tol, name)
        rows.append(toks[0])
    return rows


def _check_drained(node, art, name) -> None:
    st = node.runtime._slot_states[art.model_id]
    st.check_page_conservation()
    if sorted(st.free_pages) != list(range(1, st.arena_pages + 1)):
        raise AssertionError(f"[{name}] pages still held after the drain")
    if node.engine.park_failures:
        raise AssertionError(f"[{name}] {node.engine.park_failures} parks failed")


def _conversation_turns(art, node, url, name, firsts, seconds=None, suffixes=None, conv=True,
                        tol=LOGITS_TOL):
    """Turn 1 of every conversation from CONV_CLIENTS clients, then every
    turn 2 (``seconds``, or turn 1's prompt + its tokens + ``suffixes``),
    each answer checked. -> (turn-1 tokens, turn-2 prompts, turn-2 tokens,
    turn-2 host seconds a request, the launch window, the engine's prefill
    tokens over turn 2)."""
    import numpy as np

    eng = node.engine

    def bodies(prompts):
        return [{"input_ids": [p.tolist()], "max_new_tokens": GEN_NEW_TOKENS,
                 **({"conversation_id": f"conv{i}"} if conv else {})}
                for i, p in enumerate(prompts)]

    with _Counted(art, eng, name) as counted:
        res1 = _post_many(url, bodies(firsts), CONV_CLIENTS)
        t1 = _check_answers(art, name, firsts, res1, GEN_NEW_TOKENS, tol)
        if seconds is None:
            seconds = [np.concatenate([p, t, s]) for p, t, s in zip(firsts, t1, suffixes)]
        pf0 = eng.prefill_tokens
        res2 = _post_many(url, bodies(seconds), CONV_CLIENTS)
        prefilled = eng.prefill_tokens - pf0
    t2 = _check_answers(art, name, seconds, res2, GEN_NEW_TOKENS, tol)
    return t1, seconds, t2, [dt for *_, dt in res2], counted, prefilled


def _conversation_arms(art, seed: int) -> int:
    """(l) two-turn conversations with the conversation tier (host + disk),
    then (o) on the same node: the third turns under kill_engine; (l0) the
    same prompts with the tier off; (l1) (l) on a fresh node without the
    park watch, for its latency; (l8) the first conversations over an int8
    arena. -> the paged launches of the arms."""
    import numpy as np

    rng = np.random.default_rng(seed + 11)
    lo, hi = CONV_PROMPT_RANGE
    firsts = [rng.integers(0, art.vocab, int(n)) for n in rng.integers(lo, hi + 1, CONV_CLIENTS)]
    suffixes = [rng.integers(0, art.vocab, int(n))
                for n in rng.integers(CONV_SUFFIX_RANGE[0], CONV_SUFFIX_RANGE[1] + 1, CONV_CLIENTS)]
    thirds = [rng.integers(0, art.vocab, 16) for _ in range(CONV_CLIENTS)]
    log(f"(l) turn-1 prompts {[len(p) for p in firsts]}, turn-2 suffixes "
        f"{[len(s) for s in suffixes]}, {GEN_NEW_TOKENS} new tokens a turn")
    tier = {"conversation_kv_bytes": CONV_KV_BYTES,
            "conversation_kv_disk_bytes": CONV_KV_DISK_BYTES}
    launches = 0
    name = "l: conversation park/resume, bf16 arena"
    node, url = _gen_node(art, "l", conversation_kv_dir=os.path.join(art.work, "conv_kv_l"),
                          **tier)
    try:
        eng, rt = node.engine, node.runtime
        watch = _ParkWatch(rt)
        t1, seconds, t2, lat_l, counted, prefilled = _conversation_turns(
            art, node, url, name, firsts, suffixes=suffixes)
        launches += counted.check()
        stats = eng.conversation_tier.stats()
        resumed = {k: (p, c) for k, p, c, _n, _ms in watch.resumes}
        log(f"  [{name}] tier {stats}; engine parks {eng.parks}, resumes {eng.resumes}, park "
            f"failures {eng.park_failures}; turn-2 prefill tokens {prefilled} of "
            f"{sum(len(p) for p in seconds)} prompt tokens")
        if eng.resumes != CONV_CLIENTS or stats["hits"] + stats["spilled_hits"] != CONV_CLIENTS:
            raise AssertionError(f"[{name}] {eng.resumes} resumes, tier {stats}: every turn 2 "
                                 "must resume")
        if stats["spilled_hits"] < 1:
            raise AssertionError(f"[{name}] no turn 2 resumed from disk: {stats}")
        want_pf = 0
        for p1, p2, sfx in zip(firsts, seconds, suffixes):
            p, covered = resumed[_key(p2)]
            # the parked history is turn 1's prompt + its tokens but the last
            if p != len(p2) or covered != len(p1) + GEN_NEW_TOKENS - 1 or \
                    p - covered != len(sfx) + 1 or p - covered > len(sfx) + 16:
                raise AssertionError(f"[{name}] resume of a {len(p2)}-token turn 2 covered "
                                     f"{covered} (want {len(p1) + GEN_NEW_TOKENS - 1})")
            want_pf += p - covered
        if prefilled != want_pf or watch.mismatches:
            raise AssertionError(f"[{name}] turn-2 prefill {prefilled} != {want_pf}, or "
                                 f"{watch.mismatches} resumes wrote other pages than parked")
        _check_drained(node, art, name)
        st = rt._slot_states[art.model_id]
        park_ms, resume_ms, page_nbytes = _time_park_resume(art, rt, st, watch, rng)
        parked_bytes = sum(nb for *_, nb, _ms in watch.parks)
        log(f"  [{name}] {len(watch.parks)} parks, {parked_bytes} bytes parked "
            f"({page_nbytes} bytes a page), {stats['spilled_bytes']} bytes spilled to disk "
            f"({stats['spills']} spills); resumed pages equal the parked pages bit for bit "
            f"({len(watch.resumes)} resumes); park of a {PARK_HISTORY}-token history "
            f"{park_ms:.2f} ms, resume with a {PARK_SUFFIX}-token suffix {resume_ms:.2f} ms "
            "(host clock, synchronized, median of 3)")
        launches += _kill_arm(art, node, url, "o: crash recovery, (l) node",
                              [np.concatenate([p, t, s]) for p, t, s in zip(seconds, t2, thirds)],
                              watch=watch)
    finally:
        node.close()
    name0 = "l0: conversation tier off"
    node, url = _gen_node(art, "l0")
    try:
        t1_0, _s, t2_0, lat_0, counted, _pf = _conversation_turns(
            art, node, url, name0, firsts, seconds=seconds, conv=False)
        launches += counted.check()
        _check_drained(node, art, name0)
    finally:
        node.close()
    _compare_to_plain_arm(art, f"{name}, turn 1", firsts, t1_0, t1, LOGITS_TOL)
    _compare_to_plain_arm(art, f"{name}, turn 2", seconds, t2_0, t2, LOGITS_TOL)
    log(f"  [{name}] turn-2 p50 {statistics.median(lat_l) * 1e3:.1f} ms with the park watch "
        f"against {statistics.median(lat_0) * 1e3:.1f} ms with the tier off (host clock, "
        f"localhost HTTP, {CONV_CLIENTS} clients)")
    name1 = "l1: conversation park/resume, no park watch"
    node, url = _gen_node(art, "l1", conversation_kv_dir=os.path.join(art.work, "conv_kv_l1"),
                          **tier)
    try:
        eng = node.engine
        _t1, seconds1, _t2, lat_1, counted, prefilled = _conversation_turns(
            art, node, url, name1, firsts, suffixes=suffixes)
        launches += counted.check()
        want_pf = sum(len(sfx) + 1 for sfx in suffixes)
        if eng.resumes != CONV_CLIENTS or prefilled != want_pf:
            raise AssertionError(f"[{name1}] {eng.resumes} resumes, turn-2 prefill "
                                 f"{prefilled} != {want_pf}")
        _check_drained(node, art, name1)
        stats = eng.conversation_tier.stats()
        log(f"  [{name1}] turn-2 p50 {statistics.median(lat_1) * 1e3:.1f} ms against "
            f"{statistics.median(lat_0) * 1e3:.1f} ms with the tier off (host clock, localhost "
            f"HTTP, {CONV_CLIENTS} clients; turn-2 prompts of the same lengths, "
            f"{sum(len(p) for p in seconds1)} tokens); scheduler thread, every lane waiting: "
            f"{eng.park_s * 1e3:.1f} ms in {eng.parks} parks, {eng.resume_s * 1e3:.1f} ms in "
            f"{eng.resumes} resumes and their lookups (host clock, both turns); "
            f"{stats['spills']} spills, {stats['spilled_hits']} resumes from disk")
    finally:
        node.close()
    name8 = "l8: conversation park/resume, int8 arena"
    few = CONV_INT8_CONVERSATIONS
    node, url = _gen_node(art, "l8", kv_arena_dtype="int8",
                          conversation_kv_dir=os.path.join(art.work, "conv_kv_l8"), **tier)
    try:
        eng = node.engine
        watch8 = _ParkWatch(node.runtime)
        _t1, _s, _t2, lat_8, counted, prefilled = _conversation_turns(
            art, node, url, name8, firsts[:few], suffixes=suffixes[:few], tol=LOGITS_TOL_INT8)
        launches += counted.check()
        if eng.resumes != few or watch8.mismatches:
            raise AssertionError(f"[{name8}] {eng.resumes} resumes of {few}, "
                                 f"{watch8.mismatches} resumed pages unlike the parked ones")
        _check_drained(node, art, name8)
        st = node.runtime._slot_states[art.model_id]
        page8 = _page_nbytes(st)
        ratio = page8 / page_nbytes
        hd = st.k.shape[-1]
        want = (hd + 4) / (2 * hd)  # an int8 row + its f32 scale against a bf16 row
        log(f"  [{name8}] {eng.resumes} resumes, pages equal the parked ones bit for bit "
            f"(values and scales); {sum(nb for *_, nb, _ms in watch8.parks)} bytes parked in "
            f"{len(watch8.parks)} parks, {page8} bytes a page = {ratio:.3f} of bf16's; turn-2 "
            f"p50 {statistics.median(lat_8) * 1e3:.1f} ms; tier {eng.conversation_tier.stats()}")
        if abs(ratio - want) > 1e-9:
            raise AssertionError(f"[{name8}] an int8 page parks {ratio:.4f} of a bf16 page, "
                                 f"not {want:.4f}")
    finally:
        node.close()
    return launches


def _page_nbytes(st) -> int:
    """Bytes one arena page parks (K, V and an int8 arena's scales)."""
    n = st.arena_pages + 1
    return sum(t.nbytes for t in (st.k, st.v, *(st.scales or {}).values())) // n


def _time_park_resume(art, rt, st, watch, rng) -> tuple[float, float, int]:
    """Host ms (synchronized) of one park of a PARK_HISTORY-token history and
    one resume of it with a PARK_SUFFIX-token suffix on the idle engine's
    state, median of 3 (the rows are whatever earlier rows left: timing
    only); every page handed back. -> (park ms, resume ms, page bytes)."""
    import numpy as np
    import torch

    history = rng.integers(0, art.vocab, PARK_HISTORY).astype(np.int32)
    prompt = np.concatenate([history, rng.integers(0, art.vocab, PARK_SUFFIX)]).astype(np.int32)
    parks, resumes = [], []
    for _ in range(3):
        if not (st.reserve_pages(0, len(prompt) + 16) and st.reserve_pages(1, len(prompt) + 16)):
            raise AssertionError("the idle arena cannot hold two park/resume lanes")
        try:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            parked = watch.real_park(st, 0, history)
            parks.append((time.monotonic() - t0) * 1e3)
            covered, n_pages = rt.plan_conversation_resume(st, prompt, parked)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            watch.real_resume(art.model_id, st, 1, prompt, parked, covered, n_pages, 0.0, 0, 0)
            torch.cuda.synchronize()
            resumes.append((time.monotonic() - t0) * 1e3)
        finally:
            st.release_pages(0)
            st.release_pages(1)
    st.check_page_conservation()
    return statistics.median(parks), statistics.median(resumes), _page_nbytes(st)


def _post_stream(url: str, body: dict, timeout: float = 900.0):
    """POST ``body`` to ``url?stream=true`` and read the SSE frames as they
    come. -> (status, frames or the error body, seconds to the first frame,
    seconds in all, Content-Type)."""
    req = urllib.request.Request(url + "?stream=true", data=json.dumps(body).encode(),
                                 method="POST", headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    first = None
    frames = []
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            ctype = resp.headers.get("Content-Type")
            for line in iter(resp.readline, b""):
                if line.startswith(b"data: "):
                    if first is None:
                        first = time.monotonic() - t0
                    frames.append(json.loads(line[6:]))
            status = resp.status
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), None, time.monotonic() - t0, None
    return status, frames, first, time.monotonic() - t0, ctype


def _stream_tokens(name, res, n_new) -> list:
    """A stream's token frames, checked: 200, text/event-stream, one frame a
    token, then one done frame whose row equals them. -> the done frame's
    matrix."""
    status, frames, _first, _total, ctype = res
    if status != 200 or ctype != "text/event-stream":
        raise AssertionError(f"[{name}] stream answered {status} ({ctype}): {frames}")
    toks = [f.get("token") for f in frames[:-1]]
    done = frames[-1]
    if (len(toks) != n_new or None in toks or not done.get("done")
            or done["tokens"][0] != toks):
        raise AssertionError(f"[{name}] frames: {len(toks)} token frames of {n_new}, last "
                             f"{done}")
    return done["tokens"]


def _stream_and_kill_arms(art, prompts) -> int:
    """(n) ``?stream=true`` on an (a) node: STREAMS single-row greedy streams
    on the engine, a seeded stream on the solo path and a "draft_model"
    stream, each against the buffered answer to the same request, and a
    2-row stream refused with 400; then (o) on the same node: kill_engine
    under KILL_REQUESTS greedy requests. -> the paged launches."""
    import numpy as np

    name = "n: ?stream=true"
    launches = 0
    node, url = _gen_node(art, "n")
    try:
        eng = node.engine
        bodies = [{"input_ids": [p.tolist()], "max_new_tokens": GEN_NEW_TOKENS}
                  for p in prompts[:STREAMS]]
        buffered = _check_answers(art, name, prompts[:STREAMS],
                                  _post_many(url, bodies, STREAMS), GEN_NEW_TOKENS, LOGITS_TOL)
        from concurrent.futures import ThreadPoolExecutor

        with _Counted(art, eng, name) as counted, ThreadPoolExecutor(STREAMS) as pool:
            streams = list(pool.map(lambda b: _post_stream(url, b), bodies))
        launches += counted.check()
        streamed = [np.asarray(_stream_tokens(name, r, GEN_NEW_TOKENS)[0]) for r in streams]
        _compare_to_plain_arm(art, f"{name}, streamed vs buffered", prompts[:STREAMS], buffered,
                              streamed, LOGITS_TOL)
        for label, body in (
                ("seeded, solo", {"input_ids": [prompts[1].tolist()],
                                  "max_new_tokens": GEN_NEW_TOKENS, "temperature": 0.8,
                                  "top_k": 40, "seed": 7}),
                ("draft_model", {"input_ids": [prompts[2].tolist()],
                                 "max_new_tokens": GEN_NEW_TOKENS, "draft_model": "layer0",
                                 "spec_tokens": SPEC_TOKENS})):
            status, want, _dt = _post(url, body, 900.0)
            res = _post_stream(url, body)
            got = _stream_tokens(f"{name}, {label}", res, GEN_NEW_TOKENS)
            if status != 200 or got != want["tokens"]:
                raise AssertionError(f"[{name}] {label} stream's done frame differs from the "
                                     "buffered answer")
            streams.append(res)
        status, err, *_ = _post_stream(url, {"input_ids": [[1, 2], [3, 4]],
                                             "max_new_tokens": 4})
        if status != 400 or "single-row" not in err.get("error", ""):
            raise AssertionError(f"[{name}] a 2-row stream answered {status}: {err}")
        first = [r[2] * 1e3 for r in streams]
        total = [r[3] * 1e3 for r in streams]
        log(f"  [{name}] {len(streams)} streams ({STREAMS} engine, seeded solo, draft_model): "
            f"frames = {GEN_NEW_TOKENS} tokens + 1 done frame each, done frames equal the "
            f"buffered answers (engine streams up to near-ties); first frame / whole request "
            f"ms (host clock): " + ", ".join(f"{a:.1f} / {b:.1f}" for a, b in zip(first, total))
            + "; a 2-row stream answered 400")
        _check_drained(node, art, name)
        launches += _kill_arm(art, node, url, "o: crash recovery, (a) node",
                              prompts[:KILL_REQUESTS])
    finally:
        node.close()
    return launches


def _kill_arm(art, node, url, name, prompts, watch=None) -> int:
    """(o) the requests unkilled, then again with ``kill_engine`` armed
    (``after`` KILL_AFTER boundaries, ``count`` 1), one of them streamed:
    every answer 200, tokens equal the unkilled run's up to near-ties, the
    streamed row's frames equal its answer, the engine's recovered count =
    the rows in flight + queued at the crash, the census green after the
    drain. With ``watch`` (the (l) node: each prompt extends a conversation
    parked at its turn 2) the killed run is sent with the conversation ids:
    every admission resumes, and a row's prefill over all its admissions
    stays below one cold prefill of its prompt. -> paged launches."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from tfservingcache_tpu_torch.lab import faults
    from tfservingcache_tpu_torch.runtime import batcher as B

    eng = node.engine
    bodies = [{"input_ids": [p.tolist()], "max_new_tokens": GEN_NEW_TOKENS} for p in prompts]
    plain = _check_answers(art, name, prompts, _post_many(url, bodies, len(bodies)),
                           GEN_NEW_TOKENS, LOGITS_TOL)
    if watch is not None:
        bodies = [dict(b, conversation_id=f"conv{i}") for i, b in enumerate(bodies)]
        n_resumes = len(watch.resumes)
    caught: list[int] = []
    real_triage = B._ContinuousScheduler._triage

    def triage(sched, inflight, queued, err):
        caught.append(sum(not r.done.is_set() for r in inflight + queued))
        return real_triage(sched, inflight, queued, err)

    recovered0, resumes0, pf0 = eng.recovered, eng.resumes, eng.prefill_tokens
    B._ContinuousScheduler._triage = triage
    faults.arm([faults.FaultSpec(kind="kill_engine", after=KILL_AFTER, count=1)])
    try:
        with _Counted(art, eng, name) as counted, ThreadPoolExecutor(len(bodies)) as pool:
            stream = pool.submit(_post_stream, url, bodies[0])
            results = list(pool.map(lambda b: _post(url, b, timeout=900.0), bodies[1:]))
            stream = stream.result()
        fired = faults.snapshot()[0]["fired"]
    finally:
        faults.disarm()
        B._ContinuousScheduler._triage = real_triage
    launches = counted.check()
    streamed = np.asarray(_stream_tokens(name, stream, GEN_NEW_TOKENS))
    killed = [streamed[0]] + _check_answers(art, name, prompts[1:], results, GEN_NEW_TOKENS,
                                            LOGITS_TOL)
    _check_greedy(art, prompts[0], streamed[0], LOGITS_TOL, name)
    recovered = eng.recovered - recovered0
    if fired != 1 or caught != [recovered] or not recovered:
        raise AssertionError(f"[{name}] fired {fired}, rows in flight + queued at the crash "
                             f"{caught}, recovered {recovered}")
    _compare_to_plain_arm(art, f"{name}, killed vs unkilled", prompts, plain, killed,
                          LOGITS_TOL)
    _check_drained(node, art, name)
    msg = ""
    if watch is not None:
        per_row: dict[bytes, int] = {}
        for k, p, covered, _n, _ms in watch.resumes[n_resumes:]:
            per_row[k] = per_row.get(k, 0) + p - covered
        prefilled = eng.prefill_tokens - pf0
        resumes = eng.resumes - resumes0
        worst = max(per_row.get(_key(p), len(p)) / len(p) for p in prompts)
        if (resumes != len(prompts) + recovered or sum(per_row.values()) != prefilled
                or worst >= 1.0):
            raise AssertionError(f"[{name}] {resumes} resumes for {len(prompts)} rows + "
                                 f"{recovered} recoveries, prefill {prefilled} vs "
                                 f"{sum(per_row.values())}, worst row {worst:.3f} of a cold "
                                 "prefill")
        msg = (f"; every admission resumed from the parked turn 2 ({resumes} resumes), "
               f"{prefilled} prefill tokens over both admissions of all rows against "
               f"{sum(len(p) for p in prompts)} for one cold prefill each (worst row "
               f"{worst:.3f} of its cold prefill)")
    log(f"  [{name}] kill_engine after {KILL_AFTER} boundaries: {caught[0]} rows in flight or "
        f"queued at the crash, all recovered; {len(prompts)} answers 200, the streamed row's "
        f"frames equal its answer; census green" + msg)
    return launches


def _priority_arm(art, seed: int) -> int:
    """(m) priority and preemption on a PRIO_ARENA_PAGES-page arena:
    PRIO_LOW "low" rows, then after the first decode chunk PRIO_HIGH
    "high" rows. Each high row is admitted before every low row still
    queued; at least one lane is preempted, none more than the engine's
    preempt_limit; the preempted rows resume from their parks and their
    tokens equal an uncontended node's up to near-ties; census green. ->
    paged launches (both nodes)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    name = "m: priority and preemption"
    rng = np.random.default_rng(seed + 13)
    lows = [rng.integers(0, art.vocab, PRIO_LOW_PROMPT) for _ in range(PRIO_LOW)]
    highs = [rng.integers(0, art.vocab, PRIO_HIGH_PROMPT) for _ in range(PRIO_HIGH)]
    low_bodies = [{"input_ids": [p.tolist()], "max_new_tokens": PRIO_LOW_NEW, "priority": "low"}
                  for p in lows]
    high_bodies = [{"input_ids": [p.tolist()], "max_new_tokens": PRIO_HIGH_NEW,
                    "priority": "high"} for p in highs]
    node, url = _gen_node(art, "m", kv_arena_pages=PRIO_ARENA_PAGES)
    try:
        eng, rt = node.engine, node.runtime
        watch = _ParkWatch(rt)
        admitted: dict[bytes, float] = {}
        real_prefill = rt.slot_prefill_shared

        def prefill(model_id, state, prompt, *rest):
            admitted.setdefault(_key(prompt), time.monotonic())
            return real_prefill(model_id, state, prompt, *rest)

        rt.slot_prefill_shared = prefill
        with _Counted(art, eng, name) as counted, ThreadPoolExecutor(PRIO_LOW + PRIO_HIGH) as pool:
            chunks0 = eng.chunks
            low_f = [pool.submit(_post, url, b, 900.0) for b in low_bodies]
            t_end = time.monotonic() + 600
            while eng.chunks == chunks0 and time.monotonic() < t_end:
                time.sleep(0.001)
            t_high = time.monotonic()
            high_f = [pool.submit(_post, url, b, 900.0) for b in high_bodies]
            low_res = [f.result() for f in low_f]
            high_res = [f.result() for f in high_f]
        launches = counted.check()
        low_toks = _check_answers(art, name, lows, low_res, PRIO_LOW_NEW, LOGITS_TOL)
        _check_answers(art, name, highs, high_res, PRIO_HIGH_NEW, LOGITS_TOL)
        queued = [k for k in map(_key, lows) if admitted[k] > t_high]
        high_at = [admitted[_key(p)] for p in highs]
        per_row: dict[bytes, int] = {}
        for k, *_ in watch.parks:
            per_row[k] = per_row.get(k, 0) + 1
        preempted = [i for i, p in enumerate(lows) if _key(p) in per_row]
        log(f"  [{name}] {len(queued)} low rows still queued when the high rows came; "
            f"preemptions {eng.preemptions} (per preempted row {sorted(per_row.values())}, "
            f"limit {eng.preempt_limit}), resumes {eng.resumes}; preemption parks "
            f"{eng.preempt_park_s * 1e3:.1f} ms in all (host clock); park failures "
            f"{eng.park_failures}")
        if not queued or max(high_at) >= min(admitted[k] for k in queued):
            raise AssertionError(f"[{name}] a queued low row was admitted before a high row "
                                 f"({len(queued)} queued)")
        if eng.preemptions < 1 or max(per_row.values()) > eng.preempt_limit or watch.mismatches:
            raise AssertionError(f"[{name}] preemptions {eng.preemptions}, per row {per_row}, "
                                 f"{watch.mismatches} resumes wrote other pages than parked")
        if eng.resumes != sum(per_row.values()):
            raise AssertionError(f"[{name}] {eng.resumes} resumes for {per_row} preemptions")
        _check_drained(node, art, name)
        lat = {c: [r[2] for r in res] for c, res in (("low", low_res), ("high", high_res))}
        log(f"  [{name}] p50 high {statistics.median(lat['high']) * 1e3:.1f} ms, low "
            f"{statistics.median(lat['low']) * 1e3:.1f} ms (host clock, localhost HTTP)")
    finally:
        node.close()
    name0 = "m0: the preempted rows uncontended"
    node, url = _gen_node(art, "m0")
    try:
        with _Counted(art, node.engine, name0) as counted:
            alone = _check_answers(art, name0, [lows[i] for i in preempted],
                                   [_post(url, low_bodies[i], 900.0) for i in preempted],
                                   PRIO_LOW_NEW, LOGITS_TOL)
        launches += counted.check()
        _check_drained(node, art, name0)
    finally:
        node.close()
    _compare_to_plain_arm(art, f"{name}, preempted rows vs uncontended",
                          [lows[i] for i in preempted], alone,
                          [low_toks[i] for i in preempted], LOGITS_TOL)
    return launches


def _scrape(base: str) -> dict:
    """The node's exposition, parsed with the standard library:
    {(sample name, sorted (label, value) pairs): value}."""
    with urllib.request.urlopen(base + "/monitoring/prometheus/metrics", timeout=120) as resp:
        text = resp.read().decode()
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        name, _, labels = head.partition("{")
        pairs = tuple(sorted(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', labels)))
        out[(name, pairs)] = float(value)
    return out


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=120) as resp:
        return json.loads(resp.read())


def _chunk_kernel_ms(events: list) -> tuple[list[tuple[float, float, int]], str]:
    """Each ``tpusc.decode_chunk`` range of a Chrome trace (the scheduler
    thread's dispatch of one decode chunk, through its device-to-host copy)
    -> ([(range ms on the host clock, device ms of the chunk's kernels,
    their count)], how the kernels were matched). A launch record inside
    the range (same thread) names its kernel by correlation id;
    a trace without launch records falls back to the kernels that ran
    wholly inside the range."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    kernel_us = {e["args"]["correlation"]: e["dur"] for e in kernels
                 if "correlation" in e.get("args", {})}
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})]
    ranges = [r for r in events
              if r.get("cat") == "user_annotation" and r.get("name") == "tpusc.decode_chunk"]
    how = "correlated launches" if launches else "kernels inside the range"
    out = []
    for r in ranges:
        t0, t1 = r["ts"], r["ts"] + r["dur"]
        if launches:
            ran = [kernel_us[e["args"]["correlation"]] for e in launches
                   if e.get("tid") == r.get("tid") and t0 <= e["ts"] <= t1
                   and e["args"]["correlation"] in kernel_us]
        else:
            ran = [k["dur"] for k in kernels if t0 <= k["ts"] and k["ts"] + k["dur"] <= t1]
        if ran:
            out.append((r["dur"] / 1e3, sum(ran) / 1e3, len(ran)))
    return out, how


def phase_observe(art: Artifact, seed: int) -> None:
    """(p) The observability layer on a served continuous node, configured
    as ``cli serve`` configures it: scrape, engine rows, tenants and traces
    against what the burst ran, then a profiler capture over a second burst
    (module docstring, phase 7)."""
    import numpy as np

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.server import build_node, configure_observability
    from tfservingcache_tpu_torch.utils.accounting import LEDGER
    from tfservingcache_tpu_torch.utils.flight_recorder import RECORDER
    from tfservingcache_tpu_torch.utils.tracing import TRACER

    name = "p: observe"
    profiles = os.path.join(art.work, "profiles")
    conf = art.node_config("slo", generate_engine="continuous", generate_slots=8,
                           generate_chunk_tokens=8, kv_page_tokens=16)
    conf["observability"] = {"flight_dir": os.path.join(art.work, "flight")}
    cfg = config_from_dict(conf)
    configure_observability(cfg)
    node = build_node(cfg, device="cuda")
    try:
        node.rest.profiler_base_dir = profiles
        base = f"http://127.0.0.1:{node.start('127.0.0.1')}"
        model = f"{base}/v1/models/{art.model_id.name}/versions/1"
        prompts = _gen_prompts(art, seed)
        bodies = [{"input_ids": [p.tolist()], "max_new_tokens": GEN_NEW_TOKENS} for p in prompts]
        rng = np.random.default_rng(seed + 9)
        preds = [{"instances": rng.integers(0, art.vocab, (1, 128)).tolist()}
                 for _ in range(OBSERVE_PREDICTS)]
        # the cold load and the first prefill and predict stay out of the window
        for url, body in ((f"{model}:generate", {"input_ids": [list(range(1, 33))],
                                                 "max_new_tokens": 8}),
                          (f"{model}:predict", preds[0])):
            status, out, _dt = _post(url, body, 900.0)
            if status != 200:
                raise AssertionError(f"[{name}] warm-up answered {status}: {out}")
        RECORDER.clear()
        LEDGER.clear()
        TRACER.clear()
        before = _scrape(base)
        chunks0 = node.engine.chunks
        # --- the main path: counters to 0, the burst, counters read --------
        A.PAGED_LAUNCHES.reset()
        A.VERIFY_LAUNCHES.reset()
        A.FLASH_LAUNCHES.reset()
        t0 = time.monotonic()
        results = _post_many(f"{model}:generate", bodies, GEN_CLIENTS)
        wall = time.monotonic() - t0
        answers = [_post(f"{model}:predict", body, 900.0) for body in preds]
        paged, verify, flash = (A.PAGED_LAUNCHES.value, A.VERIFY_LAUNCHES.value,
                                A.FLASH_LAUNCHES.value)
        # --------------------------------------------------------------------
        chunks = node.engine.chunks - chunks0
        for status, out, _dt in results + answers:
            if status != 200:
                raise AssertionError(f"[{name}] a request answered {status}: {out}")
        for _s, out, _dt in results:
            toks = np.asarray(out["tokens"])
            if toks.shape != (1, GEN_NEW_TOKENS) or not ((toks >= 0) & (toks < art.vocab)).all():
                raise AssertionError(f"[{name}] tokens {toks.shape} out of shape or vocab")
        after = _scrape(base)

        def delta(sample, **labels):
            key = (sample, tuple(sorted(labels.items())))
            return after.get(key, 0.0) - before.get(key, 0.0)

        got = {
            "requests": delta("tfservingcache_proxy_requests_total", protocol="rest"),
            "failures": delta("tfservingcache_proxy_failures_total", protocol="rest"),
            "generate ok": delta("tpusc_request_duration_seconds_count", protocol="rest",
                                 verb="generate", outcome="ok", route="local"),
            "predict ok": delta("tpusc_request_duration_seconds_count", protocol="rest",
                                verb="predict", outcome="ok", route="local"),
            "admissions": delta("tpusc_gen_admission_wait_seconds_count", engine="continuous"),
        }
        want = {"requests": len(bodies) + len(preds), "failures": 0,
                "generate ok": len(bodies), "predict ok": len(preds), "admissions": len(bodies)}
        idle = {"gen_kv_pages_used": after[("tpusc_gen_kv_pages_used", ())],
                "requests_in_flight": after[("tpusc_requests_in_flight",
                                             (("protocol", "rest"),))]}
        log(f"  [{name}] scrape deltas {got} (want {want}); idle gauges {idle}")
        if got != want or any(idle.values()):
            raise AssertionError(f"[{name}] scrape {got} / idle {idle} != {want} / 0")
        snap = _get_json(base + "/monitoring/engine?n=4096&reset=0")
        steps = snap["models"][str(art.model_id)]["steps"]
        rows = [s for s in steps if s["chunk"] > 0]
        want_paged = art.layers * sum(s["chunk"] for s in rows)
        log(f"  [{name}] /monitoring/engine: {len(steps)} rows, {len(rows)} with a chunk "
            f"(engine chunks {chunks}); paged launches {paged} (n_layers {art.layers} x "
            f"summed chunk {sum(s['chunk'] for s in rows)} = {want_paged}); verify {verify}; "
            f"flash {flash} (n_layers x {len(preds)} predicts); admitted "
            f"{sum(s['admitted'] for s in steps)}, retired {sum(s['retired'] for s in steps)}; "
            f"window {snap['models'][str(art.model_id)]['window']}")
        if (len(rows) != chunks or paged != want_paged or verify
                or flash != art.layers * len(preds)
                or sum(s["admitted"] for s in steps) != len(bodies)
                or sum(s["retired"] for s in steps) != len(bodies)):
            raise AssertionError(f"[{name}] engine rows / launches disagree with the burst")
        tenant = _get_json(base + "/monitoring/tenants")["tenants"][str(art.model_id)]
        tokens = tenant["totals"]["tokens_out"]
        roots = _get_json(base + "/monitoring/traces?n=1000")["traces"]
        log(f"  [{name}] /monitoring/tenants: tokens_out {tokens}, decode step seconds "
            f"{tenant['totals']['decode_step_seconds']}; /monitoring/traces: {len(roots)} roots")
        if tokens != len(bodies) * GEN_NEW_TOKENS:
            raise AssertionError(f"[{name}] the ledger attributes {tokens} tokens, the burst "
                                 f"emitted {len(bodies) * GEN_NEW_TOKENS}")
        if sorted({r["name"] for r in roots}) != ["rest"] or len(roots) != len(bodies) + len(preds):
            raise AssertionError(f"[{name}] {len(roots)} trace roots for "
                                 f"{len(bodies) + len(preds)} requests")
        step_ms = sorted(s["step_ms"] for s in rows)
        p50, p90 = (float(np.percentile(step_ms, q)) for q in (50, 90))
        tok_s = len(bodies) * GEN_NEW_TOKENS / wall
        # the profiler over a second burst, a :predict inside the window
        answer: dict = {}

        def capture():
            req = urllib.request.Request(
                f"{base}/monitoring/profiler?duration_s={PROFILE_S}&label=smoke", method="POST")
            try:
                with urllib.request.urlopen(req, timeout=600) as resp:
                    answer["reply"] = (resp.status, json.loads(resp.read()))
            except urllib.error.HTTPError as e:
                answer["reply"] = (e.code, json.loads(e.read()))

        prof = threading.Thread(target=capture)
        prof.start()
        time.sleep(0.3)
        burst = threading.Thread(target=lambda: answer.setdefault(
            "burst", _post_many(f"{model}:generate", bodies[:GEN_CLIENTS], GEN_CLIENTS)))
        burst.start()
        answer["predict"] = _post(f"{model}:predict", preds[1], 900.0)
        prof.join()
        burst.join()
        status, reply = answer["reply"]
        if status != 200:
            raise AssertionError(f"[{name}] the profiler answered {status}: {reply}")
        if answer["predict"][0] != 200 or any(r[0] != 200 for r in answer["burst"]):
            raise AssertionError(f"[{name}] a request in the profiled burst failed")
        trace = reply["trace"]
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
        names = {e["name"] for e in events if e.get("cat") == "kernel"}
        found = {k: any(k in n for n in names)
                 for k in ("paged_decode_attention_kernel", "flash_fwd_kernel")}
        per_chunk, how = _chunk_kernel_ms(events)
        log(f"  [{name}] profiler: {os.path.getsize(trace)} bytes of Chrome trace, "
            f"{len(names)} kernel names, {found}; {len(per_chunk)} decode-chunk ranges ({how})")
        os.remove(trace)
        shutil.rmtree(profiles, ignore_errors=True)
        if not all(found.values()):
            raise AssertionError(f"[{name}] the trace misses a kernel: {found}")
        if not per_chunk:
            raise AssertionError(f"[{name}] no decode-chunk range with kernels in the trace")
        host_c, dev_c, n_c = (statistics.median(x) for x in zip(*per_chunk))
        log(f"  [{name}] step_ms of the unprofiled burst (flight recorder, host clock of a "
            f"boundary): p50 {p50:.3f} ms, p90 {p90:.3f} ms over {len(rows)} chunks; one decode "
            f"chunk in the profiled burst: {dev_c:.3f} ms of device kernels ({n_c:.0f} kernels) "
            f"in a {host_c:.3f} ms dispatch range (medians over {len(per_chunk)} chunks, "
            f"torch.profiler)")
        arm_a = ARM_TOK_S.get("a: bf16 arena")
        log(f"  [{name}] {len(bodies)} requests x {GEN_NEW_TOKENS} tokens from {GEN_CLIENTS} "
            f"clients with the layer configured: {tok_s:.1f} generated tok/s; arm (a) in this "
            f"call: {arm_a:.1f} tok/s" if arm_a else
            f"  [{name}] {tok_s:.1f} generated tok/s (arm (a) did not run in this call)")
    finally:
        node.close()
        RECORDER.configure(flight_dir="")  # dumps stop with the node


CLUSTER_NODES = 3
CLUSTER_PREDICTS = 6            # warm (1, 128) :predict requests through each router
CLUSTER_SHAPE = (1, 128)
CLUSTER_ARENA_BYTES = 512 << 20  # each node's paged arena (pages of 16 tokens)
CLUSTER_PROMPT = 512            # the conversations' turn-1 prompt
CLUSTER_SUFFIX = 48             # the new tokens of turn 2
CLUSTER_NEW_TOKENS = 32
CLUSTER_DEAD_REQUESTS = 8       # arm C: :generate requests after the first choice is closed


def _cluster_nodes(art, layers: int):
    """CLUSTER_NODES continuous paged nodes on cuda:0, each with its own
    disk cache and conversation tier under the run's directory, all
    advertising 127.0.0.1. -> (nodes, their configs)."""
    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.server import build_node

    page_bytes = 2 * layers * 32 * 16 * 128 * 2  # K and V, 32 KV heads, 16 tokens, D 128, bf16
    nodes, cfgs = [], []
    try:
        for i in range(CLUSTER_NODES):
            raw = art.node_config(
                f"cluster{i}", generate_engine="continuous", generate_slots=8,
                generate_chunk_tokens=8, kv_page_tokens=16,
                kv_arena_pages=max(64, CLUSTER_ARENA_BYTES // page_bytes),
                conversation_kv_bytes=CONV_KV_BYTES,
                conversation_kv_dir=os.path.join(art.work, f"conv_kv_cluster{i}"))
            raw["proxy"] = {"rest_port": 0, "grpc_port": 0, "replicas_per_model": 1}
            raw["discovery"] = {"type": "static", "prefer_localhost": True}
            raw["cluster"] = {"max_replicas_per_model": 0}
            cfg = config_from_dict(raw)
            nodes.append(build_node(cfg, device="cuda"))
            cfgs.append(cfg)
            nodes[-1].start("127.0.0.1")
    except BaseException:
        for n in nodes:
            n.close()
        raise
    return nodes, cfgs


def _cluster_routers(nodes, cfgs, replicas: int):
    """A Router beside every live node, static discovery listing them all,
    ``replicas`` ring replicas a key. -> routers (closed by the caller)."""
    from tfservingcache_tpu_torch.cluster.router import Router

    idents = [f"127.0.0.1:{n.rest_port}:{n.grpc_port or 0}" for n in nodes]
    routers = []
    try:
        for node, cfg in zip(nodes, cfgs):
            cfg.discovery.nodes = idents
            cfg.proxy.replicas_per_model = replicas
            routers.append(Router(cfg, node))
            routers[-1].start("127.0.0.1")
        deadline = time.monotonic() + 60
        while any(r.cluster.node_count != len(nodes) for r in routers):
            if time.monotonic() > deadline:
                raise AssertionError("[cluster] the routers never saw every node")
            time.sleep(0.01)
    except BaseException:
        for r in routers:
            r.close()
        raise
    return routers


def _ident(node) -> str:
    return f"127.0.0.1:{node.rest_port}:{node.grpc_port or 0}"


def phase_cluster(art: Artifact, seed: int, kernels: dict) -> None:
    """The router and cluster plane on CLUSTER_NODES continuous paged nodes
    on the card (serve phase's artifact, llama-7b width), each with a
    ``Router`` over static discovery: (A) ownership fixed (one replica):
    CLUSTER_PREDICTS warm (1, 128) ``:predict`` through every router, each
    reply byte for byte the owner's direct reply and within the serve
    phase's logits check, every forward on the owner (B2 launches = n_layers
    x (its forwards + the load's warm-up)), forwarded against local p50, and
    where grpcio imports a gRPC Predict through a non-owner router equal to
    the REST reply; (B) conversation X, turns 1 and 2 through a router
    (affinity); conversation Y on the same prompts, turn 1 on the owner, then
    node B (the key's second replica) fetches it over
    ``FetchParkedConversation``, adopts it and serves turn 2 posted to it
    directly: a suffix + 1 prefill, X's turn-2 tokens (up to near-ties),
    ``migrations_in`` 1, B1 launches = n_layers x B's decode steps; (C) two
    replicas a key, the first choice closed: CLUSTER_DEAD_REQUESTS
    ``:generate`` requests pinned to it through the third node's router all
    answer 200 from the second replica, whose health in that router's
    ``/monitoring/cluster`` falls below the threshold, rendered by
    tools/fleet_top.py. Routers close before their nodes."""
    import importlib.util as iu
    import io

    import numpy as np

    from tfservingcache_tpu_torch.cache.conversation_kv import pack_parked
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.protocol import peer_transfer
    from tfservingcache_tpu_torch.protocol.grpc_client import make_channel

    layers, name = art.layers, art.model_id.name
    key = art.model_id.key
    rng = np.random.default_rng(seed + 15)
    card = nvidia_smi_line()
    nodes, cfgs = _cluster_nodes(art, layers)
    routers = []
    flash_total = paged_total = 0
    try:
        routers = _cluster_routers(nodes, cfgs, replicas=1)
        ring = routers[0].cluster
        owner_ident = ring.find_nodes_for_key(key)[0].ident
        second_ident = ring.ring.get_n(key, 2)[1]
        by_ident = {_ident(n): n for n in nodes}
        owner, node_b = by_ident[owner_ident], by_ident[second_ident]
        third = next(n for n in nodes if n is not owner and n is not node_b)
        log(f"  [cluster] {len(nodes)} nodes on cuda:0, ring owner of {key} {owner_ident}, "
            f"second replica {second_ident}")
        predicts = {id(n): 0 for n in nodes}
        for n in nodes:
            def counted(*a, _fn=n.runtime.predict, _n=n, **kw):
                predicts[id(_n)] += 1
                return _fn(*a, **kw)

            n.runtime.predict = counted

        # --- arm A: routing (counters to 0, every request, counters read) ---
        A.FLASH_LAUNCHES.reset()
        rows, lat = [], {"local": [], "forwarded": []}
        owner_url = f"http://127.0.0.1:{owner.rest_port}/v1/models/{name}/versions/1:predict"
        for r in routers:
            url = f"http://127.0.0.1:{r.rest_port}/v1/models/{name}/versions/1:predict"
            route = "local" if r.node is owner else "forwarded"
            for _ in range(CLUSTER_PREDICTS):
                ids = rng.integers(0, art.vocab, size=CLUSTER_SHAPE, dtype=np.int64)
                body = json.dumps({"instances": ids.tolist()}).encode()
                status, raw, dt = _post_raw(url, body)
                d_status, d_raw, _ = _post_raw(owner_url, body)
                if (status, raw) != (d_status, d_raw) or status != 200:
                    raise AssertionError(f"[cluster] {route} :predict answered {status} "
                                         f"({len(raw)} bytes), the owner {d_status}: not equal")
                lat[route].append(dt)
                rows.append((ids, raw))
        launches = A.FLASH_LAUNCHES.value
        # ------------------------------------------------------------------
        served = 2 * len(rows)  # each routed request and its direct twin
        want = layers * (served + 1)  # + the owner's load warm-up forward
        log(f"  [cluster] arm A: {len(rows)} routed (1, 128) :predict "
            f"({CLUSTER_PREDICTS} local, {len(rows) - CLUSTER_PREDICTS} forwarded) + "
            f"{len(rows)} direct to the owner, every reply byte-equal to the owner's; "
            f"runtime predicts by node {[predicts[id(n)] for n in nodes]} (owner "
            f"{nodes.index(owner)}); flash_attention launches {launches} (n_layers {layers} "
            f"x ({served} forwards + the load's warm-up) = {want})")
        if launches != want:
            raise AssertionError(f"[cluster] flash launches {launches} != {want}")
        if predicts[id(owner)] != served or sum(predicts.values()) != served:
            raise AssertionError(f"[cluster] forwards off the owner: {predicts}")
        flash_total += launches
        # the first is the cold load: both p50s over warm requests
        log(f"  [cluster] warm (1, 128) :predict p50 local "
            f"{statistics.median(lat['local'][1:] or lat['local']) * 1e3:.2f} ms over "
            f"{len(lat['local'])}, forwarded {statistics.median(lat['forwarded']) * 1e3:.2f} ms "
            f"over {len(lat['forwarded'])} (host clock, localhost, one process; {card})")
        for r in routers:
            fwd = sum(v for (n, labels), v in _scrape(
                f"http://127.0.0.1:{r.rest_port}").items()
                if n == "tpusc_request_duration_seconds_count" and ("route", "forwarded") in labels
                and ("protocol", "rest") in labels)
            want_fwd = 0 if r.node is owner else CLUSTER_PREDICTS
            if fwd != want_fwd:
                raise AssertionError(f"[cluster] router {_ident(r.node)} counted {fwd} forwarded")
        for ids, raw in rows:
            pred = np.asarray(json.loads(raw)["predictions"], dtype=np.float32)
            if pred.shape != (1, art.vocab) or not np.isfinite(pred).all():
                raise AssertionError(f"[cluster] predictions {pred.shape}")
        for ids, raw in rows[:2] + rows[-2:]:
            _check_logits(art.plain_model, CLUSTER_SHAPE, ids,
                          np.asarray(json.loads(raw)["predictions"], dtype=np.float32))
        grpc_on = all(n.grpc is not None for n in nodes)
        if grpc_on:
            flash_total += _cluster_grpc_predict(art, routers, owner, rows[-1])
        else:
            log("  [cluster] gRPC not driven: grpcio or protobuf is not installed on this "
                "machine; REST carried arm A, and arm B needs the gRPC wire")
            raise AssertionError("[cluster] arm B (migration over gRPC) needs grpcio")

        # --- arm B: migration ---------------------------------------------
        via = next(r for r in routers if r.node is third)  # a router that forwards
        gen_url = f"http://127.0.0.1:{via.rest_port}/v1/models/{name}/versions/1:generate"
        prompt = rng.integers(1, art.vocab, CLUSTER_PROMPT).astype(np.int32)
        suffix = rng.integers(1, art.vocab, CLUSTER_SUFFIX).astype(np.int32)

        def turn(url, ids, conv):
            status, body, dt = _post(url, {"input_ids": [ids.tolist()],
                                           "max_new_tokens": CLUSTER_NEW_TOKENS,
                                           "conversation_id": conv}, 900.0)
            if status != 200:
                raise AssertionError(f"[cluster] :generate ({conv}) answered {status}: {body}")
            return np.asarray(body["tokens"][0], np.int32), dt

        A.FLASH_LAUNCHES.reset()  # read at the end of arm C
        A.PAGED_LAUNCHES.reset()
        owner_steps0 = owner.engine.decode_steps
        x1, _ = turn(gen_url, prompt, "X")
        p2 = np.concatenate([prompt, x1, suffix])
        x2, _ = turn(gen_url, p2, "X")
        y1, _ = turn(gen_url, prompt, "Y")
        paged_x = A.PAGED_LAUNCHES.value
        if not np.array_equal(x1, y1):
            raise AssertionError("[cluster] two turn 1s of one prompt differ")
        for ids, toks, what in ((prompt, x1, "X turn 1"), (p2, x2, "X turn 2")):
            _check_greedy(art, ids, toks, LOGITS_TOL, f"[cluster] {what}")
        owner_steps = owner.engine.decode_steps - owner_steps0
        if paged_x != layers * owner_steps:
            raise AssertionError(f"[cluster] paged launches {paged_x} != n_layers x "
                                 f"{owner_steps} owner decode steps")
        if owner.engine.resumes < 1:
            raise AssertionError("[cluster] X's turn 2 did not resume on the owner")
        channel = make_channel(f"127.0.0.1:{owner.grpc_port}")
        try:
            t0 = time.monotonic()
            parked = peer_transfer.fetch_parked_from_peer(channel, "Y", art.model_id,
                                                          timeout_s=300)
            fetch_s = time.monotonic() - t0
        finally:
            channel.close()
        t0 = time.monotonic()
        node_b.engine.conversation_tier.adopt("Y", parked)
        adopt_s = time.monotonic() - t0
        nbytes = len(pack_parked(parked))
        b_url = f"http://127.0.0.1:{node_b.rest_port}/v1/models/{name}/versions/1:generate"
        # B's cold load stays out of the window: a warm-up of another prompt
        turn(b_url, rng.integers(1, art.vocab, 16).astype(np.int32), "warm")
        steps0, pf0, res0 = (node_b.engine.decode_steps, node_b.engine.prefill_tokens,
                             node_b.engine.resumes)
        A.PAGED_LAUNCHES.reset()
        y2, y2_s = turn(b_url, p2, "Y")
        paged_b = A.PAGED_LAUNCHES.value
        b_steps = node_b.engine.decode_steps - steps0
        prefilled = node_b.engine.prefill_tokens - pf0
        stats = node_b.engine.conversation_tier.stats()
        log(f"  [cluster] arm B: migrated conversation Y ({parked.pages_k.shape[1]} pages, "
            f"{nbytes} bytes) over FetchParkedConversation in {fetch_s * 1e3:.2f} ms, adopted "
            f"in {adopt_s * 1e3:.3f} ms; B's turn 2 prefilled {prefilled} tokens (suffix "
            f"{CLUSTER_SUFFIX} + 1), resumed {node_b.engine.resumes - res0}, migrations_in "
            f"{stats['migrations_in']}, {y2_s * 1e3:.1f} ms; paged_decode_attention launches "
            f"{paged_b} (n_layers {layers} x {b_steps} decode steps) (host clock; {card})")
        if prefilled != CLUSTER_SUFFIX + 1 or node_b.engine.resumes - res0 != 1:
            raise AssertionError(f"[cluster] B prefilled {prefilled}, not the suffix + 1")
        if stats["migrations_in"] != 1:
            raise AssertionError(f"[cluster] migrations_in {stats['migrations_in']}")
        if paged_b != layers * b_steps:
            raise AssertionError(f"[cluster] B's paged launches {paged_b} != {layers * b_steps}")
        if np.array_equal(y2, x2):
            log("  [cluster] B's turn 2 tokens equal X's turn 2 (served on the owner)")
        else:
            gap = _check_greedy(art, p2, y2, LOGITS_TOL, "[cluster] Y turn 2 on B")
            log(f"  [cluster] B's turn 2 differs from X's at a near-tie (largest teacher-forced "
                f"gap {gap:.4f} <= {LOGITS_TOL})")
        paged_total += paged_x + paged_b
        for n in (owner, node_b):
            n.runtime._slot_states[art.model_id].check_page_conservation()

        # --- arm C: a dead replica ----------------------------------------
        for r in routers:
            r.close()
        routers = _cluster_routers(nodes, cfgs, replicas=2)
        via = next(r for r in routers if r.node is third)
        first, second = via.cluster.find_nodes_for_key(key)
        if (first.ident, second.ident) != (owner_ident, second_ident):
            raise AssertionError("[cluster] two replicas are not the owner and B")
        convs = [c for c in (f"dead{i}" for i in range(1000))
                 if via.backend._candidates(name, 1, affinity=c)[0].ident == owner_ident]
        convs = convs[:CLUSTER_DEAD_REQUESTS]
        dead_router = next(r for r in routers if r.node is owner)
        dead_router.close()
        routers.remove(dead_router)
        owner.close()
        nodes.remove(owner)
        gen_url = f"http://127.0.0.1:{via.rest_port}/v1/models/{name}/versions/1:generate"
        steps0 = node_b.engine.decode_steps
        A.PAGED_LAUNCHES.reset()
        dead_lat = []
        for conv in convs:
            ids = rng.integers(1, art.vocab, 64).astype(np.int32)
            toks, dt = turn(gen_url, ids, conv)
            _check_greedy(art, ids, toks, LOGITS_TOL, f"[cluster] {conv} on the second replica")
            dead_lat.append(dt)
        paged_c = A.PAGED_LAUNCHES.value
        c_steps = node_b.engine.decode_steps - steps0
        if paged_c != layers * c_steps:
            raise AssertionError(f"[cluster] arm C paged launches {paged_c} != {layers * c_steps}")
        paged_total += paged_c
        snap = _get_json(f"http://127.0.0.1:{via.rest_port}/monitoring/cluster")
        row = snap["nodes"][owner_ident]
        log(f"  [cluster] arm C: {len(convs)} :generate pinned to the closed first choice all "
            f"answered 200 from {second_ident} (p50 {statistics.median(dead_lat) * 1e3:.1f} ms; "
            f"{card}); the closed peer's health {row['health']} after {row['failures']} failed "
            f"forwards (threshold {snap['health_threshold']}); paged launches {paged_c} "
            f"(n_layers x {c_steps})")
        if not row["health"] < snap["health_threshold"]:
            raise AssertionError(f"[cluster] the closed peer's health {row['health']}")
        spec = iu.spec_from_file_location("fleet_top", os.path.join(ROOT, "tools",
                                                                    "fleet_top.py"))
        fleet_top = iu.module_from_spec(spec)
        spec.loader.exec_module(fleet_top)
        out = io.StringIO()
        fleet_top.render(snap, out=out)
        text = out.getvalue()
        if owner_ident not in text:
            raise AssertionError("[cluster] fleet_top did not render the closed peer")
        log("  [cluster] tools/fleet_top.py:\n" + "\n".join(
            "    " + line for line in text.rstrip().splitlines()))
        flash_total += A.FLASH_LAUNCHES.value
    finally:
        for r in routers:
            r.close()
        for n in nodes:
            n.close()
    kernels["flash_attention"]["launches"] += flash_total
    kernels["flash_attention"]["launches_cluster_phase"] = flash_total
    kernels["paged_decode_attention"]["launches"] += paged_total
    kernels["paged_decode_attention"]["launches_cluster_phase"] = paged_total
    log(f"  [cluster] the phase's launches: flash_attention {flash_total}, "
        f"paged_decode_attention {paged_total}")


def _cluster_grpc_predict(art, routers, owner, row) -> int:
    """A gRPC Predict of arm A's last input through a non-owner router: its
    logits equal the REST reply's. -> the flash launches it made."""
    import grpc
    import numpy as np

    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.protocol import codec
    from tfservingcache_tpu_torch.protocol.grpc_client import ServingStub, make_channel
    from tfservingcache_tpu_torch.protocol.grpc_server import PREDICTION_SERVICE
    from tfservingcache_tpu_torch.protocol.protos import tf_serving_pb2 as sv

    ids, raw = row
    rest_pred = np.asarray(json.loads(raw)["predictions"], dtype=np.float32)
    r = next(r for r in routers if r.node is not owner)
    channel = make_channel(f"127.0.0.1:{r.grpc_port}")
    A.FLASH_LAUNCHES.reset()
    try:
        req = sv.PredictRequest()
        req.model_spec.name = art.model_id.name
        req.model_spec.version.value = 1
        req.inputs["input_ids"].CopyFrom(codec.numpy_to_tensorproto(ids.astype(np.int32)))
        req.output_filter.append("last_token_logits")
        resp = ServingStub(channel).method(PREDICTION_SERVICE, "Predict")(req, timeout=900)
    finally:
        channel.close()
    launches = A.FLASH_LAUNCHES.value
    got = codec.tensorproto_to_numpy(resp.outputs["last_token_logits"])
    if not np.array_equal(got, rest_pred):
        raise AssertionError(f"[cluster] gRPC Predict through a router: max|gRPC - REST| "
                             f"{float(np.abs(got - rest_pred).max())}")
    if launches != art.layers:
        raise AssertionError(f"[cluster] the gRPC Predict made {launches} flash launches")
    log(f"  [cluster] gRPC Predict through router {_ident(r.node)} (grpcio {grpc.__version__}) "
        f"forwarded to the owner: logits equal to the REST reply's")
    return launches


PEER_SHAPE = (1, 128)            # the adopted model's cold :predict
PEER_PROMPT = 256                # the greedy :generate's prompt tokens
PEER_NEW_TOKENS = 32
PEER_ARENA_BYTES = 512 << 20     # each peer node's paged arena (pages of 16 tokens)
PEER_MNIST = "mnist0"            # arms (b) and (c): a small family
PEER_SENDER_DEVICE = "cuda"      # where the sender process builds its node
S3_BUCKET = "smoke"


def _peer_sender_main(spec_path: str) -> int:
    """The peer phase's sender in a process of its own (``--peer-sender``):
    a port node from the JSON spec's ``config`` on its ``device``. It prints
    its ports as one JSON line and serves until its standard input closes
    (the parent closes it, or exits)."""
    sys.path.insert(0, ROOT)
    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.server import build_node

    with open(spec_path) as f:
        spec = json.load(f)
    node = build_node(config_from_dict(spec["config"]), device=spec["device"])
    try:
        node.start("127.0.0.1")
        print(json.dumps({"rest": node.rest_port, "grpc": node.grpc_port}), flush=True)
        sys.stdin.read()
    finally:
        node.close()
    return 0


class _PeerSender:
    """The sender process: started from ``raw_cfg``, its ports read from its
    first JSON line; ``close`` ends its standard input and waits for it
    (killed after 60 s). Its log goes to a file in the run's directory."""

    def __init__(self, art: Artifact, raw_cfg: dict) -> None:
        spec_path = os.path.join(art.work, "peer_sender.json")
        with open(spec_path, "w") as f:
            json.dump({"config": raw_cfg, "device": PEER_SENDER_DEVICE}, f)
        self.log_path = os.path.join(art.work, "peer_sender.log")
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--peer-sender", spec_path],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self._log, text=True,
            cwd=ROOT)
        ports: list = []

        def read() -> None:
            for line in self.proc.stdout:
                try:
                    got = json.loads(line)
                except ValueError:
                    continue
                if isinstance(got, dict) and "rest" in got:
                    ports.append(got)
                    return

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        reader.join(600)
        if not ports:
            self.close()
            raise AssertionError(f"[peer] the sender process never served: {self.tail()}")
        self.rest, self.grpc = ports[0]["rest"], ports[0]["grpc"]

    def tail(self, n: int = 3000) -> str:
        self._log.flush()
        with open(self.log_path) as f:
            return f.read()[-n:]

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self._log.close()


class _FakeS3:
    """A stdlib S3 endpoint over a directory tree, on 127.0.0.1 port 0:
    ListObjectsV2 (prefix, delimiter, max-keys; one page) and GET of
    ``<bucket>/<relative path>``."""

    def __init__(self, root: str) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qsl, unquote, urlsplit
        from xml.sax.saxutils import escape

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                parsed = urlsplit(self.path)
                q = dict(parse_qsl(parsed.query, keep_blank_values=True))
                path = unquote(parsed.path).lstrip("/")
                if not path.startswith(S3_BUCKET):
                    self.send_error(404)
                    return
                key = path[len(S3_BUCKET):].lstrip("/")
                if q.get("list-type") == "2":
                    prefix, delim = q.get("prefix", ""), q.get("delimiter", "")
                    keys = sorted(
                        os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
                        for d, _sub, files in os.walk(root) for f in files)
                    objs, prefixes = [], []
                    for k in keys:
                        if not k.startswith(prefix):
                            continue
                        rest = k[len(prefix):]
                        if delim and delim in rest:
                            common = prefix + rest.split(delim)[0] + delim
                            if common not in prefixes:
                                prefixes.append(common)
                        else:
                            objs.append(k)
                    limit = int(q.get("max-keys", 0) or 0)
                    if limit:
                        objs = objs[:limit]
                    body = ("<?xml version='1.0'?><ListBucketResult>" + "".join(
                        f"<Contents><Key>{escape(k)}</Key><Size>"
                        f"{os.path.getsize(os.path.join(root, k))}</Size></Contents>"
                        for k in objs) + "".join(
                        f"<CommonPrefixes><Prefix>{escape(p)}</Prefix></CommonPrefixes>"
                        for p in prefixes) + "<IsTruncated>false</IsTruncated>"
                        "</ListBucketResult>").encode()
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                full = os.path.join(root, *key.split("/"))
                if not key or not os.path.isfile(full):
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(os.path.getsize(full)))
                self.end_headers()
                with open(full, "rb") as f:
                    shutil.copyfileobj(f, self.wfile, 1 << 20)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(60)


def phase_peer(art: Artifact, seed: int, kernels: dict) -> None:
    """Peer model adoption over ``FetchPackedModel`` and an object store.

    The sender is a port node in a process of its own (one interpreter for
    three nodes held the KV wire at ~140 MB/s), on the serve phase's disk
    cache, with a host tier that holds the artifact: it answers a (1, 128)
    ``:predict``, a greedy ``:generate`` (PEER_PROMPT tokens, PEER_NEW_TOKENS
    new) and an mnist ``:classify`` once, and its loads keep the packed
    entries. The receiver is a port node in this process (a cold disk cache
    of its own, ``cluster.peer_fetch`` on) with a Router over static
    discovery of both; its fleet view is polled until it shows both models
    on the sender.

    (a) The receiver's cold ``:predict`` of the artifact, then the same
    ``:generate``: ``reload_source`` peer 1, store 0, disk 0 (the adopted
    entry promoted, no artifact read); the reply the sender's byte for byte
    and within the serve phase's logits check; the tokens the sender's and
    within the teacher-forced check; B2 launches = n_layers (the
    ``:predict``; a promotion runs no warm-up), B1 = n_layers x the engine's
    decode steps, B3 none. Printed: the wire's bytes and rate, the entry's
    rebuild (page-locked), the promotion and the first reply, each apart,
    beside the serve phase's cold ``:predict`` from the store. (b)
    ``corrupt_peer_chunk`` armed once: the receiver's mnist miss fails the
    chunk's hash, ``peer_fetch_bytes{error}`` > 0, the store serves it
    (``reload_source{store}`` 1), the reply the sender's byte for byte. (c)
    A node whose ``model_provider`` is ``s3`` over a stdlib fake S3
    endpoint on the artifact store cold-loads mnist and answers
    ``:classify`` as the sender (a disk-provider node) does."""
    import numpy as np

    from tfservingcache_tpu_torch.cluster.router import Router
    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.lab import faults
    from tfservingcache_tpu_torch.models import registry
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.server import build_node
    from tfservingcache_tpu_torch.types import NodeInfo
    from tfservingcache_tpu_torch.utils.tracing import TRACER

    layers, name = art.layers, art.model_id.name
    if not os.path.isdir(os.path.join(art.store, PEER_MNIST)):
        registry.export_artifact("mnist_cnn", art.store, name=PEER_MNIST, version=1, seed=0)
    rng = np.random.default_rng(seed + 19)
    ids = rng.integers(0, art.vocab, size=PEER_SHAPE, dtype=np.int64)
    prompt = rng.integers(1, art.vocab, PEER_PROMPT).astype(np.int32)
    images = rng.random((SURFACE_IMAGES, 28, 28, 1), dtype=np.float32)
    bodies = {
        "predict": (name, json.dumps({"instances": ids.tolist()}).encode()),
        "generate": (name, json.dumps({"input_ids": [prompt.tolist()],
                                       "max_new_tokens": PEER_NEW_TOKENS}).encode()),
        "classify": (PEER_MNIST, json.dumps({"examples": [
            {"image": img.reshape(-1).tolist()} for img in images]}).encode()),
    }
    page_bytes = 2 * layers * 32 * 16 * 128 * 2  # K and V, 32 KV heads, 16 tokens, D 128, bf16
    engine = dict(generate_engine="continuous", generate_slots=8, generate_chunk_tokens=8,
                  kv_page_tokens=16, kv_arena_pages=max(64, PEER_ARENA_BYTES // page_bytes))
    tx_cfg = art.node_config("serve", **engine)
    tx_cfg["cache"]["host_tier_bytes"] = art.nbytes + (256 << 20)
    tx_cfg["discovery"] = {"prefer_localhost": True}
    rx_cfg = art.node_config("peer_rx", **engine)
    rx_cfg["proxy"] = {"rest_port": 0, "grpc_port": 0}
    rx_cfg["discovery"] = {"type": "static", "prefer_localhost": True}
    rx_cfg["cluster"] = {"max_replicas_per_model": 0, "peer_fetch_timeout_s": 600.0}
    s3_cfg = art.node_config("peer_s3")
    s3_cfg["model_provider"] = {"type": "s3", "bucket": S3_BUCKET, "region": "us-east-1"}
    for raw_cfg in (tx_cfg, rx_cfg, s3_cfg):  # room for mnist beside the artifact
        raw_cfg["cache"]["disk_capacity_bytes"] += 64 << 20
    card = nvidia_smi_line()
    log(card)
    sender = node = router = s3 = s3_node = None
    try:
        t0 = time.monotonic()
        sender = _PeerSender(art, tx_cfg)
        log(f"  [peer] sender process up in {time.monotonic() - t0:.1f} s (REST "
            f"{sender.rest}, gRPC {sender.grpc})")
        tx = f"http://127.0.0.1:{sender.rest}/v1/models"
        want = {}
        for verb, (model, body) in bodies.items():
            status, raw, dt = _post_raw(f"{tx}/{model}/versions/1:{verb}", body)
            if status != 200:
                raise AssertionError(f"[peer] the sender's :{verb} answered {status}: "
                                     f"{raw[:300]!r}; {sender.tail()}")
            want[verb] = raw
            log(f"  [peer] the sender's {model} :{verb} {dt * 1e3:.1f} ms")
        cfg = config_from_dict(rx_cfg)
        node = build_node(cfg, device="cuda")
        node.start("127.0.0.1")
        sender_ident = f"127.0.0.1:{sender.rest}:{sender.grpc}"
        cfg.discovery.nodes = [_ident(node), sender_ident]
        router = Router(cfg, node)
        router.start("127.0.0.1")
        if node.manager.provider._fleet is not router.fleet:
            raise AssertionError("[peer] the router did not arm the receiver's PeerProvider")
        sender_info = NodeInfo("127.0.0.1", sender.rest, sender.grpc)
        deadline = time.monotonic() + 120
        keys = (art.model_id.key, f"{PEER_MNIST}##1")
        while not all(router.fleet.warmth(sender_ident, k) >= 2 for k in keys):
            if time.monotonic() > deadline:
                raise AssertionError(f"[peer] the receiver never saw {keys} on the sender")
            router.fleet.ingest(router.status_exchange._fetch(sender_info))
            time.sleep(0.05)
        rx = f"http://127.0.0.1:{node.rest_port}/v1/models"
        m = node.metrics
        TRACER.clear()

        # --- arm (a): counters to 0, the cold :predict and a :generate, read -
        A.FLASH_LAUNCHES.reset()
        A.PAGED_LAUNCHES.reset()
        A.VERIFY_LAUNCHES.reset()
        steps0 = node.engine.decode_steps
        got = {verb: _post_raw(f"{rx}/{name}/versions/1:{verb}", bodies[verb][1])
               for verb in ("predict", "generate")}
        flash, paged = A.FLASH_LAUNCHES.value, A.PAGED_LAUNCHES.value
        verify, steps = A.VERIFY_LAUNCHES.value, node.engine.decode_steps - steps0
        # ---------------------------------------------------------------------
        for verb, (status, raw, _dt) in got.items():
            if status != 200:
                raise AssertionError(f"[peer] the receiver's :{verb} answered {status}: "
                                     f"{raw[:300]!r}")
        sources = {t: m.reload_source.labels(t).value
                   for t in ("hbm", "host", "disk", "store", "peer")}
        log(f"  [peer] (a) the receiver's tpusc_reload_source: {sources}")
        if (sources["peer"], sources["store"], sources["disk"], sources["host"]) != (1, 0, 0, 0):
            raise AssertionError(f"[peer] (a) reload sources {sources}: want peer 1, no other "
                                 "load")
        if got["predict"][1] != want["predict"]:
            raise AssertionError("[peer] (a) the adopted model's :predict differs from the "
                                 "sender's")
        pred = np.asarray(json.loads(got["predict"][1])["predictions"], np.float32)
        _check_logits(art.plain_model, PEER_SHAPE, ids, pred)
        toks = json.loads(got["generate"][1])["tokens"][0]
        if toks != json.loads(want["generate"])["tokens"][0]:
            raise AssertionError("[peer] (a) the adopted model's tokens differ from the "
                                 "sender's")
        gap = _check_greedy(art, prompt, np.asarray(toks), LOGITS_TOL, "[peer generate]")
        log(f"  [peer] (a) reply byte for byte the sender's; {len(toks)} tokens the sender's, "
            f"worst teacher-forced gap {gap:.4f}")
        log(f"  [peer] (a) launches: flash_attention {flash} (n_layers {layers} x 1 :predict; "
            f"the promotion runs no warm-up), paged_decode_attention {paged} (n_layers x "
            f"{steps} decode steps), paged_verify_attention {verify}")
        if flash != layers or paged != layers * steps or not steps or verify:
            raise AssertionError(f"[peer] (a) launches flash {flash}, paged {paged}, verify "
                                 f"{verify} against {layers}, {layers} x {steps}, 0")
        kernels["flash_attention"]["launches_peer_phase"] = flash
        kernels["paged_decode_attention"]["launches_peer_phase"] = paged
        traces = TRACER.query(n=64)
        (fetch,) = _spans_named(traces, "peer_fetch")
        (wire,) = _spans_named(traces, "peer_wire")
        (rebuild,) = _spans_named(traces, "peer_build_entry")
        loads = _spans_named(traces, "load")
        if [ld["attrs"].get("tier") for ld in loads] != ["host"] or any(
                c["name"] == "artifact_read" for c in loads[0].get("children", ())):
            raise AssertionError(f"[peer] (a) loads {[ld['attrs'] for ld in loads]}: want one "
                                 "promotion with no artifact read")
        nbytes = fetch["attrs"]["bytes"]
        if m.peer_fetch_bytes.labels("ok").value != nbytes or nbytes <= 0:
            raise AssertionError(f"[peer] (a) peer_fetch_bytes{{ok}} "
                                 f"{m.peer_fetch_bytes.labels('ok').value} != {nbytes}")
        wire_s, build_s = wire["duration_s"], rebuild["duration_s"]
        promote_s, first_s = loads[0]["duration_s"], got["predict"][2]
        cold_ms = RUN_NOTES.get("serve_cold_ms")
        log(f"  [peer] (a) {card}: wire {nbytes} bytes in {wire_s * 1e3:.1f} ms = "
            f"{nbytes / wire_s / 1e6:.1f} MB/s (the sender in its own process, localhost "
            f"gRPC, {cfg.cluster.peer_fetch_chunk_bytes}-byte frames, hashed and written "
            f"behind); the entry's rebuild "
            f"{build_s * 1e3:.1f} ms (page-locked: {rebuild['attrs'].get('pinned')}); the peer fetch "
            f"{fetch['duration_s'] * 1e3:.1f} ms in all; the promotion "
            f"{promote_s * 1e3:.1f} ms ({nbytes / promote_s / 1e9:.2f} GB/s); the first reply "
            f"{first_s * 1e3:.1f} ms (fetch + promotion + forward, host clock) against the "
            f"serve phase's cold :predict from the store "
            + (f"{cold_ms:.1f} ms" if cold_ms is not None else "not measured in this run"))

        # --- arm (b): a corrupt chunk ---------------------------------------
        faults.arm([faults.FaultSpec(kind="corrupt_peer_chunk", count=1)])
        try:
            status, raw, dt = _post_raw(f"{rx}/{PEER_MNIST}/versions/1:classify",
                                        bodies["classify"][1])
            fired = faults.snapshot()[0]["fired"]
        finally:
            faults.disarm()
        errors = m.peer_fetch_bytes.labels("error").value
        sources = {t: m.reload_source.labels(t).value for t in ("store", "peer")}
        log(f"  [peer] (b) corrupt_peer_chunk fired {fired}: peer_fetch_bytes{{error}} "
            f"{errors}, reload sources {sources}, :classify {status} in {dt * 1e3:.1f} ms")
        if status != 200 or raw != want["classify"]:
            raise AssertionError(f"[peer] (b) :classify answered {status}, not the sender's "
                                 "reply")
        if fired != 1 or errors <= 0 or sources != {"store": 1, "peer": 1}:
            raise AssertionError(f"[peer] (b) fired {fired}, error bytes {errors}, sources "
                                 f"{sources}: want 1, > 0, store 1 and peer 1")

        # --- arm (c): an object store ----------------------------------------
        s3 = _FakeS3(art.store)
        s3_cfg["model_provider"]["endpoint"] = f"http://127.0.0.1:{s3.port}"
        s3_node = build_node(config_from_dict(s3_cfg), device="cuda")
        url = f"http://127.0.0.1:{s3_node.start('127.0.0.1')}/v1/models/{PEER_MNIST}"
        status, raw, dt = _post_raw(f"{url}/versions/1:classify", bodies["classify"][1])
        stores = s3_node.metrics.reload_source.labels("store").value
        log(f"  [peer] (c) an s3 provider over a fake S3 endpoint: cold :classify {status} "
            f"in {dt * 1e3:.1f} ms, reload_source{{store}} {stores}")
        if status != 200 or raw != want["classify"] or stores != 1:
            raise AssertionError(f"[peer] (c) :classify answered {status} (store loads "
                                 f"{stores}), not the disk-provider node's reply")
        log("  [peer] (c) reply byte for byte the disk-provider node's")
    finally:
        for closer in (s3_node, router, node, sender, s3):
            if closer is not None:
                closer.close()
        for cache in ("peer_rx", "peer_s3"):
            shutil.rmtree(os.path.join(art.work, f"cache_{cache}"), ignore_errors=True)




# Switch-Base-8 (Fedus, Zoph and Shazeer, "Switch Transformers", 2021; the
# google/switch-base-8 config): d_model 768, 12 heads of 64, 8 experts of
# d_ff 3072 with top-1 routing at capacity factor 1.25, vocab 32128, 12
# layers; served as a decoder-only moe_lm at max_seq 1024 in bf16, random
# weights from --seed (~506 M params, ~1.01 GB)
MOE_CONFIG = {"vocab_size": 32128, "d_model": 768, "n_layers": 12, "n_heads": 12,
              "n_kv_heads": 12, "d_ff": 3072, "n_experts": 8, "capacity_factor": 1.25,
              "aux_loss_weight": 0.01, "max_seq": 1024, "rope_theta": 10000.0,
              "dtype": "bfloat16"}
MOE_SHAPES = [(1, 128), (2, 512), (4, 1024)]  # :predict, one cold request, then warm
MOE_PROMPTS = (100, 70)   # the solo :generate prompts (B = 1: the first; B = 2: both)
MOE_NEW_TOKENS = 32
MOE_DRAFT_LAYERS = 2      # the speculative draft: the target's embed, first layers, ln_f
MOE_DEFAULT_SHAPES = [(1, 128), (1, 128), (2, 512)]  # the family's DEFAULT_CONFIG (C15)
# A token's expert is a discrete choice: where its top-2 router logits lie
# within bf16 noise of each other, or its queue position sits at its
# expert's capacity, the kernel path and the plain path may route it
# differently, and its logits then differ by far more than attention's
# rounding. The plain forward's routing of a row's checked token decides
# whether LOGITS_TOL binds: its smallest top-2 router-logit margin over the
# layers must be at least MOE_ROUTER_TIE (about 10x the router-logit gap
# that bf16 attention rounding leaves, ~2**-9 of N(0, 1) logits) and its
# queue position at least MOE_SLOT_SLACK places from the capacity edge.
MOE_ROUTER_TIE = 2.0**-5
MOE_SLOT_SLACK = 2


def _bf16_tree(tree):
    if isinstance(tree, dict):
        return {k: _bf16_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16_tree(v) for v in tree]
    return tree.bfloat16()


def _moe_plain(model, padded, last):
    """The plain path (attention_reference in every layer) over ``padded``
    (B, S) -> (logits (B, S, V) on the card, and for the token of each row
    at ``last[r]``: the smallest top-2 router-logit margin over the layers
    and the smallest distance of its queue position to its expert's
    capacity edge), the routing recomputed as ``moe_lm.moe_block`` routes
    from each layer's MoE input."""
    import torch

    from tfservingcache_tpu_torch.ops import attention as A

    margins, slack = [], []

    def hook(mod, args):
        h, cfg = args
        b, s, _ = h.shape
        t, e = b * s, cfg["n_experts"]
        cap = max(1, math.ceil(cfg["capacity_factor"] * t / e))
        logits = h.reshape(t, -1).float() @ mod.router.float()
        top2 = logits.topk(2, dim=-1).values
        expert = torch.softmax(logits, dim=-1).argmax(dim=-1)
        onehot = (expert[:, None] == torch.arange(e, device=h.device)).long()
        slot = onehot.cumsum(dim=0).gather(1, expert[:, None])[:, 0] - 1
        idx = torch.arange(b, device=h.device) * s + torch.as_tensor(last, device=h.device)
        margins.append((top2[:, 0] - top2[:, 1])[idx])
        # kept iff slot < cap: a shift of one place decides it at cap - 1 and cap
        slack.append(torch.minimum((slot - cap + 1).abs(), (slot - cap).abs())[idx])

    hooks = [layer.moe.register_forward_pre_hook(hook) for layer in model.layers]
    try:
        with torch.inference_mode():
            logits = model({"input_ids": torch.from_numpy(padded).cuda()},
                           attention_fn=A.attention_reference)["logits"]
    finally:
        for h in hooks:
            h.remove()
    return (logits, torch.stack(margins).amin(0).cpu().numpy(),
            torch.stack(slack).amin(0).cpu().numpy())


def _moe_check_logits(plain_model, shape, ids, pred, what) -> int:
    """A moe_lm ``:predict`` answer's (B, V) last-token logits against the
    plain path on the card at the same bucket-padded input: _check_logits's
    rule (LOGITS_TOL, argmax on rows whose top-2 margin exceeds twice their
    |diff|) on every row whose token the plain path routes away from a tie
    (MOE_ROUTER_TIE, MOE_SLOT_SLACK). -> the rows it bound."""
    import numpy as np

    from tfservingcache_tpu_torch.runtime.model_runtime import next_bucket

    b, s = shape
    padded = np.zeros((next_bucket(b), next_bucket(s)), np.int32)
    padded[:b, :s] = ids
    logits, margin, slack = _moe_plain(plain_model, padded, [s - 1] * padded.shape[0])
    ref = logits[:b, s - 1, :].float().cpu().numpy()
    del logits
    row_err = np.abs(pred - ref).max(axis=-1)
    top2 = np.sort(ref, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * row_err
    routed = (margin[:b] >= MOE_ROUTER_TIE) & (slack[:b] >= MOE_SLOT_SLACK)
    agree = pred.argmax(-1) == ref.argmax(-1)
    log(f"  [{what}] {shape}: max|logits - plain| per row {np.round(row_err, 5).tolist()} "
        f"(tolerance {LOGITS_TOL}); argmax equal {agree.tolist()}; the checked token's "
        f"smallest router margin {np.round(margin[:b], 4).tolist()}, capacity slack "
        f"{slack[:b].tolist()}: bound rows {routed.tolist()}")
    if not (row_err[routed] <= LOGITS_TOL).all():
        raise AssertionError(f"[{what}] {shape}: logits differ from the plain path by "
                             f"{row_err.tolist()} on rows routed away from a tie")
    if not agree[routed & decided].all():
        raise AssertionError(f"[{what}] {shape}: argmax differs from the plain path")
    return int(routed.sum())


def _moe_first_tokens(plain_model, ids, lengths, first, what) -> int:
    """The reference's rule for a KV-cached moe_lm generate
    (tests/test_generation.py:408-433): each row's first token is the
    argmax of a full forward at the SAME padded shape (capacity routing
    depends on it), here the plain path on the card, up to a bf16 near-tie
    (its logit within LOGITS_TOL of the maximum) on rows routed away from a
    tie. -> the rows it bound."""
    import numpy as np

    from tfservingcache_tpu_torch.runtime.model_runtime import next_bucket

    b, s = ids.shape
    padded = np.zeros((next_bucket(b), next_bucket(s)), np.int32)
    padded[:b, :s] = ids
    last = [int(n) - 1 for n in lengths] + [0] * (padded.shape[0] - b)
    logits, margin, slack = _moe_plain(plain_model, padded, last)
    rows = logits[np.arange(b), last[:b]].float().cpu().numpy()
    del logits
    gap = rows.max(-1) - rows[np.arange(b), first]
    exact = rows.argmax(-1) == first
    routed = (margin[:b] >= MOE_ROUTER_TIE) & (slack[:b] >= MOE_SLOT_SLACK)
    log(f"  [{what}] first tokens {first.tolist()}: the full forward's argmax at the padded "
        f"shape {padded.shape} {exact.tolist()}, gap to its max {np.round(gap, 4).tolist()} "
        f"(tolerance {LOGITS_TOL}); bound rows {routed.tolist()}")
    if not (gap[routed] <= LOGITS_TOL).all():
        raise AssertionError(f"[{what}] a first token is not the full forward's argmax: {gap}")
    return int(routed.sum())


def phase_moe(seed: int, warm_reps: int, kernels: dict) -> None:
    """The moe_lm family on its own store and disk cache: Switch-Base-8 at
    its published widths (MOE_CONFIG) and the family's DEFAULT_CONFIG (head
    dim 32), on one "coalesce" node (moe_lm never takes the continuous
    engine: its expert capacity spans the batch)."""
    import numpy as np
    import torch

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.models import registry
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.server import build_node

    card = nvidia_smi_line()
    work = tempfile.mkdtemp(prefix="tpusc_chip_smoke_moe_")
    node = None
    try:
        store = os.path.join(work, "store")
        t0 = time.monotonic()
        model_def = registry.build("moe_lm", MOE_CONFIG)
        params = _bf16_tree(model_def.init(torch.Generator(device="cuda").manual_seed(seed)))
        n_params = sum(t.numel() for _p, t in registry.flatten_params(params))
        registry.save_artifact(os.path.join(store, "switch8", "1"), model_def, params)
        nbytes = os.path.getsize(os.path.join(store, "switch8", "1", "params.bin"))
        registry.save_artifact(
            os.path.join(store, "switch8_draft", "1"),
            registry.build("moe_lm", dict(MOE_CONFIG, n_layers=MOE_DRAFT_LAYERS)),
            {"embed": params["embed"], "layers": params["layers"][:MOE_DRAFT_LAYERS],
             "ln_f": params["ln_f"]})
        small_def = registry.build("moe_lm", {})
        small = _bf16_tree(small_def.init(torch.Generator(device="cuda").manual_seed(seed + 1)))
        registry.save_artifact(os.path.join(store, "moe_default", "1"), small_def, small)
        log(f"moe_lm at Switch-Base-8 widths: d_model {MOE_CONFIG['d_model']}, "
            f"{MOE_CONFIG['n_heads']} heads of {MOE_CONFIG['d_model'] // MOE_CONFIG['n_heads']}, "
            f"{MOE_CONFIG['n_experts']} experts of d_ff "
            f"{MOE_CONFIG['d_ff']}, capacity factor {MOE_CONFIG['capacity_factor']}, vocab "
            f"{MOE_CONFIG['vocab_size']}, {MOE_CONFIG['n_layers']} layers: {n_params} params, "
            f"{nbytes} bytes; a {MOE_DRAFT_LAYERS}-layer draft of its first layers; the "
            f"family's DEFAULT_CONFIG (head_dim {small_def.config['d_model'] // small_def.config['n_heads']}); "
            f"written in {time.monotonic() - t0:.2f}s")
        plain = model_def.make_module(params).eval()
        small_plain = small_def.make_module(small).eval()
        cfg = config_from_dict({
            "serving": {"load_timeout_s": 900.0, "max_concurrent_models": 3},
            "cache": {"base_dir": os.path.join(work, "cache_moe"),
                      "disk_capacity_bytes": 2 * sum(
                          os.path.getsize(os.path.join(d, f))
                          for d, _dirs, files in os.walk(store) for f in files)},
            "model_provider": {"type": "disk", "base_dir": store},
            "cache_node": {"rest_port": 0, "grpc_port": 0}})
        node = build_node(cfg, device="cuda")
        base = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models"
        layers, vocab = MOE_CONFIG["n_layers"], MOE_CONFIG["vocab_size"]
        rng = np.random.default_rng(seed + 11)
        bound = 0

        # --- :predict: counters to 0, REST requests, counters read ---------
        requests = []
        for shape in MOE_SHAPES:
            ids = rng.integers(0, vocab, size=shape)
            requests += [(shape, ids, i == 0) for i in range(1 + warm_reps)]
        A.FLASH_LAUNCHES.reset()
        results = [(shape, ids, *_post(f"{base}/switch8/versions/1:predict",
                                        {"instances": ids.tolist()}, 900.0))
                   for shape, ids, _first in requests]
        launches = A.FLASH_LAUNCHES.value
        # -------------------------------------------------------------------
        expected = layers * (len(requests) + 1)  # + the load's warm-up forward
        log(f"flash_attention launches over the moe :predict requests: {launches} (n_layers "
            f"{layers} x ({len(requests)} requests + the load's warm-up) = {expected})")
        if launches != expected:
            raise AssertionError(f"moe :predict: {launches} flash launches != {expected}")
        kernels["flash_attention"]["moe_launches"] = launches
        log(f"cold :predict {MOE_SHAPES[0]} (fetch + load + first request): "
            f"{results[0][4] * 1e3:.1f} ms ({card})")
        for shape in MOE_SHAPES:
            warm = [r[4] for r, req in zip(results, requests) if r[0] == shape and not req[2]]
            log(f"warm :predict {shape}: p50 {statistics.median(warm) * 1e3:.2f} ms over "
                f"{len(warm)} requests (host clock, localhost HTTP, JSON; {card})")
        checked = set()
        for shape, ids, status, body, _dt in results:
            if status != 200:
                raise AssertionError(f"moe :predict {shape} answered {status}: {body}")
            pred = np.asarray(body["predictions"], dtype=np.float32)
            if pred.shape != (shape[0], vocab) or not np.isfinite(pred).all():
                raise AssertionError(f"moe :predict {shape}: predictions {pred.shape}")
            if shape not in checked:
                checked.add(shape)
                bound += _moe_check_logits(plain, shape, ids, pred, "switch8")
        # where a warm request's time goes: a forward on the kernel path and
        # one solo decode step (host clock, ends in a sync) against the
        # device kernels inside it (profiler)
        from tfservingcache_tpu_torch.models import generation

        dev_in = {"input_ids": torch.from_numpy(
            rng.integers(0, vocab, size=MOE_SHAPES[0]).astype(np.int32)).cuda()}
        dev = plain.embed.device
        cache = generation.init_cache(MOE_CONFIG, 1, MOE_SHAPES[0][1] + 1, dev)
        step_in = dev_in["input_ids"][:, :1]
        step_pos = torch.full((1,), MOE_SHAPES[0][1], dtype=torch.long, device=dev)

        def forward():
            with torch.inference_mode():
                plain(dev_in)
            torch.cuda.synchronize()

        def step():
            with torch.inference_mode():
                generation._forward_cached_dyn(plain, step_in, cache, step_pos, MOE_CONFIG)
            torch.cuda.synchronize()

        for what, fn in ((f"a {MOE_SHAPES[0]} forward", forward), ("a B = 1 decode step", step)):
            ms = host_ms(fn)
            busy = device_busy_ms(fn)
            share = "not measured" if busy is None else f"{busy:.2f} ms = {busy / ms:.3f}"
            log(f"  {what}: {ms:.2f} ms host clock, its kernels {share} (torch.profiler; "
                f"{card})")
        del cache

        # --- solo greedy :generate (seeded: the solo path) ------------------
        prompts = [rng.integers(1, vocab, size=n) for n in MOE_PROMPTS]
        plain_toks = {}
        for rows in (1, 2):
            ids = np.zeros((rows, max(MOE_PROMPTS[:rows])), np.int64)
            for r in range(rows):
                ids[r, :MOE_PROMPTS[r]] = prompts[r]
            body = {"input_ids": ids.tolist(), "prompt_lengths": list(MOE_PROMPTS[:rows]),
                    "max_new_tokens": MOE_NEW_TOKENS, "seed": seed}
            A.FLASH_LAUNCHES.reset()
            res = [_post(f"{base}/switch8/versions/1:generate", body, 900.0) for _ in range(2)]
            for status, out, _dt in res:
                if status != 200:
                    raise AssertionError(f"moe :generate B={rows} answered {status}: {out}")
            a, b = (np.asarray(out["tokens"]) for _s, out, _dt in res)
            if a.shape != (rows, MOE_NEW_TOKENS) or not (a == b).all():
                raise AssertionError(f"moe :generate B={rows}: {a.shape}, two calls differ")
            if not ((a >= 0) & (a < vocab)).all():
                raise AssertionError(f"moe :generate B={rows}: tokens outside the vocabulary")
            if A.FLASH_LAUNCHES.value:
                raise AssertionError("the solo :generate path launched the flash kernel")
            plain_toks[rows] = a
            bound += _moe_first_tokens(plain, ids, MOE_PROMPTS[:rows], a[:, 0],
                                       f"generate B={rows}")
            log(f"  solo greedy :generate B={rows}, {MOE_NEW_TOKENS} tokens: two calls "
                f"identical, {res[0][2] * 1e3:.1f} / {res[1][2] * 1e3:.1f} ms ({card})")

        # --- solo speculative :generate with the 2-layer moe_lm draft ------
        rt = node.runtime
        rounds0, emitted0 = rt.spec_rounds["solo"], rt.spec_emitted["solo"]
        ids = np.asarray([prompts[0]], np.int64)
        status, out, dt = _post(f"{base}/switch8/versions/1:generate", {
            "input_ids": ids.tolist(), "max_new_tokens": MOE_NEW_TOKENS,
            "draft_model": "switch8_draft", "spec_tokens": SPEC_TOKENS}, 900.0)
        if status != 200:
            raise AssertionError(f"moe speculative :generate answered {status}: {out}")
        spec = np.asarray(out["tokens"])[0]
        rounds = rt.spec_rounds["solo"] - rounds0
        emitted = rt.spec_emitted["solo"] - emitted0
        if spec.shape != (MOE_NEW_TOKENS,) or not rounds:
            raise AssertionError(f"moe speculative :generate: {spec.shape}, {rounds} rounds")
        differ = np.flatnonzero(spec != plain_toks[1][0]).tolist()
        log(f"  speculative :generate B=1 (draft {MOE_DRAFT_LAYERS} layers, spec "
            f"{SPEC_TOKENS}): {rounds} rounds, {emitted / rounds:.3f} tokens a round; "
            f"{dt * 1e3:.1f} ms ({card}); tokens {spec.tolist()}; positions that differ from "
            f"the plain greedy run: {differ} (verify chunks route other shapes than width-1 "
            f"steps, so capacity drops may differ)")

        # --- C15: the family's DEFAULT_CONFIG (head_dim 32) ----------------
        small_layers = small_def.config["n_layers"]
        reqs = [(shape, rng.integers(0, small_def.config["vocab_size"], size=shape))
                for shape in MOE_DEFAULT_SHAPES]
        A.FLASH_LAUNCHES.reset()
        small_res = [(shape, ids, *_post(f"{base}/moe_default/versions/1:predict",
                                          {"instances": ids.tolist()}, 900.0))
                     for shape, ids in reqs]
        d32_launches = A.FLASH_LAUNCHES.value
        expected = small_layers * (len(reqs) + 1)
        log(f"flash_attention launches at head_dim 32 (moe_lm DEFAULT_CONFIG :predict): "
            f"{d32_launches} (n_layers {small_layers} x ({len(reqs)} requests + the load's "
            f"warm-up) = {expected})")
        if d32_launches != expected:
            raise AssertionError(f"head_dim 32 :predict: {d32_launches} launches != {expected}")
        kernels["flash_attention"]["d32_launches"] = d32_launches
        checked = set()
        for shape, ids, status, body, _dt in small_res:
            if status != 200:
                raise AssertionError(f"moe_default :predict {shape} answered {status}: {body}")
            pred = np.asarray(body["predictions"], dtype=np.float32)
            if pred.shape != (shape[0], small_def.config["vocab_size"]) or \
                    not np.isfinite(pred).all():
                raise AssertionError(f"moe_default :predict {shape}: predictions {pred.shape}")
            if shape not in checked:
                checked.add(shape)
                bound += _moe_check_logits(small_plain, shape, ids, pred,
                                           "moe_default, head_dim 32")
        if not bound:
            raise AssertionError("no moe check bound: every checked token sat at a routing tie")
        log(f"moe checks bound on {bound} rows; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    finally:
        if node is not None:
            node.close()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


# the zoo phase (item 11b): the per-tenant classifier families at their
# published widths, each tenant from its own seed, on one node whose device
# holds two models at a time (BASELINE.json configs #3 and #4)
ZOO_BERT_SHAPES = [(1, 128), (8, 128), (4, 512)]  # :predict, one cold request, then warm
ZOO_BERT_PAD = 100          # the padded check: (1, 100) against (1, 128) with a masked tail
ZOO_CAP = 384               # the capped tenant's max_seq (a SQuAD fine-tune's length)
ZOO_CAPPED_SHAPES = [(1, 300), (1, 400)]  # 300 pads to 384 and answers; 400 is refused
ZOO_CLASSIFY = (2, 64)      # a :classify of two 64-token examples
ZOO_RESNET_BATCHES = [1, 8, 32]  # :predict, the first cold, then warm
ZOO_RESIDENT = 2            # the node's max_concurrent_models
# a reply's logits against the same module's bf16 forward on the CPU: within
# twice that forward's own distance to its f32 forward, plus 2**-5 (random
# weights carry no training that damps a flipped bf16 ulp, so the bf16 noise
# floor is the yardstick: tests/test_torch_resnet.py)
ZOO_TOL_FLOOR = 2.0**-5


class _ZooPlain:
    """Each tenant's plain forward on the CPU in bf16 (the served module)
    and in f32, on its artifact's weights; results memoized per input."""

    def __init__(self) -> None:
        self.models: dict = {}
        self.memo: dict = {}

    def add(self, name: str, model_def, params) -> None:
        import torch

        from tfservingcache_tpu_torch.models import registry, resnet

        if model_def.family == "resnet":
            f32 = resnet.ResNet(params, model_def.config, torch.float32)
        else:
            f32 = registry.build(model_def.family,
                                 dict(model_def.config, dtype="float32")).make_module(params)
        self.models[name] = (model_def.make_module(params).eval(), f32.eval())

    def logits(self, name: str, inputs: dict):
        """-> (bf16 logits, f32 logits), float64 numpy."""
        import numpy as np
        import torch

        key = (name, tuple((k, v.shape, v.tobytes()) for k, v in sorted(inputs.items())))
        if key not in self.memo:
            with torch.inference_mode():
                got = [m({k: torch.from_numpy(v) for k, v in inputs.items()})["logits"]
                       .double().numpy() for m in self.models[name]]
            self.memo[key] = (np.asarray(got[0]), np.asarray(got[1]))
        return self.memo[key]


def _zoo_tol(plain: _ZooPlain, name: str, inputs: dict) -> float:
    """ZOO_TOL_FLOOR's rule on the tenant's CPU forwards of ``inputs``."""
    import numpy as np

    ref16, ref32 = plain.logits(name, inputs)
    return 2 * float(np.abs(ref16 - ref32).max()) + ZOO_TOL_FLOOR


def _zoo_check(plain: _ZooPlain, name: str, inputs: dict, replies: list, what: str) -> float:
    """Replies' (B, C) logits against the tenant's plain CPU forward on the
    same inputs (ZOO_TOL_FLOOR's rule); the argmax equal on every row whose
    top-2 margin exceeds twice that row's max |diff| (the tie rule of
    tests/test_torch_transformer_lm.py; every row whose margin exceeds twice
    the tolerance is among them). -> the tolerance."""
    import numpy as np

    ref16, _ref32 = plain.logits(name, inputs)
    tol = _zoo_tol(plain, name, inputs)
    got = np.asarray(replies, np.float64)
    if got.shape[1:] != ref16.shape or not np.isfinite(got).all():
        raise AssertionError(f"[zoo] {what}: logits {got.shape}, want {ref16.shape}, finite")
    row_diff = np.abs(got - ref16).max(axis=(0, 2))
    diff = float(row_diff.max())
    top2 = np.sort(ref16, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * row_diff
    agree = (got.argmax(-1) == ref16.argmax(-1)).all(0)
    log(f"  [zoo] {what}, {len(got)} replies: max|logits - CPU bf16 forward| {diff:.5f} "
        f"(tolerance {tol:.5f}: the CPU bf16 forward sits {(tol - ZOO_TOL_FLOOR) / 2:.5f} from "
        f"its f32 one); argmax equal on {int(agree[decided].sum())} of {int(decided.sum())} "
        f"decided rows ({len(agree)} rows)")
    if diff > tol:
        raise AssertionError(f"[zoo] {what}: logits differ from the CPU forward by {diff}")
    if not agree[decided].all():
        raise AssertionError(f"[zoo] {what}: argmax differs from the CPU forward")
    return tol


def _bert_body(ids, mask) -> bytes:
    return json.dumps({"inputs": {"input_ids": ids.tolist(),
                                  "attention_mask": mask.tolist()}}).encode()


def phase_zoo(seed: int, warm_reps: int, kernels: dict) -> None:
    """bert at bert-base's published widths (DEFAULT_CONFIG) as two tenants
    and a third at max_seq 384, and resnet at ResNet-50's (DEFAULT_CONFIG,
    GroupNorm) as two tenants, f32 artifacts as the reference writes them, on
    one node of ZOO_RESIDENT resident models, its own store and disk cache:
    REST :predict cold and warm, a padded request, the capped tenant's
    bucket, a :classify; every reply against the plain CPU forward; no
    kernel of the port launches (neither family runs one)."""
    import numpy as np
    import torch

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.models import bert, registry, resnet
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.server import build_node

    card = nvidia_smi_line()
    work = tempfile.mkdtemp(prefix="tpusc_chip_smoke_zoo_")
    node = None
    try:
        store = os.path.join(work, "store")
        tenants = {
            "bert_a": ("bert", bert.DEFAULT_CONFIG),
            "bert_b": ("bert", bert.DEFAULT_CONFIG),
            "bert_384": ("bert", dict(bert.DEFAULT_CONFIG, max_seq=ZOO_CAP)),
            "resnet_a": ("resnet", resnet.DEFAULT_CONFIG),
            "resnet_b": ("resnet", resnet.DEFAULT_CONFIG),
        }
        plain = _ZooPlain()
        cuda_params = {}
        t0 = time.monotonic()
        for i, (name, (family, cfg)) in enumerate(tenants.items()):
            model_def = registry.build(family, cfg)
            params = model_def.init(torch.Generator(device="cuda").manual_seed(seed + 20 + i))
            registry.save_artifact(os.path.join(store, name, "1"), model_def, params)
            n_params = sum(t.numel() for _p, t in registry.flatten_params(params))
            nbytes = os.path.getsize(os.path.join(store, name, "1", "params.bin"))
            plain.add(name, model_def, registry.load_artifact(os.path.join(store, name, "1"))[1])
            if name in ("bert_a", "resnet_a"):
                cuda_params[name] = (model_def, params)
            log(f"  [zoo] {name}: {family} {cfg}: {n_params} params, {nbytes} bytes f32")
            del params
        log(f"  [zoo] {len(tenants)} artifacts written and loaded for the CPU forward in "
            f"{time.monotonic() - t0:.2f}s")
        store_bytes = sum(os.path.getsize(os.path.join(d, f))
                          for d, _dirs, files in os.walk(store) for f in files)
        node = build_node(config_from_dict({
            "serving": {"load_timeout_s": 900.0, "max_concurrent_models": ZOO_RESIDENT},
            "cache": {"base_dir": os.path.join(work, "cache_zoo"),
                      "disk_capacity_bytes": 2 * store_bytes},
            "model_provider": {"type": "disk", "base_dir": store},
            "cache_node": {"rest_port": 0, "grpc_port": 0}}), device="cuda")
        base = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models"
        m = node.metrics
        rng = np.random.default_rng(seed + 30)
        vocab = bert.DEFAULT_CONFIG["vocab_size"]
        size = resnet.DEFAULT_CONFIG["image_size"]

        def bert_inputs(shape):
            return {"input_ids": rng.integers(0, vocab, size=shape).astype(np.int32),
                    "attention_mask": np.ones(shape, np.int32)}

        def images(batch):
            # pixel values 0..255, as a decoded image holds them
            return rng.integers(0, 256, size=(batch, size, size, 3)).astype(np.float32)

        counters = {"flash_attention": A.FLASH_LAUNCHES,
                    "paged_decode_attention": A.PAGED_LAUNCHES,
                    "paged_verify_attention": A.VERIFY_LAUNCHES,
                    "flash_attention_carry": A.CARRY_LAUNCHES}
        evict0 = m.evictions.labels("hbm").value
        timed: dict = {}

        # --- the path: counters to 0, the phase's requests, counters read ---
        for c in counters.values():
            c.reset()
        # bert: cold (1, 128), then warm at every shape, one input a shape
        bert_reqs = []
        for k, shape in enumerate(ZOO_BERT_SHAPES):
            inputs = bert_inputs(shape)
            body = _bert_body(inputs["input_ids"], inputs["attention_mask"])
            replies = []
            for r in range(warm_reps + (2 if k == 0 else 1)):
                status, raw, dt = _post_raw(f"{base}/bert_a/versions/1:predict", body)
                if status != 200:
                    raise AssertionError(f"[zoo] bert_a {shape} answered {status}: {raw[:300]}")
                timed.setdefault(("bert_a", "cold (1, 128)" if k == 0 and r == 0
                                  else f"warm {shape}"), []).append(dt)
                replies.append(json.loads(raw)["outputs"]["logits"])
            bert_reqs.append((shape, inputs, replies))
        # the padded request: the same ids, a masked tail of junk tokens
        short = bert_inputs((1, ZOO_BERT_PAD))
        padded = {"input_ids": np.concatenate([short["input_ids"], rng.integers(
            0, vocab, size=(1, 128 - ZOO_BERT_PAD)).astype(np.int32)], axis=1),
                  "attention_mask": np.concatenate([short["attention_mask"], np.zeros(
                      (1, 128 - ZOO_BERT_PAD), np.int32)], axis=1)}
        pad_replies = []
        for inputs in (short, padded):
            status, raw, _dt = _post_raw(f"{base}/bert_a/versions/1:predict",
                                         _bert_body(inputs["input_ids"], inputs["attention_mask"]))
            if status != 200:
                raise AssertionError(f"[zoo] bert_a padded request answered {status}")
            pad_replies.append(np.asarray(json.loads(raw)["outputs"]["logits"]))
        # the capped tenant: 300 tokens pad to 384 (512 would fail the
        # forward), 400 tokens are refused with the reference's message
        capped = bert_inputs(ZOO_CAPPED_SHAPES[0])
        status, raw, dt = _post_raw(f"{base}/bert_384/versions/1:predict",
                                    _bert_body(capped["input_ids"], capped["attention_mask"]))
        if status != 200:
            raise AssertionError(f"[zoo] bert_384 (1, 300) answered {status}: {raw[:300]}")
        capped_logits = json.loads(raw)["outputs"]["logits"]
        timed[("bert_384", "cold (1, 300)")] = [dt]
        over = bert_inputs(ZOO_CAPPED_SHAPES[1])
        status, raw, _dt = _post_raw(f"{base}/bert_384/versions/1:predict",
                                     _bert_body(over["input_ids"], over["attention_mask"]))
        refusal = json.loads(raw).get("error", "")
        if status != 400 or refusal != "'seq' dim 400 exceeds this model's maximum 384":
            raise AssertionError(f"[zoo] bert_384 (1, 400) answered {status}: {raw[:300]}")
        # a :classify of two examples on a third bert tenant (an eviction)
        cls_in = bert_inputs(ZOO_CLASSIFY)
        examples = [{k: v[r].tolist() for k, v in cls_in.items()} for r in range(ZOO_CLASSIFY[0])]
        status, raw, dt = _post_raw(f"{base}/bert_b/versions/1:classify",
                                    json.dumps({"examples": examples}).encode())
        if status != 200:
            raise AssertionError(f"[zoo] bert_b :classify answered {status}: {raw[:300]}")
        cls_rows = json.loads(raw)["results"]
        timed[("bert_b", "cold :classify (2, 64)")] = [dt]
        # resnet: cold at batch 1, then warm at every batch, one input a batch
        resnet_reqs = []
        for k, batch in enumerate(ZOO_RESNET_BATCHES):
            img = images(batch)
            body = json.dumps({"instances": img.astype(np.int32).tolist()}).encode()
            replies = []
            for r in range(warm_reps + (2 if k == 0 else 1)):
                status, raw, dt = _post_raw(f"{base}/resnet_a/versions/1:predict", body)
                if status != 200:
                    raise AssertionError(f"[zoo] resnet_a batch {batch} answered {status}: "
                                         f"{raw[:300]}")
                timed.setdefault(("resnet_a", "cold batch 1" if k == 0 and r == 0
                                  else f"warm batch {batch}"), []).append(dt)
                rows = json.loads(raw)["predictions"]
                replies.append([row["logits"] for row in rows])
                if [row["classes"] for row in rows] != np.argmax(replies[-1], -1).tolist():
                    raise AssertionError(f"[zoo] resnet_a batch {batch}: classes != argmax")
            resnet_reqs.append((batch, img, replies))
        img_b = images(1)
        status, raw, dt = _post_raw(f"{base}/resnet_b/versions/1:predict", json.dumps(
            {"instances": img_b.astype(np.int32).tolist()}).encode())
        if status != 200:
            raise AssertionError(f"[zoo] resnet_b answered {status}: {raw[:300]}")
        resnet_b = [row["logits"] for row in json.loads(raw)["predictions"]]
        timed[("resnet_b", "cold batch 1")] = [dt]
        # bert_a again: evicted by the resnet tenants, reloaded
        inputs = bert_reqs[0][1]
        status, raw, dt = _post_raw(f"{base}/bert_a/versions/1:predict",
                                    _bert_body(inputs["input_ids"], inputs["attention_mask"]))
        if status != 200:
            raise AssertionError(f"[zoo] bert_a reload answered {status}")
        reload_logits = json.loads(raw)["outputs"]["logits"]
        timed[("bert_a", "reload (1, 128)")] = [dt]
        launches = {name: c.value for name, c in counters.items()}
        # -------------------------------------------------------------------
        evictions = m.evictions.labels("hbm").value - evict0
        log(f"  [zoo] kernel launches over the phase's requests: {launches} (neither family "
            f"runs a kernel of the port)")
        for name, n in launches.items():
            kernels[name]["launches_zoo_phase"] = n
        if any(launches.values()):
            raise AssertionError(f"[zoo] a kernel launched on the bert/resnet path: {launches}")

        # every reply against the plain CPU forward
        for shape, inputs, replies in bert_reqs:
            _zoo_check(plain, "bert_a", inputs, replies, f"bert_a {shape}")
        tol = _zoo_check(plain, "bert_a", short, pad_replies[:1], f"bert_a (1, {ZOO_BERT_PAD})")
        pad_gap = float(np.abs(np.asarray(pad_replies[0]) - np.asarray(pad_replies[1])).max())
        log(f"  [zoo] bert_a: (1, {ZOO_BERT_PAD}) against the same ids in (1, 128) with a "
            f"masked tail: max|diff| {pad_gap:.5f} (tolerance {tol:.5f})")
        if pad_gap > tol:
            raise AssertionError(f"[zoo] the padded request's logits moved by {pad_gap}")
        _zoo_check(plain, "bert_384", capped, [capped_logits], "bert_384 (1, 300) -> bucket 384")
        log(f"  [zoo] bert_384 (1, 400): 400 {refusal!r}")
        # :classify scores: the float64 softmax of the CPU forward's logits
        # (softmax moves no score by more than half the logits' max change)
        ref16, _ref32 = plain.logits("bert_b", cls_in)
        e = np.exp(ref16 - ref16.max(-1, keepdims=True))
        scores = np.asarray([[sc for _l, sc in row] for row in cls_rows])
        score_gap = float(np.abs(scores - e / e.sum(-1, keepdims=True)).max())
        tol = _zoo_tol(plain, "bert_b", cls_in)
        labels = [[lab for lab, _sc in row] for row in cls_rows]
        log(f"  [zoo] bert_b :classify {ZOO_CLASSIFY}: labels {labels}, scores within "
            f"{score_gap:.5f} of the CPU forward's float64 softmax (tolerance {tol / 2:.5f})")
        if labels != [["0", "1"]] * ZOO_CLASSIFY[0] or score_gap > tol / 2:
            raise AssertionError(f"[zoo] bert_b :classify: {cls_rows}")
        for batch, img, replies in resnet_reqs:
            _zoo_check(plain, "resnet_a", {"image": img}, replies, f"resnet_a batch {batch}")
        _zoo_check(plain, "resnet_b", {"image": img_b}, [resnet_b], "resnet_b batch 1")
        _zoo_check(plain, "bert_a", bert_reqs[0][1], [reload_logits], "bert_a reloaded (1, 128)")

        for (tenant, what), times in timed.items():
            label = "p50" if len(times) > 1 else "one request"
            log(f"  [zoo] {tenant} :predict {what}: {label} {statistics.median(times) * 1e3:.2f} "
                f"ms over {len(times)} (host clock, localhost HTTP, JSON; {card})")
        log(f"  [zoo] evictions {evictions:.0f} with {ZOO_RESIDENT} resident models over "
            f"{len(tenants)} tenants; reload sources: " + ", ".join(
                f"{s} {m.reload_source.labels(s).value:.0f}" for s in ("store", "disk", "host"))
            + f" ({card})")
        # bert_b, resnet_a, resnet_b and bert_a's reload each evict the
        # least recent of two
        if evictions != 4:
            raise AssertionError(f"[zoo] {evictions} evictions, want 4")

        # where a warm request's time goes: one forward on the card (host
        # clock, ends in a sync) against the device kernels inside it
        for name, shape, inputs in (
                ("bert_a", (8, 128), bert_inputs((8, 128))),
                ("resnet_a", (8, size, size, 3), {"image": images(8)})):
            model_def, params = cuda_params[name]
            module = model_def.make_module(params).eval()
            dev_in = {k: torch.from_numpy(v).cuda() for k, v in inputs.items()}

            def forward():
                with torch.inference_mode():
                    module(dev_in)
                torch.cuda.synchronize()

            ms = host_ms(forward)
            busy = device_busy_ms(forward)
            share = "not measured" if busy is None else f"{busy:.2f} ms = {busy / ms:.3f}"
            log(f"  [zoo] a {name} {shape} forward: {ms:.2f} ms host clock, its kernels "
                f"{share} (torch.profiler; {card})")
            del module, dev_in
        log(f"  [zoo] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({card})")
    finally:
        if node is not None:
            node.close()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


# the t5 phase (item 11b's last family, with item 13's entry points): the
# encoder-decoder at T5 v1.1-base's published widths (google/t5-v1_1-base
# config.json) with the family's tied head, its int8 twin and the family's
# DEFAULT_CONFIG, written by ``cli export`` on the card, on one node whose
# device holds two models at a time
T5_BASE_CONFIG = {"vocab_size": 32128, "d_model": 768, "n_layers": 12, "n_heads": 12,
                  "d_ff": 2048, "rel_buckets": 32, "rel_max_dist": 128, "dtype": "bfloat16"}
T5_SHAPES = [(1, 128, 32), (4, 512, 128), (8, 300, 64)]  # (B, src, tgt): the first cold, then warm
T5_PAD = (100, 60)          # a 100-token source bare and with 60 trailing pad tokens: src 128 / 256
T5_TGT_PAIR = (32, 33)      # the same first 32 target tokens: tgt buckets 32 / 64
T5_RESIDENT = 2             # the node's max_concurrent_models
T5_WARM_BATCHES = "1,4"     # cli warm's --batches
# REST replies of more than this many logits ask for "output_encoding":
# "base64" (the (4, 128, 32128) logits are ~200 MB as JSON numbers)
T5_JSON_MAX = 1 << 21
T5_REFUSAL = "generate is supported for transformer_lm/moe_lm models, not 't5'"


def _t5_cli(args: list[str], cwd: str) -> subprocess.Popen:
    """``python -m tfservingcache_tpu_torch.cli <args>`` from this checkout,
    in ``cwd`` (which holds no config.yaml), on the card (the config's
    default device)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return subprocess.Popen([sys.executable, "-m", "tfservingcache_tpu_torch.cli", *args],
                            cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _t5_wait(procs: dict, what: str, timeout: float = 600.0) -> dict:
    """-> {name: the last line of its standard output}; every process is
    waited for (or killed) before a failure is raised."""
    out, failed = {}, []
    deadline = time.monotonic() + timeout
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        lines = stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            failed.append(f"{name} exited {proc.returncode}: {stderr[-1500:]}")
        else:
            out[name] = lines[-1]
    if failed:
        raise AssertionError(f"[t5] cli {what}: " + "; ".join(failed))
    return out


def _t5_body(src, tgt) -> bytes:
    body = {"inputs": {"input_ids": src.tolist(), "decoder_input_ids": tgt.tolist()}}
    if tgt.size * T5_BASE_CONFIG["vocab_size"] > T5_JSON_MAX:
        body["output_encoding"] = "base64"
    return json.dumps(body).encode()


def _t5_logits(raw: bytes):
    """A columnar reply's logits, JSON numbers or base64, as float32."""
    import base64

    import numpy as np

    out = json.loads(raw)["outputs"]
    if isinstance(out, dict):
        return np.frombuffer(base64.b64decode(out["b64"]), dtype=out["dtype"]).reshape(
            out["shape"])
    return np.asarray(out, np.float32)


def _t5_check(plain: _ZooPlain, name: str, inputs: dict, replies: list, what: str) -> float:
    """Replies' (B, tgt, V) logits against the tenant's plain CPU forward on
    the same inputs, within ZOO_TOL_FLOOR's rule; the argmax equal at every
    position whose top-2 margin exceeds twice that position's max |diff|.
    Replies equal byte for byte are held once. -> the tolerance."""
    import numpy as np

    ref16, _ref32 = plain.logits(name, inputs)
    tol = _zoo_tol(plain, name, inputs)
    for k, got in enumerate(replies):
        if got.shape != ref16.shape or got.dtype != np.float32 or not np.isfinite(got).all():
            raise AssertionError(f"[t5] {what}: logits {got.shape} {got.dtype}, want "
                                 f"{ref16.shape} float32, finite")
        pos_diff = np.abs(got - ref16).max(axis=-1)
        top2 = np.partition(ref16, -2, axis=-1)[..., -2:]
        decided = (top2[..., 1] - top2[..., 0]) > 2 * pos_diff
        agree = got.argmax(-1) == ref16.argmax(-1)
        diff = float(pos_diff.max())
        if k == 0:
            log(f"  [t5] {what}: max|logits - CPU bf16 forward| {diff:.6f} (tolerance "
                f"{tol:.6f}: the CPU bf16 forward sits {(tol - ZOO_TOL_FLOOR) / 2:.6f} from "
                f"its f32 one; |logits| <= {float(np.abs(ref16).max()):.4f}); argmax equal on "
                f"{int(agree[decided].sum())} of {int(decided.sum())} decided positions "
                f"({agree.size} positions, {len(replies)} distinct replies)")
        if diff > tol:
            raise AssertionError(f"[t5] {what}: logits differ from the CPU forward by {diff}")
        if not agree[decided].all():
            raise AssertionError(f"[t5] {what}: argmax differs from the CPU forward")
    return tol


def _t5_repacks(paths: dict, work: str) -> None:
    """``cli repack``: the bf16 artifact into a fresh directory is its
    source byte for byte; the int8 one carries every leaf (q, scale and the
    plain ones) bit for bit, and a second repack is the first byte for byte
    (a first repack regroups the int8 leaves in the file, as the JAX
    package's does)."""
    import torch

    from tfservingcache_tpu_torch.models import registry

    def read(path, name):
        with open(os.path.join(path, name), "rb") as f:
            return f.read()

    out = os.path.join(work, "repack")
    t0 = time.monotonic()
    got = _t5_wait({name: _t5_cli(["repack", paths[name], os.path.join(out, name)], work)
                    for name in ("t5_base", "t5_base_int8")}, "repack")
    again = _t5_wait({"again": _t5_cli(["repack", got["t5_base_int8"],
                                        os.path.join(out, "again")], work)}, "repack")["again"]
    dt = time.monotonic() - t0
    for name in ("params.bin", "model.json"):
        if read(got["t5_base"], name) != read(paths["t5_base"], name):
            raise AssertionError(f"[t5] repack of t5_base: {name} differs from its source")
        if read(again, name) != read(got["t5_base_int8"], name):
            raise AssertionError(f"[t5] a second repack of t5_base_int8: {name} differs")
    src = registry.flatten_params(registry.load_artifact(paths["t5_base_int8"], raw_quant=True)[1])
    new = dict(registry.flatten_params(registry.load_artifact(got["t5_base_int8"],
                                                              raw_quant=True)[1]))
    quant = 0
    for path, leaf in src:
        other = new.pop(path)
        if isinstance(leaf, registry.QuantLeaf):
            quant += 1
            same = (isinstance(other, registry.QuantLeaf) and other.orig_dtype == leaf.orig_dtype
                    and torch.equal(other.q, leaf.q) and torch.equal(other.scale, leaf.scale))
        else:
            same = (not isinstance(other, registry.QuantLeaf) and other.dtype == leaf.dtype
                    and torch.equal(other.view(torch.uint8), leaf.view(torch.uint8)))
        if not same:
            raise AssertionError(f"[t5] repack of t5_base_int8 changed leaf {path}")
    if new:
        raise AssertionError(f"[t5] repack of t5_base_int8 added leaves {sorted(new)}")
    log(f"  [t5] cli repack (two processes, then one): t5_base byte for byte its source; "
        f"t5_base_int8 every leaf bit for bit ({quant} int8), its second repack byte for byte "
        f"its first, in {dt:.2f}s")
    shutil.rmtree(out, ignore_errors=True)


def phase_t5(seed: int, warm_reps: int, kernels: dict) -> None:
    """t5 at T5 v1.1-base's widths (bf16 and int8) and at the family's
    DEFAULT_CONFIG, exported by ``cli export`` on the card into a store and
    disk cache of their own (deleted at the end), on one node of
    T5_RESIDENT resident models: REST ``:predict`` cold and warm at
    T5_SHAPES, the cross-bucket pairs, a gRPC ``Predict``, the ``:generate``
    refusal, the other tenants and a reload; every reply against the same
    artifact's plain CPU forward; B1-B4 launch 0 times (t5's attention is
    plain ops, as the reference's); ``cli repack`` and ``cli warm``."""
    import numpy as np
    import torch

    from tfservingcache_tpu_torch.config import config_from_dict
    from tfservingcache_tpu_torch.models import registry, t5
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.runtime.model_runtime import next_bucket
    from tfservingcache_tpu_torch.server import build_node

    card = nvidia_smi_line()
    work = tempfile.mkdtemp(prefix="tpusc_chip_smoke_t5_")
    node = None
    try:
        store = os.path.join(work, "store")
        tenants = {"t5_base": (T5_BASE_CONFIG, None, seed + 40),
                   "t5_base_int8": (T5_BASE_CONFIG, "int8", seed + 40),
                   "t5_default": (t5.DEFAULT_CONFIG, None, seed + 41)}
        t0 = time.monotonic()
        procs = {}
        for name, (cfg, quantize, tseed) in tenants.items():
            args = ["export", "t5", store, "--name", name, "--config-json", json.dumps(cfg),
                    "--seed", str(tseed)]
            procs[name] = _t5_cli(args + (["--quantize", quantize] if quantize else []), work)
        paths = _t5_wait(procs, "export")
        log(f"  [t5] cli export of {len(tenants)} tenants, one process each on the card, all "
            f"started together: {time.monotonic() - t0:.2f}s")
        plain = _ZooPlain()
        sizes = {}
        for name, path in paths.items():
            if path != os.path.join(store, name, "1"):
                raise AssertionError(f"[t5] cli export printed {path!r}")
            with open(os.path.join(path, "model.json")) as f:
                manifest = json.load(f)["params"]["manifest"]
            n_params = sum(math.prod(e["shape"]) for e in manifest)
            sizes[name] = os.path.getsize(os.path.join(path, "params.bin"))
            model_def, params = registry.load_artifact(path)
            plain.add(name, model_def, params)
            log(f"  [t5] {name}: {model_def.config}: {n_params} params, {sizes[name]} bytes "
                f"({'int8 + f32 scales' if tenants[name][1] else 'bf16'})")
        log(f"  [t5] t5_base_int8 is {sizes['t5_base_int8'] / sizes['t5_base']:.4f}x the bf16 "
            f"bytes; the head is tied (v1.1 has its own lm_head: reduced)")
        _t5_repacks(paths, work)
        store_bytes = sum(sizes.values())
        node = build_node(config_from_dict({
            "serving": {"load_timeout_s": 900.0, "max_concurrent_models": T5_RESIDENT},
            "cache": {"base_dir": os.path.join(work, "cache_t5"),
                      "disk_capacity_bytes": 2 * store_bytes},
            "model_provider": {"type": "disk", "base_dir": store},
            "cache_node": {"rest_port": 0, "grpc_port": 0}}), device="cuda")
        base = f"http://127.0.0.1:{node.start('127.0.0.1')}/v1/models"
        m = node.metrics
        rng = np.random.default_rng(seed + 50)
        vocab = T5_BASE_CONFIG["vocab_size"]

        def t5_inputs(b, src, tgt):
            return {"input_ids": rng.integers(1, vocab, size=(b, src)).astype(np.int32),
                    "decoder_input_ids": rng.integers(0, vocab, size=(b, tgt)).astype(np.int32)}

        def predict(name, inputs, what):
            status, raw, dt = _post_raw(f"{base}/{name}/versions/1:predict",
                                        _t5_body(inputs["input_ids"], inputs["decoder_input_ids"]))
            if status != 200:
                raise AssertionError(f"[t5] {name} {what} answered {status}: {raw[:300]}")
            return raw, dt

        counters = {"flash_attention": A.FLASH_LAUNCHES,
                    "paged_decode_attention": A.PAGED_LAUNCHES,
                    "paged_verify_attention": A.VERIFY_LAUNCHES,
                    "flash_attention_carry": A.CARRY_LAUNCHES}
        evict0 = m.evictions.labels("hbm").value
        timed: dict = {}
        checks = []  # (tenant, inputs, [distinct raw replies], what)

        # --- the path: counters to 0, the phase's requests, counters read ---
        for c in counters.values():
            c.reset()
        for k, (b, src, tgt) in enumerate(T5_SHAPES):
            inputs = t5_inputs(b, src, tgt)
            raws = []
            for r in range(warm_reps + (2 if k == 0 else 1)):
                raw, dt = predict("t5_base", inputs, f"({b}, {src}/{tgt})")
                timed.setdefault(("t5_base", "cold (1, 128/32)" if k == 0 and r == 0
                                  else f"warm ({b}, {src}/{tgt})"), []).append(dt)
                raws.append(raw)
            checks.append(("t5_base", inputs, raws, f"t5_base ({b}, {src}/{tgt})"))
            if k == 0:
                first = inputs
        # a source of 100 tokens bare and with 60 trailing pad tokens
        short = t5_inputs(1, T5_PAD[0], 32)
        padded = {"input_ids": np.concatenate(
            [short["input_ids"], np.zeros((1, T5_PAD[1]), np.int32)], axis=1),
            "decoder_input_ids": short["decoder_input_ids"]}
        pad_raw = [predict("t5_base", x, "pad pair")[0] for x in (short, padded)]
        # a target of 32 tokens against the same 32 and one more
        tgt_a = t5_inputs(1, 128, T5_TGT_PAIR[1])
        tgt_short = {"input_ids": tgt_a["input_ids"],
                     "decoder_input_ids": tgt_a["decoder_input_ids"][:, :T5_TGT_PAIR[0]]}
        tgt_raw = [predict("t5_base", x, "tgt pair")[0] for x in (tgt_short, tgt_a)]
        # one gRPC Predict of the cold request's inputs
        grpc_logits = _t5_grpc(node, first)
        # :generate answers the reference's refusal
        status, raw, _dt = _post_raw(f"{base}/t5_base/versions/1:generate",
                                     json.dumps({"input_ids": [[5, 6, 7]],
                                                 "max_new_tokens": 4}).encode())
        refusal = json.loads(raw).get("error", "")
        if status != 400 or refusal != T5_REFUSAL:
            raise AssertionError(f"[t5] :generate answered {status}: {raw[:300]}")
        # the int8 and the default tenants, then t5_base again (evicted)
        other = {}
        for name in ("t5_base_int8", "t5_default", "t5_base"):
            raw, dt = predict(name, first, "(1, 128/32)")
            what = "reload (1, 128/32)" if name == "t5_base" else "cold (1, 128/32)"
            timed[(name, what)] = [dt]
            other[name] = raw
        launches = {name: c.value for name, c in counters.items()}
        # -------------------------------------------------------------------
        evictions = m.evictions.labels("hbm").value - evict0
        log(f"  [t5] kernel launches over the phase's requests: {launches} (t5's attention is "
            f"plain ops, as the reference's)")
        for name, n in launches.items():
            kernels[name]["launches_t5_phase"] = n
        if any(launches.values()):
            raise AssertionError(f"[t5] a kernel launched on the t5 path: {launches}")

        # every reply against the plain CPU forward of its artifact
        for tenant, inputs, raws, what in checks:
            _t5_check(plain, tenant, inputs, [_t5_logits(r) for r in dict.fromkeys(raws)], what)
        pad_l = [_t5_logits(r) for r in pad_raw]
        tol = _t5_check(plain, "t5_base", short, pad_l[:1], f"t5_base (1, {T5_PAD[0]}/32)")
        _t5_check(plain, "t5_base", padded, pad_l[1:], f"t5_base (1, {sum(T5_PAD)}/32) with "
                  f"{T5_PAD[1]} pad tokens")
        gap = float(np.abs(pad_l[0] - pad_l[1]).max())
        log(f"  [t5] the source bare (src bucket 128) against padded (256): max|diff| "
            f"{gap:.6f} over the {pad_l[0].shape[1]} target positions (tolerance {tol:.6f})")
        if gap > tol:
            raise AssertionError(f"[t5] the padded source moved the logits by {gap}")
        tgt_l = [_t5_logits(r) for r in tgt_raw]
        tol = _t5_check(plain, "t5_base", tgt_short, tgt_l[:1], "t5_base (1, 128/32)")
        _t5_check(plain, "t5_base", tgt_a, tgt_l[1:], "t5_base (1, 128/33)")
        gap = float(np.abs(tgt_l[0] - tgt_l[1][:, :T5_TGT_PAIR[0]]).max())
        log(f"  [t5] target 32 (tgt bucket 32) against 33 (64): max|diff| {gap:.6f} on the 32 "
            f"shared positions (tolerance {tol:.6f})")
        if gap > tol:
            raise AssertionError(f"[t5] the longer target moved the first positions by {gap}")
        rest_first = _t5_logits(checks[0][2][0])
        if grpc_logits is not None:
            if not np.array_equal(grpc_logits, rest_first):
                raise AssertionError(f"[t5] gRPC Predict against REST: max|diff| "
                                     f"{float(np.abs(grpc_logits - rest_first).max())}")
            log(f"  [t5] gRPC Predict (1, 128/32) equal to the REST reply "
                f"({grpc_logits.shape} float32)")
        log(f"  [t5] :generate: 400 {refusal!r}")
        for name, raw in other.items():
            _t5_check(plain, name, first, [_t5_logits(raw)], f"{name} (1, 128/32)")

        for (tenant, what), times in timed.items():
            label = "p50" if len(times) > 1 else "one request"
            log(f"  [t5] {tenant} :predict {what}: {label} {statistics.median(times) * 1e3:.2f} "
                f"ms over {len(times)} (host clock, localhost HTTP; JSON logits up to "
                f"{T5_JSON_MAX} values, base64 above; {card})")
        log(f"  [t5] evictions {evictions:.0f} with {T5_RESIDENT} resident models over "
            f"{len(tenants)} tenants; reload sources: " + ", ".join(
                f"{s} {m.reload_source.labels(s).value:.0f}" for s in ("store", "disk", "host"))
            + f" ({card})")
        # t5_default evicts t5_base, t5_base's reload evicts t5_base_int8
        if evictions != 2:
            raise AssertionError(f"[t5] {evictions} evictions, want 2")
        node.close()
        node = None

        # the served replies against the same module in this process on the
        # card at the runtime's padded shapes, bit for bit (random weights
        # at this depth amplify any rounding difference to the logits' own
        # scale: the CPU bound above decides few positions, this does)
        model_def, params = registry.load_artifact(paths["t5_base"])
        params = _tree_cuda(params)
        module = model_def.make_module(params).eval()
        for _tenant, inputs, raws, what in checks:
            padded = {k: np.pad(v, [(0, next_bucket(n) - n) for n in v.shape])
                      for k, v in inputs.items()}
            with torch.inference_mode():
                want = module({k: torch.from_numpy(v).cuda() for k, v in padded.items()})[
                    "logits"][:, :inputs["decoder_input_ids"].shape[1]].cpu().numpy()
            got = _t5_logits(raws[0])
            if not np.array_equal(got, want):
                raise AssertionError(f"[t5] {what}: the reply against the module in this "
                                     f"process: max|diff| {float(np.abs(got - want).max())}")
        log(f"  [t5] every t5_base reply shape equal bit for bit to the same module's forward "
            f"in this process on the card at the padded shape ({len(checks)} shapes)")
        # the arithmetic layer by layer: the module in f32 on the card against
        # the CPU's f32 module fed each layer's card input
        card32 = registry.build("t5", dict(model_def.config, dtype="float32")).make_module(params)
        _t5_layers(card32.eval(), plain.models["t5_base"][1], first)
        del card32, plain

        # where a warm request's time goes: one (4, 512/128) forward on the
        # card (host clock, ends in a sync) against the device kernels in it
        dev_in = {k: torch.from_numpy(v).cuda() for k, v in t5_inputs(4, 512, 128).items()}

        def forward():
            with torch.inference_mode():
                module(dev_in)
            torch.cuda.synchronize()

        ms = host_ms(forward)
        busy = device_busy_ms(forward)
        share = "not measured" if busy is None else f"{busy:.2f} ms = {busy / ms:.3f}"
        log(f"  [t5] a t5_base (4, 512/128) forward: {ms:.2f} ms host clock, its kernels "
            f"{share} (torch.profiler; {card})")
        # and the reply's encode: JSON numbers at (1, 32), base64 at (4, 128)
        from tfservingcache_tpu_torch.protocol import codec

        for shape, enc in (((1, 32), "json"), ((4, 128), "base64")):
            arr = rng.standard_normal((*shape, vocab), dtype=np.float32)
            enc_ms = host_ms(lambda: codec.encode_predict_json_bytes({"logits": arr}, False,
                                                                     enc), reps=3)
            n = len(codec.encode_predict_json_bytes({"logits": arr}, False, enc))
            log(f"  [t5] encoding a {arr.shape} f32 reply as {enc}: {enc_ms:.2f} ms host clock, "
                f"{n} bytes (median of 3; {card})")
        log(f"  [t5] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({card})")
        del module, dev_in, params
        torch.cuda.empty_cache()

        # cli warm: a process of its own loads the artifact on the card and
        # runs its serving shapes
        t0 = time.monotonic()
        line = _t5_wait({"warm": _t5_cli(["warm", paths["t5_base"], "--batches",
                                          T5_WARM_BATCHES], work)}, "warm")["warm"]
        want = "warmed t5_base@1 (t5): " + ", ".join(
            f"predict b={b}" for b in T5_WARM_BATCHES.split(","))
        log(f"  [t5] cli warm in {time.monotonic() - t0:.2f}s: {line}")
        if not line.startswith(want + " in "):
            raise AssertionError(f"[t5] cli warm printed {line!r}, want {want!r} ...")
    finally:
        if node is not None:
            node.close()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


T5_LAYER_TOL = 1e-4  # f32, card against CPU, a stage's max |diff| over its max |value|


def _t5_layers(card, cpu, inputs: dict) -> None:
    """Teacher-forced stages of one f32 forward: every encoder and decoder
    layer on the card (forward hooks) against the CPU module's same layer on
    the card's inputs to it; the embedding gather, the relative biases (bit
    for bit), the encoder's final norm and the head likewise. Each stage's
    own error, not the depth's amplified sum, within T5_LAYER_TOL."""
    import torch

    from tfservingcache_tpu_torch.models import t5

    seen = []
    layers = ([(f"enc{i}", layer, cpu.enc_layers[i]) for i, layer in enumerate(card.enc_layers)]
              + [(f"dec{i}", layer, cpu.dec_layers[i]) for i, layer in enumerate(card.dec_layers)])
    hooks = [layer.register_forward_hook(
        lambda _m, args, out, name=name, ref=ref: seen.append((name, ref, args, out)))
        for name, layer, ref in layers]
    try:
        with torch.inference_mode():
            logits = card({k: torch.from_numpy(v).cuda() for k, v in inputs.items()})["logits"]
    finally:
        for h in hooks:
            h.remove()

    def host(a):
        return a.cpu() if isinstance(a, torch.Tensor) else a

    worst = {}

    def hold(stage, got, want):
        got, want = host(got).double(), want.double()
        worst[stage] = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))

    n_enc = len(card.enc_layers)
    with torch.inference_mode():
        ids = {k: torch.from_numpy(v).long() for k, v in inputs.items()}
        hold("embed", seen[0][2][0], cpu._embed(ids["input_ids"]))
        src, tgt = ids["input_ids"].shape[1], ids["decoder_input_ids"].shape[1]
        for got, want in ((seen[0][2][1], cpu._bias(cpu.enc_rel, src, src, True)),
                          (seen[n_enc][2][2], cpu._bias(cpu.dec_rel, tgt, tgt, False))):
            if not torch.equal(host(got), want):
                raise AssertionError("[t5] a relative bias on the card differs from the CPU's")
        for name, ref, args, out in seen:
            hold(name, out, ref(*[host(a) for a in args]))
        hold("enc_ln", seen[n_enc][2][1], t5.rmsnorm(host(seen[n_enc - 1][3]), cpu.enc_ln))
        y = t5.rmsnorm(host(seen[-1][3]), cpu.dec_ln)
        hold("head", logits, (y / math.sqrt(cpu.cfg["d_model"])) @ cpu.embed.t())
    stage, err = max(worst.items(), key=lambda kv: kv[1])
    log(f"  [t5] f32 stages on the card against the CPU's on the same inputs "
        f"({len(worst)} stages, the biases bit for bit): worst {stage} {err:.2e} of its max "
        f"|value| (bound {T5_LAYER_TOL:.0e}); the encoder's {worst['enc0']:.2e} / "
        f"{worst[f'enc{n_enc - 1}']:.2e}, the head's {worst['head']:.2e}")
    if err > T5_LAYER_TOL:
        raise AssertionError(f"[t5] the f32 stage {stage} differs from the CPU's by {err:.3e}")


def _t5_grpc(node, inputs: dict):
    """One gRPC ``Predict`` of ``inputs`` on t5_base -> its logits, or None
    (with a line saying so) where ``grpc`` does not import."""
    if node.grpc_port is None:
        log("  [t5] gRPC not driven: grpcio or protobuf does not import here")
        return None
    from tfservingcache_tpu_torch.protocol import codec
    from tfservingcache_tpu_torch.protocol.grpc_client import ServingStub, make_channel
    from tfservingcache_tpu_torch.protocol.grpc_server import PREDICTION_SERVICE
    from tfservingcache_tpu_torch.protocol.protos import tf_serving_pb2 as sv

    req = sv.PredictRequest()
    req.model_spec.name = "t5_base"
    req.model_spec.version.value = 1
    for k, v in inputs.items():
        req.inputs[k].CopyFrom(codec.numpy_to_tensorproto(v))
    channel = make_channel(f"127.0.0.1:{node.grpc_port}")
    try:
        resp = ServingStub(channel).method(PREDICTION_SERVICE, "Predict")(req, timeout=900)
    finally:
        channel.close()
    return codec.tensorproto_to_numpy(resp.outputs["logits"])


# The lab phase (the JAX package's bench_scenario_lab, bench.py:2702-2861):
# the default 4 scenarios x 5 fault columns on two tenants, each cell a
# seeded open-loop schedule against a fresh continuous paged engine
LAB_TENANTS = ("tenant0", "tenant1")
LAB_REQUESTS = 12
LAB_MAX_NEW = 8
LAB_SEED = 11
LAB_FAULT_S = 0.4
LAB_ENGINE = {"slots": 4, "chunk_tokens": 4, "page_tokens": 16, "arena_pages": 48}
LAB_WARM_LENS = (6, 12, 24)
LAB_DISK_LIMIT = 8 << 30  # the phase's own disk writes (the card machine caps a run's)


def phase_lab(art: Artifact, kernels: dict) -> None:
    """The scenario lab on the card (see the module docstring, phase 18).
    ``tenant1`` is the run's artifact, ``tenant0`` its 1-layer draft
    ``layer0`` (embed + layer 0 + ln_f), both read from the generate arms'
    disk cache, so that the phase copies only what ``stall_store`` evicts."""
    import types

    import numpy as np

    from tfservingcache_tpu_torch.cache.disk_cache import ModelDiskCache
    from tfservingcache_tpu_torch.cache.manager import CacheManager
    from tfservingcache_tpu_torch.cache.providers.disk import DiskModelProvider
    from tfservingcache_tpu_torch.cluster.status import FleetView, NodeStatus
    from tfservingcache_tpu_torch.config import ServingConfig
    from tfservingcache_tpu_torch.lab.scenario import default_faults, default_scenarios, run_cell
    from tfservingcache_tpu_torch.lab.workload import compile_schedule
    from tfservingcache_tpu_torch.models import registry
    from tfservingcache_tpu_torch.ops import attention as A
    from tfservingcache_tpu_torch.runtime.batcher import ContinuousGenerateEngine
    from tfservingcache_tpu_torch.runtime.model_runtime import TorchModelRuntime
    from tfservingcache_tpu_torch.types import ModelId
    from tfservingcache_tpu_torch.utils.metrics import Metrics

    mids = {"tenant0": ModelId("layer0", 1), "tenant1": art.model_id}
    layers = {"tenant0": art.draft_layers, "tenant1": art.layers}
    plain = {"tenant1": types.SimpleNamespace(plain_model=art.plain_model),
             "tenant0": types.SimpleNamespace(plain_model=registry.build(
                 "transformer_lm", dict(art.model_cfg, n_layers=art.draft_layers)).make_module(
                 {"embed": art.params["embed"], "layers": art.params["layers"][:art.draft_layers],
                  "ln_f": art.params["ln_f"]}).eval())}
    scenarios = default_scenarios(LAB_TENANTS, requests=LAB_REQUESTS, max_new=LAB_MAX_NEW)
    schedules = {s.name: compile_schedule(s, seed=LAB_SEED, vocab=art.vocab) for s in scenarios}
    fault_cols = default_faults(duration_s=LAB_FAULT_S)
    metrics = Metrics()
    provider = DiskModelProvider(art.store)
    disk = ModelDiskCache(os.path.join(art.work, "cache_gen"), capacity_bytes=4 * art.nbytes)
    runtime = TorchModelRuntime(ServingConfig(max_concurrent_models=2), device="cuda",
                                metrics=metrics)
    manager = CacheManager(provider, disk, runtime, metrics=metrics)
    try:
        # what the phase writes to disk: each tenant's first copy into the
        # disk cache where it is not there yet, and tenant0 again in every
        # stall_store cell (the cell evicts it to put the stall on the miss)
        size = {t: provider.model_size(m.name, m.version) for t, m in mids.items()}
        first = [t for t, m in mids.items() if disk.size_of(m) is None]
        stalls = sum(f is not None and f.kind == "stall_store" for f in fault_cols) * len(scenarios)
        reckoned = sum(size[t] for t in first) + stalls * size["tenant0"]
        log(f"[lab] disk writes reckoned: {reckoned} bytes ({reckoned / 2**30:.3f} GiB; "
            f"first copies {first}, then tenant0 ({size['tenant0']} bytes) x {stalls} "
            f"stall_store cells; limit {LAB_DISK_LIMIT / 2**30:.0f} GiB)")
        if reckoned > LAB_DISK_LIMIT:
            raise AssertionError(f"[lab] the phase would write {reckoned} bytes > "
                                 f"{LAB_DISK_LIMIT}")
        copies: list[tuple[str, int]] = []  # every artifact the provider copies
        real_load = provider.load_model

        def load_model(name, version, dest):
            model = real_load(name, version, dest)
            copies.append((name, model.size_on_disk))
            return model

        provider.load_model = load_model
        for mid in mids.values():
            manager.ensure_servable(mid)
        head_dim = art.model_cfg["d_model"] // art.model_cfg["n_heads"]
        kernel_active = (runtime.device.type == "cuda" and runtime.cfg.kv_paged_kernel
                         and head_dim in A.KERNEL_HEAD_DIMS)
        platform = "gpu" if runtime.device.type == "cuda" else "cpu"

        def census() -> bool:
            try:
                for mid in mids.values():
                    st = runtime._slot_states.get(mid)
                    if st is not None:
                        st.check_page_conservation()
                return True
            except AssertionError:
                return False

        def drop_states() -> None:
            for mid in mids.values():
                runtime.drop_slot_state(mid)

        # a warm sweep over the prompt-length mix of both tenants, so the
        # first cell pays no first-use cost its siblings do not
        warm = ContinuousGenerateEngine(runtime, metrics=metrics, **LAB_ENGINE)
        try:
            for mid in mids.values():
                for plen in LAB_WARM_LENS:
                    warm.generate(mid, np.ones((1, plen), np.int32), max_new_tokens=LAB_MAX_NEW)
        finally:
            warm.close()
            drop_states()
        arena = None
        rows: list[dict] = []
        tokens: dict[tuple[str, str], dict[int, list]] = {}
        b1_phase = 0
        for spec in scenarios:
            for fault in fault_cols:
                kind = "none" if fault is None else fault.kind
                fleet = None
                if kind == "drop_peer":
                    # the baseline snapshot before the arming: the drill then
                    # swallows every refresh and only staleness decays the score
                    fleet = FleetView(stale_after_s=0.5)
                    fleet.ingest(NodeStatus(ident="peer-b", seq=1, t_wall=time.time()))
                got: dict[int, list] = {}
                eng = ContinuousGenerateEngine(runtime, metrics=metrics, **LAB_ENGINE)
                try:
                    # the engine's first request outside the cell and the arming
                    eng.generate(mids[spec.tenants[0]], np.ones((1, 8), np.int32),
                                 max_new_tokens=2)
                    if arena is None:
                        st = runtime._slot_states[mids[spec.tenants[0]]]
                        arena = f"{st.k.dtype}, {tuple(st.k.shape)}"
                    if kind == "stall_store":
                        # after the warm request: the eviction unloads the model
                        disk.remove(mids[spec.tenants[0]])
                        disk.drain_evictions()

                    def gen(sr, eng=eng, fleet=fleet, got=got):
                        mid = mids[sr.tenant]
                        manager.ensure_servable(mid)
                        out, stats = eng.generate(mid, np.asarray(sr.prompt, np.int32)[None],
                                                  max_new_tokens=sr.max_new, return_stats=True)
                        got[sr.index] = out[0].tolist()
                        if fleet is not None:
                            fleet.ingest(NodeStatus(ident="peer-b", seq=sr.index + 2,
                                                    t_wall=time.time()))
                        return {"ok": True, "ttft_s": stats[0]["ttft_s"],
                                "tokens": stats[0]["tokens"], "error": None}

                    steps0 = eng.decode_steps
                    # --- the main path: counters to 0, the cell, counters read ---
                    A.PAGED_LAUNCHES.reset()
                    A.VERIFY_LAUNCHES.reset()
                    row = run_cell(schedules[spec.name], gen, scenario_name=spec.name,
                                   fault=fault, metrics=metrics, census_fn=census,
                                   kernel_active=kernel_active, platform=platform)
                    b1, b3 = A.PAGED_LAUNCHES.value, A.VERIFY_LAUNCHES.value
                    # ---------------------------------------------------------------
                    steps = eng.decode_steps - steps0
                finally:
                    eng.close()
                    drop_states()
                if fleet is not None:
                    row["peer_health_after"] = round(fleet.health("peer-b"), 3)
                row["b1_launches"], row["b3_launches"], row["decode_steps"] = b1, b3, steps
                rows.append(row)
                tokens[(spec.name, kind)] = got
                b1_phase += b1
                log(f"[lab] row {json.dumps(row)}")
                cell = f"[lab] {spec.name} x {kind}"
                if row["lost"] or row["completed"] != LAB_REQUESTS:
                    raise AssertionError(f"{cell}: {row['lost']} lost of {LAB_REQUESTS}: "
                                         f"{row.get('errors')}")
                if kind == "kill_engine" and not row["recovered"] > 0:
                    raise AssertionError(f"{cell}: nothing recovered")
                if fault is not None and not row["fault_injections"] >= 1:
                    raise AssertionError(f"{cell}: the fault never fired")
                if row["conservation_ok"] is not True:
                    raise AssertionError(f"{cell}: the page census failed")
                if not row["kernel_active"] or not b1 > 0 or b3:
                    raise AssertionError(f"{cell}: kernel_active {row['kernel_active']}, B1 "
                                         f"launches {b1}, B3 launches {b3}")
                # B1 once a layer a decode step of each lane's model
                lay = sorted({layers[t] for t in spec.tenants})
                if not lay[0] * steps <= b1 <= lay[-1] * steps:
                    raise AssertionError(f"{cell}: B1 launches {b1} outside n_layers {lay} x "
                                         f"decode steps {steps}")
        # every greedy answer: the no-fault cell's, or a near-tie the plain
        # path's teacher-forced logits allow; the no-fault cells' all checked
        worst, differ = 0.0, 0
        for spec in scenarios:
            base = tokens[(spec.name, "none")]
            for fault in fault_cols:
                kind = "none" if fault is None else fault.kind
                for sr in schedules[spec.name]:
                    toks = tokens[(spec.name, kind)][sr.index]
                    if kind != "none" and toks == base[sr.index]:
                        continue
                    differ += kind != "none"
                    worst = max(worst, _check_greedy(
                        plain[sr.tenant], np.asarray(sr.prompt, np.int32), np.asarray(toks),
                        LOGITS_TOL, f"[lab] {spec.name} x {kind} request {sr.index}"))
        copied = sum(n for _, n in copies)
        log(f"[lab] {len(rows)} cells; B1 launches {b1_phase}; arena {arena}; greedy answers "
            f"off the no-fault cell's {differ}, the plain path's worst gap {worst:.4f} "
            f"(tolerance {LOGITS_TOL}); artifacts copied {[n for n, _ in copies]}: {copied} "
            f"bytes written")
        if copied != reckoned:
            raise AssertionError(f"[lab] {copied} bytes copied, {reckoned} reckoned")
        for r in rows:
            if "peer_health_after" in r:
                log(f"[lab] peer_health_after ({r['scenario']} x drop_peer): "
                    f"{r['peer_health_after']}")
        card = nvidia_smi_line()
        for r in rows:
            if r["fault"] == "none":
                log(f"[lab] {r['scenario']} x none: p50 TTFT {r['p50_ttft_ms']} ms, p95 "
                    f"{r['p95_ttft_ms']} ms, {r['tok_s']} tok/s, wall {r['wall_s']} s ({card})")
        kernels["paged_decode_attention"]["launches"] += b1_phase
        kernels["paged_decode_attention"]["launches_lab_phase"] = b1_phase
    finally:
        manager.close()
        runtime.close()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    depth = parser.add_mutually_exclusive_group()
    depth.add_argument("--layers", type=int, default=4,
                       help="transformer layers of the served model (default 4, ~1.9 GB bf16)")
    depth.add_argument("--full-depth", action="store_true",
                       help="serve all 32 layers (~13.5 GB bf16)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--warm", type=int, default=5, help="warm requests per shape")
    parser.add_argument("--peer-sender", metavar="SPEC", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.peer_sender:  # the peer phase's sender process
        return _peer_sender_main(args.peer_sender)
    layers = 32 if args.full_depth else args.layers

    # the pre-chunk trash-page assertion, read when the runtime is imported
    os.environ["TPUSC_PAGECHECK"] = "1"
    sys.path.insert(0, ROOT)
    if importlib.util.find_spec("tfservingcache_tpu_torch") is None:
        raise SystemExit(f"chip_smoke: tfservingcache_tpu_torch not found next to {__file__}; "
                         "run it from a checkout of the repo")
    with Phase("environment"):
        phase_environment()
    import torch

    with Phase("build"):
        sass = phase_build()
    with Phase("kernels"):
        kernels = phase_kernels(args.seed)
        kernels["flash_attention"]["sass"] = sass["flash_attention"]
        kernels.update(phase_paged_kernel(args.seed))
        kernels.update(phase_verify_kernel(args.seed))
        kernels["paged_verify_attention"]["prefill_shape"] = [1, *PREFILL_KERNEL, PREFILL_CHUNK]
        kernels["paged_verify_attention"]["prefill_rows"] = phase_prefill_kernel(args.seed)
        for name in ("paged_decode_attention", "paged_verify_attention"):
            kernels[name]["sass"] = sass["paged_attention"]
        kernels.update(phase_carry_kernel(args.seed))
        kernels["flash_attention_carry"]["sass"] = sass["flash_attention_carry"]
    with Phase("artifact"):
        art = Artifact(layers, args.seed)
    try:
        with Phase("serve"):
            phase_serve(art, args.seed, args.warm, kernels)
        with Phase("batch"):
            phase_batch(art, args.seed, kernels)
        with Phase("surface"):
            phase_surface(art, args.seed, args.warm, kernels)
        with Phase("tier"):
            phase_tier(art, args.seed, kernels)
        with Phase("quant"):
            phase_quant(art, args.seed, kernels)
        with Phase("generate"):
            phase_generate(art, args.seed, kernels)
        with Phase("observe"):
            phase_observe(art, args.seed)
        with Phase("cluster"):
            phase_cluster(art, args.seed, kernels)
        with Phase("ring"):
            phase_ring(art, args.seed, args.warm, kernels)
        with Phase("peer"):
            phase_peer(art, args.seed, kernels)
        with Phase("moe"):
            phase_moe(args.seed, args.warm, kernels)
        with Phase("zoo"):
            phase_zoo(args.seed, args.warm, kernels)
        with Phase("t5"):
            phase_t5(args.seed, args.warm, kernels)
        with Phase("lab"):
            phase_lab(art, kernels)
    finally:
        art.close()

    log(nvidia_smi_line())
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": CARDS_USED,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
