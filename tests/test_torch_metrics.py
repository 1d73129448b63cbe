"""The port's stdlib Prometheus exposition (tfservingcache_tpu_torch/utils/
metrics.py) against the JAX package's ``prometheus_client`` one: the same
``inc``/``observe``/``set`` sequence goes into both ``Metrics``, both
``render()`` outputs are parsed with ``prometheus_client.parser``, and the
families must match — name, type, HELP, label sets, every counter and gauge
sample, every histogram bucket bound and count (the reference's
``*_created`` timestamp series are wall-clock stamps, which the port does
not write; they are left out of the comparison)."""

import random

import pytest
from prometheus_client.parser import text_string_to_metric_families

from tfservingcache_tpu.utils import metrics as jmetrics
from tfservingcache_tpu_torch.utils import metrics

# the families whose sites the port fires, by exposed family name
PORTED = {
    "tfservingcache_proxy_requests", "tfservingcache_proxy_failures",
    "tpusc_request_duration_seconds", "tpusc_requests_in_flight", "tpusc_batcher_queue_depth",
    "tfservingcache_cache", "tfservingcache_cache_hits", "tfservingcache_cache_misses",
    "tfservingcache_cache_duration_seconds", "tfservingcache_cache_fetch_duration_seconds",
    "tpusc_hbm_bytes_in_use", "tpusc_hbm_bytes_peak", "tpusc_models_resident",
    "tpusc_disk_cache_bytes_in_use", "tpusc_evictions", "tpusc_reload_source",
    "tpusc_host_tier_bytes", "tpusc_host_tier_bytes_peak", "tpusc_cold_stage_seconds",
    "tpusc_cold_overlap_ratio",
    "tpusc_coalesced_batches", "tpusc_coalesced_requests",
    "tpusc_gen_slots_active", "tpusc_gen_wasted_steps", "tpusc_gen_admission_wait_seconds",
    "tpusc_gen_oldest_queued_age_seconds", "tpusc_requests_recovered", "tpusc_fault_injected",
    "tpusc_request_phase_seconds", "tpusc_gen_kv_pages_used", "tpusc_gen_kv_pages_total",
    "tpusc_gen_kv_pages_used_peak", "tpusc_gen_kv_pages_shared", "tpusc_gen_prefix_hits",
    "tpusc_gen_preemptions", "tpusc_gen_prefill_chunks", "tpusc_gen_stream_frames",
    "tpusc_gen_kv_arena_bytes", "tpusc_kv_parked_bytes", "tpusc_kv_parked_conversations",
    "tpusc_kv_resume", "tpusc_gen_kv_page_waste_tokens", "tpusc_prefix_cache_hits",
    "tpusc_prefix_cache_misses", "tpusc_prefix_cache_bytes", "tpusc_spec_draft_autodisabled",
    "tpusc_spec_tokens_per_round", "tpusc_spec_accepted_tokens", "tpusc_spec_rounds",
    "tpusc_tenant_tokens", "tpusc_tenant_step_seconds", "tpusc_tenant_kv_page_seconds",
    "tpusc_tenant_byte_seconds", "tpusc_tenant_cold_load_seconds",
    "tpusc_tenant_peer_bytes_served", "tpusc_tenant_dominant_share",
    "tpusc_assignment_warms", "tpusc_scrape_errors", "tpusc_peer_health_score",
    "tpusc_peer_status_age_seconds", "tpusc_fleet_model_replicas",
    "tpusc_model_replicas_target", "tpusc_peer_fetch_bytes",
}


def parse(text: bytes) -> dict[str, dict]:
    """Exposition -> {family: {type, help, samples: {(name, labels): value}}},
    without the ``*_created`` series."""
    out = {}
    for fam in text_string_to_metric_families(text.decode()):
        if fam.name.endswith("_created"):
            continue
        samples = {}
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue
            key = (s.name, tuple(sorted(s.labels.items())))
            assert key not in samples, key
            samples[key] = s.value
        out[fam.name] = {"type": fam.type, "help": fam.documentation, "samples": samples}
    return out


def families_of(m) -> dict[str, object]:
    """Attribute name -> family, for every family the port registers."""
    return {k: v for k, v in vars(m).items() if isinstance(v, metrics._Family)}


def drive(rng: random.Random, port, ref, steps: int = 400) -> None:
    """The same random sequence of writes into both registries, through
    every family the port has (labelled children picked from small pools,
    including values that need escaping)."""
    fams = sorted(families_of(port))
    pool = ["rest", "grpc", "all_models", 'q"uote', "back\\slash", "new\nline", "ünï"]
    for _ in range(steps):
        attr = rng.choice(fams)
        pf, rf = getattr(port, attr), getattr(ref, attr)
        labels = [rng.choice(pool) for _ in pf.labelnames]
        pc = pf.labels(*labels) if labels else pf
        rc = rf.labels(*labels) if labels else rf
        v = rng.choice([0, 1, 2.5, 0.0004, 0.07, 3, 17.25, 1e-9, 1234.5, 61.0, 2048.0])
        if pf.type == "counter":
            pc.inc(v)
            rc.inc(v)
        elif pf.type == "histogram":
            pc.observe(v)
            rc.observe(v)
        else:
            op = rng.choice(["set", "inc", "dec"])
            getattr(pc, op)(v)
            getattr(rc, op)(v)


@pytest.mark.parametrize("model_labels", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_equals_the_reference_after_the_same_writes(model_labels, seed):
    port = metrics.Metrics(model_labels=model_labels)
    ref = jmetrics.Metrics(model_labels=model_labels)
    drive(random.Random(seed), port, ref)
    got, want = parse(port.render()), parse(ref.render())
    assert set(got) == PORTED
    for name, fam in got.items():
        assert fam["type"] == want[name]["type"], name
        assert fam["help"] == want[name]["help"], name
        assert fam["samples"].keys() == want[name]["samples"].keys(), name
        for key, value in fam["samples"].items():
            assert value == pytest.approx(want[name]["samples"][key], rel=1e-12, abs=0), key


def test_untouched_registry_renders_like_the_reference():
    """Before any write: unlabelled counters and gauges at 0, unlabelled
    histograms with empty buckets, labelled families with HELP and TYPE and
    no series."""
    got = parse(metrics.Metrics().render())
    want = parse(jmetrics.Metrics().render())
    assert got == {k: v for k, v in want.items() if k in PORTED}


def test_text_format_matches_generate_latest_line_for_line():
    """Beyond the parse: the port's lines are ``generate_latest``'s, less
    the ``_created`` families."""
    port, ref = metrics.Metrics(), jmetrics.Metrics()
    drive(random.Random(7), port, ref, steps=200)
    want, skip = [], False
    for line in ref.render().decode().splitlines():
        if line.startswith("# HELP "):
            name = line.split()[2]
            skip = name not in PORTED and name.removesuffix("_total") not in PORTED
        if not skip and "_created{" not in line and not line.split(" ")[0].endswith("_created"):
            want.append(line)
    assert port.render().decode().splitlines() == want


def test_model_label_overflows_into_other_like_the_reference():
    for mod in (metrics, jmetrics):
        m = mod.Metrics(model_labels=True, max_model_labels=2)
        assert [m.model_label("a", 1), m.model_label("b", 1), m.model_label("c", 1),
                m.model_label("a", 1), m.model_label("d", 2)] == \
            ["a:1", "b:1", metrics.OTHER_MODELS, "a:1", metrics.OTHER_MODELS]
        assert mod.Metrics().model_label("a", 1) == metrics.ALL_MODELS


def test_observe_phase_arity_follows_model_labels():
    for model_labels in (False, True):
        port = metrics.Metrics(model_labels=model_labels)
        ref = jmetrics.Metrics(model_labels=model_labels)
        for m in (port, ref):
            m.observe_phase("queue", "continuous", "high", 0.003)
            m.observe_phase("decode", "continuous", "", 0.2)
        assert parse(port.render())["tpusc_request_phase_seconds"] == \
            parse(ref.render())["tpusc_request_phase_seconds"]


def test_label_and_value_errors():
    m = metrics.Metrics()
    with pytest.raises(ValueError):
        m.request_count.labels("rest", "extra")
    with pytest.raises(ValueError):
        m.request_count.inc()  # labelled: needs labels()
    with pytest.raises(ValueError):
        m.request_count.labels("rest").inc(-1)
    with pytest.raises(ValueError):
        m.gen_prefill_chunks.labels("x")
    with pytest.raises(ValueError):
        m.spec_tokens_per_round.labels(group="x")
    with pytest.raises(ValueError):
        metrics.Counter("tpusc_prefix_cache_hits_total", "dup", registry=m.registry)
