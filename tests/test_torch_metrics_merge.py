"""The port's scrape-merge (tfservingcache_tpu_torch/utils/metrics.py
``scrape_and_merge``, a stdlib copy of the text parser) against the JAX
package's on the same stdlib fake exporters: the merged exposition is the
reference's byte for byte in both modes (family dedup, summed counters),
dead / non-200 / corrupt targets are dropped and counted alike, and a
node's metrics path serves the merge (``metrics.scrape_targets``)."""

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from tfservingcache_tpu.utils import metrics as jmetrics
from tfservingcache_tpu_torch.utils import metrics
from torch_cluster_util import LoopThread, fake_node, http, make_store

FAKE_TPU = ("# HELP libtpu_hbm_used_bytes HBM in use\n"
            "# TYPE libtpu_hbm_used_bytes gauge\n"
            "libtpu_hbm_used_bytes 12345\n")
OVERLAP = ("# HELP tpusc_models_resident duplicate of our own gauge\n"
           "# TYPE tpusc_models_resident gauge\n"
           "tpusc_models_resident 999\n"
           "# HELP sidecar_only_metric fine\n"
           "# TYPE sidecar_only_metric counter\n"
           'sidecar_only_metric_total{src="a b",q="x\\"y"} 7.0\n'
           "# TYPE some_summary summary\n"
           'some_summary{quantile="0.5"} 1.5\nsome_summary_sum 3\nsome_summary_count 2\n'
           "# HELP h a histogram\n# TYPE h histogram\n"
           'h_bucket{le="1.0"} 1\nh_bucket{le="+Inf"} 2\nh_sum 4.5\nh_count 2\n'
           "untyped_thing{x=\"1\"} 2.5e-07 1700000000000\n")
CORRUPT = "{{{ not prometheus text"


class Exporter:
    """A stdlib HTTP server answering one body with one status."""

    def __init__(self, text: str, status: int = 200):
        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                body = text.encode()
                self.send_response(status)
                self.send_header("Content-Type", "text/plain; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/metrics"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


@pytest.fixture(scope="module")
def loop():
    lt = LoopThread()
    try:
        yield lt
    finally:
        lt.close()


@pytest.fixture(scope="module")
def exporters():
    ex = {name: Exporter(text, status) for name, (text, status) in {
        "tpu": (FAKE_TPU, 200), "overlap": (OVERLAP, 200), "overlap2": (OVERLAP, 200),
        "err": ("", 500), "corrupt": (CORRUPT, 200)}.items()}
    try:
        yield {k: v.url for k, v in ex.items()}
    finally:
        for v in ex.values():
            v.close()


DEAD = "http://127.0.0.1:1/metrics"


def _pair(model_labels: bool):
    port, ref = metrics.Metrics(model_labels=model_labels), jmetrics.Metrics(
        model_labels=model_labels)
    for m in (port, ref):
        m.request_count.labels("rest").inc(3)
        m.tenant_tokens.labels("lm:1" if model_labels else "all_models", "out").inc(4)
        m.request_duration.labels("rest", "predict", "ok", "local").observe(0.02)
    return port, ref


@pytest.mark.parametrize("targets", [
    ["tpu"], ["overlap", "overlap2"], ["tpu", "overlap", "dead", "err", "corrupt"], []])
@pytest.mark.parametrize("sum_counters", [False, True])
def test_merge_equals_the_reference(loop, exporters, targets, sum_counters):
    port, ref = _pair(model_labels=sum_counters)
    urls = [DEAD if t == "dead" else exporters[t] for t in targets]
    # one own page for both (the reference's registry has families the port
    # does not fire, and *_created stamps): the merge itself is compared
    own = port.render()
    got = metrics.scrape_and_merge(own, urls, metrics=port, sum_counters=sum_counters)
    want = loop.run(jmetrics.scrape_and_merge(own, urls, metrics=ref, sum_counters=sum_counters))
    assert got == want
    dropped = sum(t in ("dead", "err", "corrupt") for t in targets)
    assert port.scrape_errors._only().value == dropped
    assert ref.registry.get_sample_value("tpusc_scrape_errors_total") == dropped
    if targets == ["tpu"]:
        assert b"libtpu_hbm_used_bytes 12345" in got
    assert b"{{{" not in got


def test_node_metrics_path_serves_the_merge(tmp_path, exporters):
    store = make_store(tmp_path / "store", [("m", 1)])
    node = fake_node(tmp_path, "a", store,
                     metrics={"scrape_targets": [exporters["tpu"], DEAD]})
    try:
        status, body, _ = http(f"http://127.0.0.1:{node.rest_port}"
                               "/monitoring/prometheus/metrics")
        assert status == 200 and b"libtpu_hbm_used_bytes 12345" in body
        assert b"tpusc_models_resident" in body
        assert b"tpusc_scrape_errors_total 1.0" in node.metrics.render()
    finally:
        node.close()
