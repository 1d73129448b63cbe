"""The port's object-store providers (tfservingcache_tpu_torch/cache/
providers/{object_store,s3,gcs,azblob}.py) against in-process fake S3, GCS
and Azure Blob servers: the JAX package's conformance cases
(tests/test_object_providers.py), each a parametrised case a store kind,
with tiny pages that force pagination. Parity with the JAX package: the
same SigV4 headers for the same inputs, and both packages download the same
fake tree into byte-equal files. ``create_provider`` builds each kind from
``model_provider``, and a port node with ``model_provider.type: s3``
cold-loads an artifact from the fake S3 store and answers as a disk node.

Every server binds 127.0.0.1 port 0 and is shut down by its fixture; the
GCS provider gets a static token, so nothing probes a metadata server.
"""

from __future__ import annotations

import datetime
import json
import os
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from xml.sax.saxutils import escape

import pytest

from tfservingcache_tpu.cache.providers import azblob as jazblob
from tfservingcache_tpu.cache.providers import gcs as jgcs
from tfservingcache_tpu.cache.providers import s3 as js3
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu_torch.cache.providers import create_provider
from tfservingcache_tpu_torch.cache.providers.azblob import AZBlobModelProvider, shared_key_auth
from tfservingcache_tpu_torch.cache.providers.base import ModelNotFoundError, ProviderError
from tfservingcache_tpu_torch.cache.providers.gcs import GCSModelProvider
from tfservingcache_tpu_torch.cache.providers.s3 import S3ModelProvider, sigv4_headers
from tfservingcache_tpu_torch.config import ModelProviderConfig, config_from_dict
from tfservingcache_tpu_torch.server import build_node

TIMEOUT = 60.0

PAGE = 2  # force pagination with tiny pages

STORE = {
    "models/tenantA/1/saved_model.json": b'{"family": "half_plus_two"}',
    "models/tenantA/1/variables/weights.bin": b"\x00" * 64,
    "models/tenantA/000000042/saved_model.json": b'{"family": "half_plus_two", "v": 42}',
    "models/tenantA/notaversion/decoy.txt": b"decoy",
    "models/tenantB/3/saved_model.json": b"b3",
    "models/tenantB/7/saved_model.json": b"b7",
}


def list_keys(prefix: str, delimiter: str, marker: str, max_keys: int):
    """Shared fake listing core: S3/GCS/Azure semantics (lexicographic order,
    common-prefix rollup under a delimiter, opaque marker = last examined key)."""
    keys = sorted(k for k in STORE if k.startswith(prefix))
    objects, prefixes = [], []
    seen_prefixes = set()
    count = 0
    last_examined = ""
    next_marker = ""
    limit = max_keys or PAGE
    for k in keys:
        if marker and k <= marker:
            continue
        if count >= limit:
            next_marker = last_examined
            break
        rest = k[len(prefix):]
        if delimiter and delimiter in rest:
            common = prefix + rest.split(delimiter)[0] + delimiter
            if common not in seen_prefixes:
                seen_prefixes.add(common)
                prefixes.append(common)
                count += 1
        else:
            objects.append((k, len(STORE[k])))
            count += 1
        last_examined = k
    return objects, prefixes, next_marker


class FakeS3Handler(BaseHTTPRequestHandler):
    bucket = "testbucket"

    def log_message(self, *a):  # quiet
        pass

    def do_GET(self):
        parsed = urllib.parse.urlsplit(self.path)
        q = dict(urllib.parse.parse_qsl(parsed.query, keep_blank_values=True))
        path = urllib.parse.unquote(parsed.path).lstrip("/")
        if not path.startswith(self.bucket):
            self.send_error(404)
            return
        key = path[len(self.bucket):].lstrip("/")
        if q.get("list-type") == "2":
            objs, prefixes, nm = list_keys(
                q.get("prefix", ""), q.get("delimiter", ""),
                q.get("continuation-token", ""), int(q.get("max-keys", 0)),
            )
            parts = ["<?xml version='1.0'?><ListBucketResult>"]
            for k, size in objs:
                parts.append(f"<Contents><Key>{escape(k)}</Key><Size>{size}</Size></Contents>")
            for p in prefixes:
                parts.append(f"<CommonPrefixes><Prefix>{escape(p)}</Prefix></CommonPrefixes>")
            parts.append(f"<IsTruncated>{'true' if nm else 'false'}</IsTruncated>")
            if nm:
                parts.append(f"<NextContinuationToken>{escape(nm)}</NextContinuationToken>")
            parts.append("</ListBucketResult>")
            body = "".join(parts).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif key in STORE:
            body = STORE[key]
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_error(404)


class FakeGCSHandler(BaseHTTPRequestHandler):
    bucket = "testbucket"

    def log_message(self, *a):
        pass

    def do_GET(self):
        parsed = urllib.parse.urlsplit(self.path)
        q = dict(urllib.parse.parse_qsl(parsed.query, keep_blank_values=True))
        list_path = f"/storage/v1/b/{self.bucket}/o"
        if parsed.path == list_path:
            objs, prefixes, nm = list_keys(
                q.get("prefix", ""), q.get("delimiter", ""),
                q.get("pageToken", ""), int(q.get("maxResults", 0)),
            )
            data = {"items": [{"name": k, "size": str(s)} for k, s in objs]}
            if prefixes:
                data["prefixes"] = prefixes
            if nm:
                data["nextPageToken"] = nm
            body = json.dumps(data).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif parsed.path.startswith(list_path + "/") and q.get("alt") == "media":
            key = urllib.parse.unquote(parsed.path[len(list_path) + 1:])
            if key in STORE:
                body = STORE[key]
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)
        else:
            self.send_error(404)


class FakeAzureHandler(BaseHTTPRequestHandler):
    container = "testcontainer"

    def log_message(self, *a):
        pass

    def do_GET(self):
        parsed = urllib.parse.urlsplit(self.path)
        q = dict(urllib.parse.parse_qsl(parsed.query, keep_blank_values=True))
        path = urllib.parse.unquote(parsed.path).lstrip("/")
        if not path.startswith(self.container):
            self.send_error(404)
            return
        key = path[len(self.container):].lstrip("/")
        if q.get("comp") == "list":
            objs, prefixes, nm = list_keys(
                q.get("prefix", ""), q.get("delimiter", ""),
                q.get("marker", ""), int(q.get("maxresults", 0)),
            )
            parts = ["<?xml version='1.0'?><EnumerationResults><Blobs>"]
            for k, size in objs:
                parts.append(
                    f"<Blob><Name>{escape(k)}</Name><Properties>"
                    f"<Content-Length>{size}</Content-Length></Properties></Blob>"
                )
            for p in prefixes:
                parts.append(f"<BlobPrefix><Name>{escape(p)}</Name></BlobPrefix>")
            parts.append("</Blobs>")
            parts.append(f"<NextMarker>{escape(nm)}</NextMarker></EnumerationResults>")
            body = "".join(parts).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif key in STORE:
            body = STORE[key]
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_error(404)




@pytest.fixture(autouse=True)
def gcs_env_token(monkeypatch):
    """A static bearer token: the GCS provider never probes the (absent)
    GCE metadata server."""
    monkeypatch.setenv("GCS_ACCESS_TOKEN", "test-token")
    for var in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_SESSION_TOKEN"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def servers():
    srvs, threads, ports = [], [], {}
    try:
        for name, handler in [("s3", FakeS3Handler), ("gcs", FakeGCSHandler),
                              ("az", FakeAzureHandler)]:
            srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
            srvs.append(srv)
            threads.append(threading.Thread(target=srv.serve_forever, daemon=True))
            threads[-1].start()
            ports[name] = srv.server_address[1]
        yield ports
    finally:
        for srv in srvs:
            srv.shutdown()
            srv.server_close()
        for t in threads:
            t.join(TIMEOUT)


def make_provider(kind: str, ports, pkg: str = "port") -> object:
    s3, gcs, az = ((S3ModelProvider, GCSModelProvider, AZBlobModelProvider) if pkg == "port"
                   else (js3.S3ModelProvider, jgcs.GCSModelProvider,
                         jazblob.AZBlobModelProvider))
    if kind == "s3":
        return s3("testbucket", base_path="models", region="us-east-1",
                  endpoint=f"http://127.0.0.1:{ports['s3']}")
    if kind == "gcs":
        return gcs("testbucket", base_path="models", endpoint=f"http://127.0.0.1:{ports['gcs']}")
    return az(account_name="acct", account_key="", container="testcontainer",
              base_path="models", endpoint=f"http://127.0.0.1:{ports['az']}")


KINDS = ["s3", "gcs", "az"]


@pytest.mark.parametrize("kind", KINDS)
def test_model_size_sums_objects(kind, servers):
    p = make_provider(kind, servers)
    expect = len(STORE["models/tenantA/1/saved_model.json"]) + len(
        STORE["models/tenantA/1/variables/weights.bin"])
    assert p.model_size("tenantA", 1) == expect


@pytest.mark.parametrize("kind", KINDS)
def test_load_model_downloads_tree(kind, servers, tmp_path):
    p = make_provider(kind, servers)
    model = p.load_model("tenantA", 1, str(tmp_path / "out" / "tenantA" / "1"))
    assert model.identifier.name == "tenantA"
    root = tmp_path / "out" / "tenantA" / "1"
    assert (root / "saved_model.json").read_bytes() == STORE["models/tenantA/1/saved_model.json"]
    assert (root / "variables" / "weights.bin").read_bytes() == \
        STORE["models/tenantA/1/variables/weights.bin"]


@pytest.mark.parametrize("kind", KINDS)
def test_parallel_download_many_objects(kind, servers, tmp_path):
    """A many-file artifact downloads over the bounded worker pool: every
    object lands byte-correct and the size sums them all."""
    added = {f"models/tenantM/1/part-{i:02d}.bin": bytes([i]) * 32 for i in range(20)}
    STORE.update(added)
    try:
        model = make_provider(kind, servers).load_model("tenantM", 1, str(tmp_path / "m" / "1"))
        for i in range(20):
            assert (tmp_path / "m" / "1" / f"part-{i:02d}.bin").read_bytes() == bytes([i]) * 32
        assert model.size_on_disk == 20 * 32
    finally:
        for k in added:
            STORE.pop(k)


@pytest.mark.parametrize("kind", KINDS)
def test_failed_parallel_download_leaves_no_partial(kind, servers, tmp_path):
    """One object failing mid-fetch fails the whole load with its cause,
    and nothing lands at the destination."""
    added = {f"models/tenantF/1/part-{i}.bin": b"x" * 16 for i in range(8)}
    STORE.update(added)
    try:
        p = make_provider(kind, servers)
        orig = p._download

        def flaky(key, dest_path):
            if key.endswith("part-3.bin"):
                raise ProviderError("disk full on part-3")
            orig(key, dest_path)

        p._download = flaky
        dest = tmp_path / "f" / "1"
        with pytest.raises(ProviderError, match="download failed"):
            p.load_model("tenantF", 1, str(dest))
        assert not dest.exists()
    finally:
        for k in added:
            STORE.pop(k)


@pytest.mark.parametrize("kind", KINDS)
def test_zero_padded_version_dir(kind, servers, tmp_path):
    """Store dir 000000042 serves version 42."""
    model = make_provider(kind, servers).load_model("tenantA", 42, str(tmp_path / "m42"))
    assert model.identifier.version == 42
    assert b'"v": 42' in (tmp_path / "m42" / "saved_model.json").read_bytes()


@pytest.mark.parametrize("kind", KINDS)
def test_latest_version_skips_non_numeric(kind, servers):
    p = make_provider(kind, servers)
    assert p.latest_version("tenantA") == 42  # the notaversion/ decoy is ignored
    assert p.latest_version("tenantB") == 7
    assert p.list_versions("tenantA") == [1, 42]


@pytest.mark.parametrize("kind", KINDS)
def test_missing_model_and_version(kind, servers):
    p = make_provider(kind, servers)
    with pytest.raises(ModelNotFoundError):
        p.model_size("nosuchmodel", 1)
    with pytest.raises(ModelNotFoundError):
        p.model_size("tenantA", 99)


@pytest.mark.parametrize("kind", KINDS)
def test_check_healthy_and_down(kind, servers):
    make_provider(kind, servers).check()  # no raise
    down = make_provider(kind, {"s3": 1, "gcs": 1, "az": 1})  # nothing listens on port 1
    with pytest.raises(ProviderError):
        down.check()


@pytest.mark.parametrize("kind", KINDS)
def test_pagination_is_exercised(kind, servers):
    """The fakes page at PAGE entries; tenantA's tree crosses a page."""
    p = make_provider(kind, servers)
    objs = [o for o, _ in p._list_all("models/tenantA/") if o is not None]
    assert len(objs) == 4
    first_page, _, marker = p._list_page("models/tenantA/", "", "")
    assert len(first_page) == PAGE and marker


@pytest.mark.parametrize("kind", KINDS)
def test_streaming_load_announces_every_file(kind, servers, tmp_path):
    """``load_model_streaming`` calls ``on_file`` once for each file it
    lands."""
    seen = []
    make_provider(kind, servers).load_model_streaming(
        "tenantA", 1, str(tmp_path / "s"), on_file=lambda rel, path: seen.append(rel))
    assert sorted(seen) == ["saved_model.json", "variables/weights.bin"]


def test_sigv4_is_deterministic_and_well_formed():
    now = datetime.datetime(2026, 7, 29, 12, 0, 0, tzinfo=datetime.timezone.utc)
    url = "https://b.s3.us-east-1.amazonaws.com/?list-type=2&prefix=a%2Fb"
    h1 = sigv4_headers("GET", url, "us-east-1", "AKIDEXAMPLE", "secret", now=now)
    assert h1 == sigv4_headers("GET", url, "us-east-1", "AKIDEXAMPLE", "secret", now=now)
    auth = h1["authorization"]
    assert auth.startswith(
        "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20260729/us-east-1/s3/aws4_request")
    assert "SignedHeaders=host;x-amz-content-sha256;x-amz-date" in auth
    assert h1["x-amz-date"] == "20260729T120000Z"
    h3 = sigv4_headers("GET", "https://b.s3.us-east-1.amazonaws.com/", "us-east-1",
                       "AKIDEXAMPLE", "secret", session_token="tok", now=now)
    assert "x-amz-security-token" in h3 and "x-amz-security-token" in h3["authorization"]


def test_sigv4_does_not_double_encode_path():
    """The URL's path arrives percent-encoded and is signed verbatim."""
    now = datetime.datetime(2026, 7, 29, 12, 0, 0, tzinfo=datetime.timezone.utc)
    quoted = sigv4_headers("GET", "https://b.s3.us-east-1.amazonaws.com/models/my%20model/1/w.bin",
                           "us-east-1", "AK", "sk", now=now)
    double = sigv4_headers("GET",
                           "https://b.s3.us-east-1.amazonaws.com/models/my%2520model/1/w.bin",
                           "us-east-1", "AK", "sk", now=now)
    assert quoted["authorization"] != double["authorization"]


SIGV4_CASES = [
    ("GET", "https://b.s3.us-east-1.amazonaws.com/?list-type=2&prefix=a%2Fb", "us-east-1", ""),
    ("GET", "https://b.s3.eu-west-1.amazonaws.com/models/my%20model/1/w.bin", "eu-west-1", ""),
    ("GET", "http://127.0.0.1:9000/bucket?continuation-token=x%3Dy&delimiter=%2F&list-type=2",
     "us-east-1", "session"),
    ("HEAD", "https://b.s3.ap-south-1.amazonaws.com/", "ap-south-1", ""),
]


@pytest.mark.parametrize("method,url,region,token", SIGV4_CASES)
def test_sigv4_headers_are_the_references(method, url, region, token):
    now = datetime.datetime(2026, 10, 18, 9, 30, 5, tzinfo=datetime.timezone.utc)
    got = sigv4_headers(method, url, region, "AKIDEXAMPLE", "wJalrXUtnFEMI", token, now=now)
    want = js3.sigv4_headers(method, url, region, "AKIDEXAMPLE", "wJalrXUtnFEMI", token,
                             now=now)
    assert got == want


def test_azure_shared_key_is_the_references():
    headers = {"x-ms-date": "Sun, 18 Oct 2026 09:30:05 GMT", "x-ms-version": "2020-10-02"}
    url = "http://127.0.0.1:1/testcontainer?comp=list&prefix=models%2F&restype=container"
    key = "c2VjcmV0LWtleQ=="
    assert shared_key_auth("GET", url, "acct", key, headers) == \
        jazblob.shared_key_auth("GET", url, "acct", key, headers)


def _tree(root) -> dict:
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _sub, files in os.walk(root) for f in files}


@pytest.mark.parametrize("kind", KINDS)
def test_both_packages_download_the_same_tree(kind, servers, tmp_path):
    added = {f"models/tenantP/1/shard-{i}.bin": os.urandom(64 + i) for i in range(5)}
    added["models/tenantP/1/model.json"] = b'{"format": "tpusc.v2"}'
    STORE.update(added)
    try:
        port = make_provider(kind, servers).load_model("tenantP", 1, str(tmp_path / "p"))
        ref = make_provider(kind, servers, "ref").load_model("tenantP", 1, str(tmp_path / "r"))
        assert port.size_on_disk == ref.size_on_disk
        assert _tree(tmp_path / "p") == _tree(tmp_path / "r") == {
            k[len("models/tenantP/1/"):]: v for k, v in added.items()}
    finally:
        for k in added:
            STORE.pop(k)


@pytest.mark.parametrize("kind,cls", [("disk", "DiskModelProvider"), ("s3", "S3ModelProvider"),
                                      ("gcs", "GCSModelProvider"),
                                      ("azblob", "AZBlobModelProvider")])
def test_create_provider_builds_each_kind(kind, cls, servers):
    cfg = ModelProviderConfig(type=kind, bucket="testbucket", base_path="models",
                              region="us-east-1", container="testcontainer",
                              account_name="acct",
                              endpoint=f"http://127.0.0.1:{servers['s3']}")
    assert type(create_provider(cfg)).__name__ == cls


def test_provider_config_fields_are_the_references():
    from tfservingcache_tpu.config import ModelProviderConfig as JModelProviderConfig

    assert vars(ModelProviderConfig()) == vars(JModelProviderConfig())
    with pytest.raises(ValueError, match="unknown model provider"):
        create_provider(ModelProviderConfig(type="ftp"))


def test_a_node_serves_from_the_fake_s3_store(servers, tmp_path):
    """A port node with ``model_provider.type: s3`` cold-loads an mnist_cnn
    artifact (written by the JAX package) from the fake store and answers
    ``:classify`` as a node over a disk provider of the same artifact."""
    disk = tmp_path / "disk"
    path = jreg.export_artifact("mnist_cnn", str(disk), name="mnist", version=1, seed=4)
    added = {f"models/mnist/1/{rel}": data for rel, data in _tree(path).items()}
    STORE.update(added)
    body = json.dumps({"examples": [{"image": [0.01 * i for i in range(784)]}]}).encode()
    replies = {}
    try:
        for name, provider in (
                ("disk", {"type": "disk", "base_dir": str(disk)}),
                ("s3", {"type": "s3", "bucket": "testbucket", "base_path": "models",
                        "region": "us-east-1",
                        "endpoint": f"http://127.0.0.1:{servers['s3']}"})):
            node = build_node(config_from_dict({
                "cache": {"base_dir": str(tmp_path / f"cache_{name}")},
                "model_provider": provider,
                "cache_node": {"rest_port": 0, "grpc_port": 0},
                "observability": {"flight_dir": str(tmp_path / "flight")},
            }), device="cpu")
            try:
                port = node.start("127.0.0.1")
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/models/mnist/versions/1:classify",
                    data=body, method="POST")
                with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
                    assert resp.status == 200
                    replies[name] = resp.read()
                assert node.metrics.reload_source.labels("store").value == 1
            finally:
                node.close()
    finally:
        for k in added:
            STORE.pop(k)
    assert replies["s3"] == replies["disk"]
