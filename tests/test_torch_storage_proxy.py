"""The port's RBAC storage proxy and its upstreams
(``lakesoul_tpu_torch/service/storage_proxy.py``, ``s3_upstream.py``,
``sigv4.py``, ``azure.py``) against the reference's.

- The reference's proxy tests (``test_proxy_verbs.py``,
  ``test_proxy_upstream.py``, ``test_azure_translation.py``, the proxy parts
  of ``test_proxy_examples.py`` and ``test_hdfs_azure.py``, the proxy leg of
  ``test_cli_servers.py``), each with a counterpart here, run against the
  port's modules: every verb behind the JWT + RBAC gate, Range reads,
  multipart uploads with their manifests and abort tombstones, path
  traversal, the cleaner deleting through the proxy, AWS's published SigV4
  examples, DNS discovery with failover, and the S3 and Azure upstreams
  behind fakes that verify every request's signature.
- Across the packages, on one warehouse and one SQLite store: either
  package's ``ProxyStorageClient`` against either package's proxy gives the
  same bytes, listings and errors; raw requests get the same status codes,
  bodies and headers from both proxies, listing XML byte for byte; the
  signers are byte-equal to the reference's on hypothesis-drawn requests,
  and each package's fake upstream accepts the other's signatures.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import http.client
import os
import signal
import socketserver
import subprocess
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape as xml_escape

import numpy as np
import pyarrow as pa
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from lakesoul_tpu import LakeSoulCatalog as RefCatalog
from lakesoul_tpu.service import azure as ref_azure
from lakesoul_tpu.service import sigv4 as ref_sigv4
from lakesoul_tpu.service import storage_proxy as ref_proxy
from lakesoul_tpu_torch import LakeSoulCatalog
from lakesoul_tpu_torch.compaction.cleaner import Cleaner
from lakesoul_tpu_torch.service import azure, sigv4, storage_proxy
from lakesoul_tpu_torch.service.azure import (
    API_VERSION,
    AzureUpstream,
    AzureUpstreamConfig,
    sign_shared_key,
    string_to_sign,
)
from lakesoul_tpu_torch.service.jwt import Claims, JwtServer, UserRegistry
from lakesoul_tpu_torch.service.s3_upstream import DnsDiscovery, S3Upstream, S3UpstreamConfig
from lakesoul_tpu_torch.service.storage_proxy import (
    ProxyDeleter,
    ProxyStorageClient,
    StorageProxy,
    parse_range,
)

SCHEMA = pa.schema([("id", pa.int64()), ("v", pa.float64())])
AK, SK = "AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY"
ACCOUNT = "transacct"
KEY = base64.b64encode(b"translation-test-key-32-bytes!!!").decode()
CONTAINER = "lake"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGV4 = {"port": sigv4, "ref": ref_sigv4}


@pytest.fixture(autouse=True)
def quick_stop(monkeypatch):
    """``serve_forever`` looks for a shutdown every 0.5 s; every proxy and
    fake here stops in a tenth of that."""
    serve = socketserver.BaseServer.serve_forever
    monkeypatch.setattr(socketserver.BaseServer, "serve_forever",
                        lambda self, poll_interval=0.05: serve(self, poll_interval))


@pytest.fixture()
def proxy_env(tmp_warehouse):
    catalog = LakeSoulCatalog(str(tmp_warehouse))
    t = catalog.create_table("t", SCHEMA)
    t.write_arrow(pa.table({"id": [1], "v": [1.0]}))
    proxy = StorageProxy(catalog, jwt_secret="pxy")
    proxy.start()
    token = proxy.jwt_server.create_token(Claims(sub="u", group="public"))
    client = ProxyStorageClient(f"http://127.0.0.1:{proxy.port}", token=token)
    yield catalog, proxy, token, t, client
    proxy.stop()


def _request(url, method="GET", token=None, data=None, headers=None):
    req = urllib.request.Request(url, method=method, data=data)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    return urllib.request.urlopen(req, timeout=10)


def _raw(port, method, path, *, token=None, body=None, headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    h = dict(headers or {})
    if token:
        h["Authorization"] = f"Bearer {token}"
    if body is not None:
        h["Content-Length"] = str(len(body))
    c.request(method, path, body=body, headers=h)
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, dict(r.getheaders()), data


def _priv(catalog, name):
    catalog.client.create_table(name, f"{catalog.warehouse}/default/{name}", SCHEMA,
                                domain="teamZ")


# ------------------------------------------------------------------ the verbs
class TestDelete:
    def test_delete_removes_object(self, proxy_env):
        client = proxy_env[4]
        client.put("default/t/junk.bin", b"x" * 100)
        assert client.head("default/t/junk.bin") == 100
        client.delete("default/t/junk.bin")
        with pytest.raises(OSError):
            client.head("default/t/junk.bin")

    def test_delete_is_idempotent(self, proxy_env):
        proxy_env[4].delete("default/t/never-existed.bin")

    def test_unauthorized_delete_rejected(self, proxy_env):
        catalog, proxy, token, _, client = proxy_env
        _priv(catalog, "priv")
        with pytest.raises(PermissionError):
            client.delete("default/priv/data.parquet")
        with pytest.raises(PermissionError):
            ProxyStorageClient(f"http://127.0.0.1:{proxy.port}").delete("default/t/x.bin")


class TestList:
    def test_list_objects_v2(self, proxy_env):
        client = proxy_env[4]
        client.put("default/t/sub/a.bin", b"aa")
        client.put("default/t/sub/b.bin", b"bbb")
        keys = dict(client.list_objects("default/t"))
        assert keys["default/t/sub/a.bin"] == 2 and keys["default/t/sub/b.bin"] == 3
        assert any(k.endswith(".parquet") for k in keys)

    def test_list_prefix_filter(self, proxy_env):
        client = proxy_env[4]
        client.put("default/t/x/one.bin", b"1")
        client.put("default/t/y/two.bin", b"2")
        assert [k for k, _ in client.list_objects("default/t", prefix="x/")] == [
            "default/t/x/one.bin"]

    def test_list_requires_access(self, proxy_env):
        catalog, _, _, _, client = proxy_env
        _priv(catalog, "priv2")
        with pytest.raises(PermissionError):
            client.list_objects("default/priv2")


class TestMultipart:
    def test_multipart_round_trip(self, proxy_env):
        client = proxy_env[4]
        key = "default/t/big.bin"
        upload = client.initiate_multipart(key)
        parts = [b"A" * 1000, b"B" * 500, b"C" * 250]
        for n in (2, 1, 3):  # out of order: completion assembles by part number
            client.upload_part(key, upload, n, parts[n - 1])
        client.complete_multipart(key, upload)
        assert client.get(key) == b"".join(parts)
        assert not any(".uploads" in k for k, _ in client.list_objects("default/t"))

    def test_multipart_into_a_new_directory(self, proxy_env):
        """A key below a directory that does not exist yet completes on a
        local warehouse, as a plain PUT there does."""
        client = proxy_env[4]
        key = "default/t/new/dir/mp.bin"
        upload = client.initiate_multipart(key)
        client.upload_part(key, upload, 1, b"abc")
        client.complete_multipart(key, upload)
        assert client.get(key) == b"abc"

    def test_abort_drops_parts(self, proxy_env):
        client = proxy_env[4]
        key = "default/t/aborted.bin"
        upload = client.initiate_multipart(key)
        client.upload_part(key, upload, 1, b"zzz")
        client.abort_multipart(key, upload)
        with pytest.raises(OSError):
            client.head(key)
        assert not any(".uploads" in k for k, _ in client.list_objects("default/t"))

    def test_complete_unknown_upload_404(self, proxy_env):
        with pytest.raises(OSError, match="404"):
            proxy_env[4].complete_multipart("default/t/nope.bin", "deadbeef")


class TestRangeStillWorks:
    def test_range_get_with_query_stripped(self, proxy_env):
        client = proxy_env[4]
        client.put("default/t/r.bin", b"0123456789")
        assert client.get("default/t/r.bin", range_header="bytes=2-4") == b"234"


def _deleter(catalog, proxy, sub="svc"):
    token = JwtServer("pxy").create_token(Claims(sub=sub, group="public"))
    return ProxyDeleter(catalog.warehouse,
                        ProxyStorageClient(f"http://127.0.0.1:{proxy.port}", token=token))


def _proxy_of(pkg, catalog_path, db_path):
    """A started proxy of either package over one warehouse."""
    if pkg == "port":
        return StorageProxy(LakeSoulCatalog(catalog_path, db_path=db_path), jwt_secret="pxy")
    return ref_proxy.StorageProxy(RefCatalog(catalog_path, db_path=db_path), jwt_secret="pxy")


class TestCleanerThroughProxy:
    @pytest.mark.parametrize("proxy_pkg", ["port", "ref"])
    def test_cleaner_deletes_via_proxy(self, tmp_path, proxy_pkg):
        wh, db = str(tmp_path / "wh"), str(tmp_path / "m.db")
        catalog = LakeSoulCatalog(wh, db_path=db)
        t = catalog.create_table("c", SCHEMA, primary_keys=["id"], hash_bucket_num=1)
        t.write_arrow(pa.table({"id": [1], "v": [1.0]}))
        t.write_arrow(pa.table({"id": [2], "v": [2.0]}))
        old_files = [f for unit in t.scan().scan_plan() for f in unit.data_files]
        t.compact()
        proxy = _proxy_of(proxy_pkg, wh, db)
        proxy.start()
        try:
            cleaner = Cleaner(catalog, retention_ms=1, discard_grace_ms=1,
                              deleter=_deleter(catalog, proxy))
            cleaner.clean_table("c", now_ms=10**14)
            assert cleaner.clean_discarded_files(now_ms=10**14) == len(old_files)
            assert not any(os.path.exists(f) for f in old_files)
            assert t.to_arrow().sort_by("id").column("id").to_pylist() == [1, 2]
        finally:
            proxy.stop()

    def test_cleaner_through_proxy_respects_rbac(self, tmp_warehouse):
        catalog = LakeSoulCatalog(str(tmp_warehouse))
        _priv(catalog, "priv")
        victim = f"{catalog.warehouse}/default/priv/data.bin"
        os.makedirs(os.path.dirname(victim), exist_ok=True)
        with open(victim, "wb") as f:
            f.write(b"precious")
        proxy = StorageProxy(catalog, jwt_secret="pxy")
        proxy.start()
        try:
            with pytest.raises(PermissionError):
                _deleter(catalog, proxy)(victim, None, missing_ok=True)
            assert os.path.exists(victim)
        finally:
            proxy.stop()

    def test_deleter_refuses_paths_outside_warehouse(self, tmp_warehouse):
        catalog = LakeSoulCatalog(str(tmp_warehouse))
        proxy = StorageProxy(catalog, jwt_secret="pxy")
        proxy.start()
        try:
            with pytest.raises(ValueError, match="outside the warehouse"):
                _deleter(catalog, proxy)("/etc/passwd", None)
        finally:
            proxy.stop()


def _complete(proxy, token, key, upload, parts):
    body = ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber></Part>" for n in parts)
        + "</CompleteMultipartUpload>").encode()
    return _raw(proxy.port, "POST", f"/{key}?uploadId={upload}", token=token, body=body)[0]


class TestMultipartManifest:
    def test_manifest_selects_parts(self, proxy_env):
        _, proxy, token, _, client = proxy_env
        key = "default/t/manifested.bin"
        upload = client.initiate_multipart(key)
        for n, data in enumerate((b"ONE", b"TWO", b"THREE"), start=1):
            client.upload_part(key, upload, n, data)
        assert _complete(proxy, token, key, upload, [1, 3]) == 200
        assert client.get(key) == b"ONETHREE"

    def test_manifest_missing_part_rejected(self, proxy_env):
        _, proxy, token, _, client = proxy_env
        key = "default/t/short.bin"
        upload = client.initiate_multipart(key)
        client.upload_part(key, upload, 1, b"X")
        assert _complete(proxy, token, key, upload, [7]) == 400

    def test_part_upload_to_unknown_or_aborted_upload_404(self, proxy_env):
        client = proxy_env[4]
        with pytest.raises(OSError, match="404"):
            client.upload_part("default/t/ghost.bin", "deadbeef", 1, b"x")
        key = "default/t/resurrect.bin"
        upload = client.initiate_multipart(key)
        client.abort_multipart(key, upload)
        with pytest.raises(OSError, match="404"):
            client.upload_part(key, upload, 1, b"x")
        with pytest.raises(OSError, match="404"):
            client.complete_multipart(key, upload)

    def test_failed_complete_leaves_upload_retryable(self, proxy_env):
        _, proxy, token, _, client = proxy_env
        key = "default/t/retry.bin"
        upload = client.initiate_multipart(key)
        client.upload_part(key, upload, 1, b"ONE")
        assert _complete(proxy, token, key, upload, [1, 2]) == 400
        client.upload_part(key, upload, 2, b"TWO")
        client.complete_multipart(key, upload)
        assert client.get(key) == b"ONETWO"
        with pytest.raises(OSError, match="404"):
            client.complete_multipart(key, upload)


class TestListPaging:
    @pytest.mark.parametrize("client_cls", [ProxyStorageClient, ref_proxy.ProxyStorageClient])
    def test_continuation_token_pages_are_followed(self, client_cls):
        ns = 'xmlns="http://s3.amazonaws.com/doc/2006-03-01/"'
        pages = [
            f'<?xml version="1.0" encoding="UTF-8"?><ListBucketResult {ns}>'
            "<IsTruncated>true</IsTruncated>"
            "<NextContinuationToken>tok+1/=</NextContinuationToken>"
            "<Contents><Key>ns/t/a.bin</Key><Size>1</Size></Contents></ListBucketResult>",
            f'<?xml version="1.0" encoding="UTF-8"?><ListBucketResult {ns}>'
            "<IsTruncated>false</IsTruncated>"
            "<Contents><Key>ns/t/b.bin</Key><Size>2</Size></Contents></ListBucketResult>",
        ]
        queries = []
        client = client_cls("http://127.0.0.1:1")

        def fake_request(method, key, *, body=None, query="", headers=None):
            queries.append(query)
            return 200, {}, pages[len(queries) - 1].encode()

        client._request = fake_request
        assert client.list_objects("ns/t", prefix="p/") == [("ns/t/a.bin", 1), ("ns/t/b.bin", 2)]
        assert "continuation-token" not in queries[0]
        assert "continuation-token=tok%2B1%2F%3D" in queries[1]
        assert all(q.startswith("list-type=2&prefix=p") for q in queries)


class TestPathTraversal:
    BAD = ("/default/t/../../t2/file", "/default/t/./file", "/default/t//file",
           "/default/t/%2e%2e/t2/file", "/default/t/..%2Ft2%2Ffile")

    def test_dotdot_segments_rejected(self, proxy_env):
        _, proxy, token, _, _ = proxy_env
        for path in self.BAD:
            for method in ("DELETE", "PUT", "GET", "HEAD"):
                body = b"x" if method == "PUT" else None
                assert _raw(proxy.port, method, path, token=token, body=body)[0] == 400, (
                    method, path)

    def test_legit_encoded_names_still_work(self, proxy_env):
        _, proxy, token, _, client = proxy_env
        assert _raw(proxy.port, "PUT", "/default/t/part%20one.bin", token=token,
                    body=b"hi")[0] == 201
        assert client.get("default/t/part one.bin") == b"hi"

    def test_traversal_upload_id_never_touches_fs(self, proxy_env):
        _, proxy, token, _, _ = proxy_env
        evil = "..%2F..%2Fevil"
        assert _raw(proxy.port, "PUT", f"/default/t/x.bin?partNumber=1&uploadId={evil}",
                    token=token, body=b"x")[0] == 404
        assert _raw(proxy.port, "POST", f"/default/t/x.bin?uploadId={evil}", token=token,
                    body=b"")[0] == 404

    def test_part_number_range_enforced(self, proxy_env):
        _, proxy, token, _, client = proxy_env
        up = client.initiate_multipart("default/t/ranged.bin")
        for bad in ("0", "-3", "10001", "99999"):
            assert _raw(proxy.port, "PUT", f"/default/t/ranged.bin?partNumber={bad}&uploadId={up}",
                        token=token, body=b"x")[0] == 400, bad
        client.upload_part("default/t/ranged.bin", up, 10000, b"ok")
        client.abort_multipart("default/t/ranged.bin", up)


# ------------------------------------------------ test_proxy_examples' proxy
class TestStorageProxy:
    def test_get_data_file_through_proxy(self, proxy_env):
        catalog, proxy, token, t, _ = proxy_env
        rel = t.scan().scan_plan()[0].data_files[0].replace(catalog.warehouse + "/", "")
        assert _request(f"http://127.0.0.1:{proxy.port}/{rel}", token=token).read()[:4] == b"PAR1"

    def test_put_round_trip(self, proxy_env):
        _, proxy, token, _, _ = proxy_env
        url = f"http://127.0.0.1:{proxy.port}/default/t/extra.bin"
        assert _request(url, method="PUT", token=token, data=b"hello").status == 201
        assert _request(url, token=token).read() == b"hello"

    def test_auth_and_rbac_enforced(self, proxy_env):
        catalog, proxy, token, _, _ = proxy_env
        base = f"http://127.0.0.1:{proxy.port}/default"
        _priv(catalog, "priv")
        for url, tok, code in ((f"{base}/t/x", None, 401), (f"{base}/priv/x", token, 403),
                               (f"{base}/t/missing", token, 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _request(url, token=tok)
            assert e.value.code == code


class TestProxyRangeRequests:
    @staticmethod
    def _put_blob(proxy, token, data):
        url = f"http://127.0.0.1:{proxy.port}/default/t/blob.bin"
        _request(url, method="PUT", token=token, data=data)
        return url

    def test_range_modes(self, proxy_env):
        _, proxy, token, _, _ = proxy_env
        data = bytes(range(256)) * 40
        url = self._put_blob(proxy, token, data)
        r = _request(url, token=token, headers={"Range": "bytes=100-199"})
        assert r.status == 206 and r.headers["Content-Range"] == f"bytes 100-199/{len(data)}"
        assert r.read() == data[100:200]
        assert _request(url, token=token, headers={"Range": "bytes=10000-"}).read() == data[10000:]
        assert _request(url, token=token, headers={"Range": "bytes=-16"}).read() == data[-16:]

    def test_unsatisfiable_range_416(self, proxy_env):
        _, proxy, token, _, _ = proxy_env
        url = self._put_blob(proxy, token, b"tiny")
        with pytest.raises(urllib.error.HTTPError) as e:
            _request(url, token=token, headers={"Range": "bytes=100-200"})
        assert e.value.code == 416 and e.value.headers["Content-Range"] == "bytes */4"

    def test_head_advertises_ranges(self, proxy_env):
        _, proxy, token, _, _ = proxy_env
        resp = _request(self._put_blob(proxy, token, b"abcdef"), method="HEAD", token=token)
        assert resp.headers["Accept-Ranges"] == "bytes" and resp.headers["Content-Length"] == "6"

    def test_large_body_streams_round_trip(self, proxy_env):
        _, proxy, token, _, _ = proxy_env
        data = b"x" * (3 << 20) + b"END"
        assert _request(self._put_blob(proxy, token, data), token=token).read() == data


class TestParseRange:
    def test_parse_cases(self):
        assert parse_range(None, 100) is None
        assert parse_range("bytes=0-49", 100) == (0, 50)
        assert parse_range("bytes=50-", 100) == (50, 100)
        assert parse_range("bytes=-10", 100) == (90, 100)
        assert parse_range("bytes=90-150", 100) == (90, 100)
        for bad in ("bytes=100-", "bytes=5-2", "bytes=-0", "items=0-1", "bytes=0-1,5-6"):
            with pytest.raises(ValueError):
                parse_range(bad, 100)

    @settings(max_examples=200, deadline=None)
    @given(st.one_of(st.none(), st.text(max_size=12),
                     st.builds(lambda a, b: f"bytes={a}-{b}",
                               st.one_of(st.just(""), st.integers(0, 120).map(str)),
                               st.one_of(st.just(""), st.integers(0, 120).map(str)))),
           st.integers(1, 100))
    def test_parse_equals_the_reference(self, header, size):
        def run(fn):
            try:
                return fn(header, size)
            except ValueError as e:
                return ("ValueError", str(e))

        assert run(parse_range) == run(ref_proxy.parse_range)


class TestProxyBasicAuth:
    def test_basic_credentials_accepted(self, tmp_warehouse):
        catalog = LakeSoulCatalog(str(tmp_warehouse))
        t = catalog.create_table("pb", SCHEMA)
        t.write_arrow(pa.table({"id": [1], "v": [1.0]}))
        UserRegistry(catalog.client).register("carol", "pw9")
        proxy = StorageProxy(catalog, jwt_secret="pxy")
        proxy.start()
        try:
            rel = t.scan().scan_plan()[0].data_files[0].replace(catalog.warehouse + "/", "")
            url = f"http://127.0.0.1:{proxy.port}/{rel}"
            ok = base64.b64encode(b"carol:pw9").decode()
            assert _request(url, headers={"Authorization": f"Basic {ok}"}).read()[:4] == b"PAR1"
            bad = base64.b64encode(b"carol:nope").decode()
            with pytest.raises(urllib.error.HTTPError) as e:
                _request(url, headers={"Authorization": f"Basic {bad}"})
            assert e.value.code == 401
        finally:
            proxy.stop()


# ----------------------------------------------------------- the two packages
@pytest.fixture()
def two_proxies(tmp_path):
    """Both packages' proxies over one warehouse + SQLite store, with a
    table in the caller's domain (two committed files) and a foreign one."""
    wh, db = str(tmp_path / "wh"), str(tmp_path / "m.db")
    cat = LakeSoulCatalog(wh, db_path=db)
    t = cat.create_table("t", SCHEMA)
    t.write_arrow(pa.table({"id": np.arange(100), "v": np.arange(100) * 0.5}))
    t.write_arrow(pa.table({"id": np.arange(100, 130), "v": np.zeros(30)}))
    _priv(cat, "priv")
    proxies = {k: _proxy_of(k, wh, db) for k in ("port", "ref")}
    for p in proxies.values():
        p.start()
    token = JwtServer("pxy").create_token(Claims(sub="u", group="public"))
    files = sorted(f.replace(cat.warehouse + "/", "")
                   for u in t.scan().scan_plan() for f in u.data_files)
    yield {"proxies": proxies, "token": token, "files": files}
    for p in proxies.values():
        p.stop()


CLIENTS = {"port": ProxyStorageClient, "ref": ref_proxy.ProxyStorageClient}


def _session(client, tag):
    """One client's walk over every verb; returns what it saw."""
    seen = []
    key = f"default/t/{tag}/obj.bin"
    client.put(key, bytes(range(256)) * 9)
    seen.append(("head", client.head(key)))
    seen.append(("range", client.get(key, range_header="bytes=-100")))
    upload = client.initiate_multipart(f"default/t/{tag}/mp.bin")
    for n in (3, 1, 2):
        client.upload_part(f"default/t/{tag}/mp.bin", upload, n, bytes([n]) * (n * 1000))
    client.complete_multipart(f"default/t/{tag}/mp.bin", upload)
    seen.append(("mp", hashlib.sha256(client.get(f"default/t/{tag}/mp.bin")).hexdigest()))
    seen.append(("list", client.list_objects("default/t", prefix=f"{tag}/")))
    client.delete(key)
    client.delete(key)
    for op in (lambda: client.head(key), lambda: client.get("default/priv/x"),
               lambda: client.complete_multipart(key, "0" * 32)):
        with pytest.raises(OSError) as e:
            op()
        seen.append((type(e.value).__name__, str(e.value)))
    return seen


@pytest.mark.parametrize("client_pkg, proxy_pkg", [("ref", "port"), ("port", "ref")])
def test_clients_and_proxies_of_either_package_agree(two_proxies, client_pkg, proxy_pkg):
    loc = {k: f"http://127.0.0.1:{p.port}" for k, p in two_proxies["proxies"].items()}
    token = two_proxies["token"]
    got = _session(CLIENTS[client_pkg](loc[proxy_pkg], token=token), "a")
    want = _session(ref_proxy.ProxyStorageClient(loc["ref"], token=token), "a")
    assert got == want
    for f in two_proxies["files"]:
        assert CLIENTS[client_pkg](loc[proxy_pkg], token=token).get(f) == (
            ref_proxy.ProxyStorageClient(loc["ref"], token=token).get(f))


def _raw_script(token, files):
    f = files[0]
    return [
        ("GET", f"/{f}", token, None, {}),
        ("GET", f"/{f}", token, None, {"Range": "bytes=4-99"}),
        ("GET", f"/{f}", token, None, {"Range": "bytes=-8"}),
        ("GET", f"/{f}", token, None, {"Range": "bytes=99999999-"}),
        ("HEAD", f"/{f}", token, None, {}),
        ("GET", "/default/t?list-type=2", token, None, {}),
        ("GET", "/default/t?list-type=2&prefix=part", token, None, {}),
        ("GET", "/default/t", token, None, {}),
        ("GET", "/default/priv/x", token, None, {}),
        ("GET", "/default/t/x", None, None, {}),
        ("GET", "/default/t/x", "not-a-token", None, {}),
        ("GET", "/default", token, None, {}),
        ("GET", "/default/t/missing", token, None, {}),
        ("PUT", "/default/t/raw%20put.bin", token, b"payload", {}),
        ("GET", "/default/t/raw%20put.bin", token, None, {}),
        ("PUT", "/default/t/../priv/x", token, b"x", {}),
        ("PUT", "/default/t/x.bin?partNumber=0&uploadId=" + "a" * 32, token, b"x", {}),
        ("PUT", "/default/t/x.bin?partNumber=1&uploadId=" + "a" * 32, token, b"x", {}),
        ("POST", "/default/t/x.bin", token, b"", {}),
        ("DELETE", "/default/t/x.bin?uploadId=zz", token, None, {}),
        ("DELETE", "/default/t/raw%20put.bin", token, None, {}),
        ("DELETE", "/default/t/raw%20put.bin", token, None, {}),
        ("GET", "/default/t?list-type=2", token, None, {}),
    ]


HEADERS = ("Content-Length", "Content-Range", "Accept-Ranges", "Content-Type")


def test_raw_requests_get_the_same_answers_from_both_proxies(tmp_path):
    """Status codes, bodies (listing XML byte for byte, the error pages) and
    headers; each proxy on its own copy of one warehouse state."""
    answers = {}
    for pkg in ("ref", "port"):
        (tmp_path / pkg).mkdir()
        wh, db = str(tmp_path / pkg / "wh"), str(tmp_path / pkg / "m.db")
        cat = LakeSoulCatalog(wh, db_path=db)
        t = cat.create_table("t", SCHEMA)
        t.write_arrow(pa.table({"id": np.arange(64), "v": np.ones(64)}))
        _priv(cat, "priv")
        files = sorted(f.replace(cat.warehouse + "/", "")
                       for u in t.scan().scan_plan() for f in u.data_files)
        proxy = _proxy_of(pkg, wh, db)
        proxy.start()
        token = JwtServer("pxy").create_token(Claims(sub="u", group="public"))
        try:
            out = []
            for method, path, tok, body, hdrs in _raw_script(token, files):
                status, headers, data = _raw(proxy.port, method, path, token=tok, body=body,
                                             headers=hdrs)
                data = data.replace(os.path.basename(files[0]).encode(), b"FILE")
                out.append((method, path.replace(files[0], "FILE"), status,
                            {h: headers.get(h) for h in HEADERS}, data))
        finally:
            proxy.stop()
        answers[pkg] = out
    for got, want in zip(answers["port"], answers["ref"]):
        assert got == want, (got[:3], want[:3])
    assert len(answers["port"]) == len(answers["ref"]) == 23


# ---------------------------------------------------------------- the signers
class TestSigV4Vectors:
    def test_iam_list_users_example(self):
        headers = sigv4.sign_request(
            "GET", "iam.amazonaws.com", "/", "Action=ListUsers&Version=2010-05-08",
            {"content-type": "application/x-www-form-urlencoded; charset=utf-8"},
            sigv4.EMPTY_SHA256, access_key=AK, secret_key=SK, region="us-east-1",
            service="iam", timestamp=datetime.datetime(2015, 8, 30, 12, 36, 0))
        assert headers["Authorization"] == (
            "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20150830/us-east-1/iam/"
            "aws4_request, SignedHeaders=content-type;host;x-amz-date, Signature="
            "5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400e06b5924a6f2b5d7")

    def test_s3_get_object_example(self):
        headers = sigv4.sign_request(
            "GET", "examplebucket.s3.amazonaws.com", "/test.txt", "", {"range": "bytes=0-9"},
            sigv4.EMPTY_SHA256, access_key=AK,
            secret_key="wJalrXUtnFEMI/K7MDENG/bPxRfiCYEXAMPLEKEY", region="us-east-1",
            service="s3", timestamp=datetime.datetime(2013, 5, 24, 0, 0, 0))
        assert headers["Authorization"].endswith(
            "Signature=f0e8bdb87c964420e857bd35b5d6ed310bd44f0170aba48dd91039c6036bdb41")

    def test_verify_roundtrip_and_tamper(self):
        headers = sigv4.sign_request("PUT", "s3.local:9000", "/bkt/a/b.parquet", "", {},
                                     hashlib.sha256(b"xyz").hexdigest(), access_key="AK1",
                                     secret_key="shh", region="eu-west-1")
        keys = {"AK1": "shh"}
        assert sigv4.verify_signature("PUT", "/bkt/a/b.parquet", "", headers, secret_keys=keys)
        assert not sigv4.verify_signature("PUT", "/bkt/a/OTHER", "", headers, secret_keys=keys)
        assert not sigv4.verify_signature("PUT", "/bkt/a/b.parquet", "", headers,
                                          secret_keys={"AK1": "wrong"})


_SEG = st.text(st.characters(codec="utf-8", exclude_characters="/\x00"), min_size=1,
               max_size=8)
_QTEXT = st.text(st.characters(codec="utf-8", exclude_characters="&=\x00"), max_size=6)


@settings(max_examples=150, deadline=None)
@given(method=st.sampled_from(["GET", "PUT", "HEAD", "DELETE", "POST"]),
       host=st.sampled_from(["s3.internal:9000", "bucket.s3.amazonaws.com", "10.0.0.7"]),
       segs=st.lists(_SEG, min_size=1, max_size=4),
       query=st.lists(st.tuples(_QTEXT, _QTEXT), max_size=4),
       headers=st.dictionaries(st.sampled_from(["range", "content-type", "x-amz-meta-a",
                                                "Content-MD5"]),
                               st.text(st.characters(codec="ascii", min_codepoint=32,
                                                     max_codepoint=126), max_size=12),
                               max_size=3),
       body=st.binary(max_size=64), token=st.one_of(st.none(), st.text("abc", min_size=1)),
       seconds=st.integers(0, 2_000_000_000))
def test_sigv4_equals_the_reference_on_drawn_requests(method, host, segs, query, headers,
                                                       body, token, seconds):
    path = sigv4.encode_path("/" + "/".join(segs))
    assert path == ref_sigv4.encode_path("/" + "/".join(segs))
    q = "&".join(f"{urllib.parse.quote(k)}={urllib.parse.quote(v)}" for k, v in query)
    assert sigv4.canonical_query(q) == ref_sigv4.canonical_query(q)
    kw = dict(access_key=AK, secret_key=SK, region="eu-west-1", session_token=token,
              timestamp=datetime.datetime.fromtimestamp(seconds, datetime.timezone.utc))
    payload = hashlib.sha256(body).hexdigest()
    got = sigv4.sign_request(method, host, path, q, headers, payload, **kw)
    assert got == ref_sigv4.sign_request(method, host, path, q, headers, payload, **kw)
    for mod in (sigv4, ref_sigv4):  # each package verifies the other's signature
        assert mod.verify_signature(method, path, q, got, secret_keys={AK: SK})


@settings(max_examples=150, deadline=None)
@given(method=st.sampled_from(["GET", "PUT", "HEAD", "DELETE"]),
       segs=st.lists(_SEG, min_size=1, max_size=3),
       query=st.dictionaries(st.sampled_from(["comp", "restype", "blockid", "prefix",
                                              "marker", "maxresults", "Delimiter"]),
                             st.text(max_size=6), max_size=4),
       headers=st.dictionaries(st.sampled_from(["Content-Length", "Content-Type", "Range",
                                                "x-ms-date", "x-ms-version",
                                                "x-ms-blob-type", "If-Match", "Date"]),
                               st.text(st.characters(codec="ascii", min_codepoint=32,
                                                     max_codepoint=126), max_size=12),
                               max_size=5))
def test_azure_signer_equals_the_reference_on_drawn_requests(method, segs, query, headers):
    path = azure.encode_blob_path("/lake/" + "/".join(segs))
    assert path == ref_azure.encode_blob_path("/lake/" + "/".join(segs))
    assert string_to_sign(method, ACCOUNT, path, query, headers) == ref_azure.string_to_sign(
        method, ACCOUNT, path, query, headers)
    assert sign_shared_key(method, ACCOUNT, KEY, path, query, headers) == (
        ref_azure.sign_shared_key(method, ACCOUNT, KEY, path, query, headers))


# ----------------------------------------------------- DNS discovery, S3 fake
class TestDnsDiscovery:
    def test_health_filter_and_round_robin(self):
        d = DnsDiscovery("svc.local", 9000, resolver=lambda h, p: ["10.0.0.1", "10.0.0.2",
                                                                   "10.0.0.3"],
                         health_check=lambda ip, p: ip != "10.0.0.2")
        assert d.backends() == ["10.0.0.1", "10.0.0.3"]
        assert {d.pick() for _ in range(4)} == {"10.0.0.1", "10.0.0.3"}

    def test_failure_markdown_and_recovery(self):
        now = [0.0]
        d = DnsDiscovery("svc.local", 9000, resolver=lambda h, p: ["a", "b"],
                         health_check=lambda ip, p: True, retry_down_s=10.0,
                         clock=lambda: now[0])
        d.report_failure("a")
        assert {d.pick() for _ in range(3)} == {"b"}
        now[0] = 11.0
        assert {d.pick() for _ in range(4)} == {"a", "b"}

    def test_all_down_fails_open(self):
        d = DnsDiscovery("svc.local", 9000, resolver=lambda h, p: ["a", "b"],
                         health_check=lambda ip, p: True)
        d.report_failure("a")
        d.report_failure("b")
        assert d.pick() in ("a", "b")

    def test_refresh_interval_and_dns_change(self):
        now = [0.0]
        d = DnsDiscovery("svc.local", 9000,
                         resolver=lambda h, p: [["a"], ["c", "d"]][0 if now[0] < 30 else 1],
                         health_check=lambda ip, p: True, refresh_interval_s=30.0,
                         clock=lambda: now[0])
        assert d.backends() == ["a"]
        now[0] = 5.0
        assert d.backends() == ["a"]
        now[0] = 31.0
        assert d.backends() == ["c", "d"]


class FakeS3:
    """A minimal S3 endpoint that verifies every request's SigV4 signature
    with the given package's ``sigv4``."""

    def __init__(self, verifier=sigv4):
        self.objects: dict[str, bytes] = {}
        self.bad_auth = 0
        store = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _check(self) -> bool:
                path, _, query = self.path.partition("?")
                if not verifier.verify_signature(self.command, path, query, dict(self.headers),
                                                 secret_keys={AK: SK}):
                    store.bad_auth += 1
                    self.send_error(403, "SignatureDoesNotMatch")
                    return False
                return True

            def do_PUT(self):
                if self._check():
                    store.objects[self.path] = self.rfile.read(
                        int(self.headers.get("Content-Length", 0)))
                    self.send_response(200)
                    self.send_header("ETag", '"fake"')
                    self.send_header("Content-Length", "0")
                    self.end_headers()

            def _object(self):
                body = store.objects.get(self.path)
                if body is None:
                    self.send_error(404, "NoSuchKey")
                return body

            def do_GET(self):
                if not self._check() or (body := self._object()) is None:
                    return
                rng = self.headers.get("Range")
                if rng and rng.startswith("bytes="):
                    lo_s, _, hi_s = rng[6:].partition("-")
                    lo, hi = int(lo_s), int(hi_s) + 1 if hi_s else len(body)
                    self.send_response(206)
                    self.send_header("Content-Range", f"bytes {lo}-{hi - 1}/{len(body)}")
                    body = body[lo:hi]
                else:
                    self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_HEAD(self):
                if self._check() and (body := self._object()) is not None:
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture(params=["port", "ref"])
def fake_s3(request):
    """A fake S3 verifying with either package's signer."""
    s = FakeS3(SIGV4[request.param])
    yield s
    s.stop()


def _s3_upstream(fake, resolver=None) -> S3Upstream:
    cfg = S3UpstreamConfig(endpoint=f"http://s3.internal:{fake.port}", bucket="lake",
                           access_key=AK, secret_key=SK, connect_timeout_s=2.0)
    return S3Upstream(cfg, resolver=resolver or (lambda h, p: ["127.0.0.1"]),
                      health_check=lambda ip, p: True)


def _read(resp) -> bytes:
    try:
        return resp.read()
    finally:
        resp.close()


class TestS3Upstream:
    def test_put_get_head_signed(self, fake_s3):
        up = _s3_upstream(fake_s3)
        status, _, resp = up.request("PUT", "ns/t/file.bin", body=b"payload-123")
        _read(resp)
        assert status == 200 and fake_s3.objects["/lake/ns/t/file.bin"] == b"payload-123"
        status, _, resp = up.request("GET", "ns/t/file.bin")
        assert status == 200 and _read(resp) == b"payload-123"
        status, _, resp = up.request("GET", "ns/t/file.bin", range_header="bytes=2-4")
        assert status == 206 and _read(resp) == b"ylo"
        assert fake_s3.bad_auth == 0

    def test_failover_to_live_backend(self, fake_s3):
        up = _s3_upstream(fake_s3, resolver=lambda h, p: ["127.0.0.2", "127.0.0.1"])
        for _ in range(4):
            status, _, resp = up.request("PUT", "k", body=b"x", retries=2)
            _read(resp)
            assert status == 200
        assert "127.0.0.2" in up.discovery._down_until


class TestProxyUpstreamE2E:
    """Client → RBAC/JWT proxy → SigV4-signed upstream → fake S3."""

    @pytest.fixture()
    def env(self, tmp_warehouse, fake_s3):
        catalog = LakeSoulCatalog(str(tmp_warehouse))
        catalog.create_table("t", SCHEMA)
        proxy = StorageProxy(catalog, jwt_secret="pxy", upstream=_s3_upstream(fake_s3))
        proxy.start()
        yield proxy, proxy.jwt_server.create_token(Claims(sub="u", group="public")), fake_s3
        proxy.stop()

    def test_put_get_range_head_via_proxy(self, env):
        proxy, token, fake = env
        url = f"http://127.0.0.1:{proxy.port}/default/t/part-1.lsf"
        body = bytes(range(256)) * 4
        assert _request(url, method="PUT", token=token, data=body).status == 200
        assert fake.objects["/lake/default/t/part-1.lsf"] == body and fake.bad_auth == 0
        assert _request(url, token=token).read() == body
        r = _request(url, token=token, headers={"Range": "bytes=10-19"})
        assert r.status == 206 and r.read() == body[10:20]
        assert int(_request(url, method="HEAD", token=token).headers["Content-Length"]) == len(
            body)

    def test_escaped_key_signed_consistently(self, env):
        proxy, token, fake = env
        url = f"http://127.0.0.1:{proxy.port}/default/t/part%20a%2Bb.lsf"
        assert _request(url, method="PUT", token=token, data=b"spaced-key-bytes").status == 200
        assert fake.bad_auth == 0
        assert [k for k in fake.objects if "part" in k] == ["/lake/default/t/part%20a%2Bb.lsf"]
        assert _request(url, token=token).read() == b"spaced-key-bytes"

    def test_rbac_still_enforced_before_upstream(self, env):
        proxy, _, _ = env
        with pytest.raises(urllib.error.HTTPError) as e:
            _request(f"http://127.0.0.1:{proxy.port}/default/t/x.bin")
        assert e.value.code == 401

    def test_missing_object_404(self, env):
        proxy, token, _ = env
        with pytest.raises(urllib.error.HTTPError) as e:
            _request(f"http://127.0.0.1:{proxy.port}/default/t/ghost", token=token)
        assert e.value.code == 404


# --------------------------------------------------------------- Azure fake
class FakeAzureBlob:
    """Blob-service fake: Shared Key verified (path AND query canonicalized,
    by the given package's ``string_to_sign``), whole blobs, Put Block /
    Put Block List, List Blobs with prefix/marker/maxresults paging."""

    def __init__(self, *, max_results_cap: int = 2, signer=azure, account=ACCOUNT, key=KEY):
        store: dict[str, bytes] = {}
        uncommitted: dict[tuple[str, str], bytes] = {}
        block_puts: list[tuple[str, str]] = []
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _split(self):
                url = urllib.parse.urlsplit(self.path)
                q = {k: (v[0] if v else "") for k, v in urllib.parse.parse_qs(
                    url.query, keep_blank_values=True).items()}
                return urllib.parse.unquote(url.path), q

            def _check(self, path, q) -> bool:
                if self.headers.get("x-ms-version") != API_VERSION:
                    self.send_error(400, "missing x-ms-version")
                    return False
                if "x-ms-date" not in self.headers:
                    self.send_error(400, "missing x-ms-date")
                    return False
                auth = self.headers.get("Authorization", "")
                if not auth.startswith(f"SharedKey {account}:"):
                    self.send_error(403, "no shared key")
                    return False
                sts = signer.string_to_sign(self.command, account, path, q, dict(self.headers))
                want = base64.b64encode(hmac.new(base64.b64decode(key), sts.encode(),
                                                 hashlib.sha256).digest()).decode()
                if not hmac.compare_digest(auth.split(":", 1)[1], want):
                    self.send_error(403, "signature mismatch")
                    return False
                return True

            def _reply(self, status, body=b"", headers=()):
                self.send_response(status)
                for h in headers:
                    self.send_header(*h)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_PUT(self):
                path, q = self._split()
                if not self._check(path, q):
                    return
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if q.get("comp") == "block":
                    uncommitted[(path, q.get("blockid", ""))] = body
                    block_puts.append((path, q.get("blockid", "")))
                elif q.get("comp") == "blocklist":
                    pieces = []
                    for el in ET.fromstring(body).iter():
                        if el.tag == "Latest":
                            blk = uncommitted.get((path, el.text or ""))
                            if blk is None:
                                self.send_error(400, "unknown block id")
                                return
                            pieces.append(blk)
                    store[path] = b"".join(pieces)
                elif self.headers.get("x-ms-blob-type") != "BlockBlob":
                    self.send_error(400, "missing x-ms-blob-type")
                    return
                else:
                    store[path] = body
                self._reply(201)

            def _do_list(self, q):
                prefix, marker = q.get("prefix", ""), q.get("marker", "")
                cap = min(int(q.get("maxresults", fake.max_results_cap)), fake.max_results_cap)
                root = f"/{CONTAINER}/"
                names = sorted(p[len(root):] for p in store if p.startswith(root))
                names = [n for n in names if n.startswith(prefix) and (not marker or n >= marker)]
                delim = q.get("delimiter", "")
                entries, groups = [], set()
                for n in names:
                    cut = n[len(prefix):].find(delim) if delim else -1
                    if delim and cut >= 0:
                        group = n[: len(prefix) + cut + len(delim)]
                        if group not in groups:
                            groups.add(group)
                            entries.append((group, f"<BlobPrefix><Name>{xml_escape(group)}"
                                                   "</Name></BlobPrefix>"))
                    else:
                        entries.append((n, f"<Blob><Name>{xml_escape(n)}</Name><Properties>"
                                           f"<Content-Length>{len(store[root + n])}"
                                           "</Content-Length></Properties></Blob>"))
                page, rest = entries[:cap], entries[cap:]
                nxt = (f"<NextMarker>{xml_escape(rest[0][0])}</NextMarker>" if rest
                       else "<NextMarker/>")
                self._reply(200, (
                    '<?xml version="1.0" encoding="utf-8"?>'
                    f'<EnumerationResults ContainerName="{CONTAINER}">'
                    f"<Prefix>{xml_escape(prefix)}</Prefix><Blobs>"
                    + "".join(x for _, x in page) + f"</Blobs>{nxt}</EnumerationResults>"
                ).encode())

            def do_GET(self):
                path, q = self._split()
                if not self._check(path, q):
                    return
                if q.get("comp") == "list":
                    return self._do_list(q)
                blob = store.get(path)
                if blob is None:
                    return self.send_error(404)
                rng = self.headers.get("Range")
                if rng and rng.startswith("bytes="):
                    a, _, b = rng[6:].partition("-")
                    start, end = int(a), int(b) + 1 if b else len(blob)
                    self._reply(206, blob[start:end],
                                [("Content-Range", f"bytes {start}-{end - 1}/{len(blob)}")])
                else:
                    self._reply(200, blob)

            def do_HEAD(self):
                path, q = self._split()
                if not self._check(path, q):
                    return
                blob = store.get(path)
                if blob is None:
                    return self.send_error(404)
                self.send_response(200)
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()

            def do_DELETE(self):
                path, q = self._split()
                if not self._check(path, q):
                    return
                if store.pop(path, None) is None:
                    return self.send_error(404)
                self._reply(202)

        self.max_results_cap = max_results_cap
        self.store, self.uncommitted, self.block_puts = store, uncommitted, block_puts
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    @property
    def port(self):
        return self.server.server_address[1]

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture()
def blob():
    s = FakeAzureBlob()
    yield s
    s.stop()


def _az(port, key=KEY) -> AzureUpstream:
    cfg = AzureUpstreamConfig(account=ACCOUNT, key_b64=key, container=CONTAINER,
                              endpoint=f"http://127.0.0.1:{port}")
    return AzureUpstream(cfg, resolver=lambda h, p: ["127.0.0.1"],
                         health_check=lambda ip, p: True)


S3NS = {"s3": "http://s3.amazonaws.com/doc/2006-03-01/"}


class TestAzureSharedKey:
    def test_string_to_sign_shape(self):
        sts = string_to_sign("GET", ACCOUNT, "/lake/a b.parquet", {"comp": "list"}, {
            "x-ms-date": "Mon, 27 Jul 2026 10:00:00 GMT", "x-ms-version": API_VERSION,
            "Content-Length": "0", "Range": "bytes=0-9"})
        lines = sts.split("\n")
        assert lines[0] == "GET" and lines[3] == "" and lines[6] == ""
        assert lines[11] == "bytes=0-9"
        assert "x-ms-date:Mon, 27 Jul 2026 10:00:00 GMT" in sts
        assert sts.endswith(f"/{ACCOUNT}/lake/a b.parquet\ncomp:list")

    def test_signature_is_deterministic_and_keyed(self):
        h = {"x-ms-date": "Mon, 27 Jul 2026 10:00:00 GMT", "x-ms-version": API_VERSION}
        s1 = sign_shared_key("GET", ACCOUNT, KEY, "/lake/x", {}, h)
        assert s1 == sign_shared_key("GET", ACCOUNT, KEY, "/lake/x", {}, h)
        assert s1.startswith(f"SharedKey {ACCOUNT}:")
        assert sign_shared_key("GET", ACCOUNT, base64.b64encode(b"another-key").decode(),
                               "/lake/x", {}, h) != s1

    @pytest.mark.parametrize("verifier", ["port", "ref"])
    def test_put_get_head_range_verified(self, verifier):
        fake = FakeAzureBlob(signer={"port": azure, "ref": ref_azure}[verifier])
        try:
            up = _az(fake.port)
            body = b"0123456789abcdef" * 100
            status, _, resp = up.request("PUT", "wh/t/part-x_0000.parquet", body=body)
            _read(resp)
            assert status == 201
            status, _, resp = up.request("GET", "wh/t/part-x_0000.parquet")
            assert status == 200 and _read(resp) == body
            status, _, resp = up.request("GET", "wh/t/part-x_0000.parquet",
                                         range_header="bytes=16-31")
            assert status == 206 and _read(resp) == b"0123456789abcdef"
            status, headers, resp = up.request("HEAD", "wh/t/part-x_0000.parquet")
            _read(resp)
            assert status == 200 and headers["Content-Length"] == str(len(body))
        finally:
            fake.stop()

    def test_tampered_key_rejected(self, blob):
        status, _, resp = _az(blob.port, base64.b64encode(b"wrong-key").decode()).request(
            "GET", "wh/x")
        _read(resp)
        assert status == 403

    def test_streamed_put_through_proxy(self, blob, tmp_path):
        cat = LakeSoulCatalog(str(tmp_path / "wh"), db_path=str(tmp_path / "m.db"))
        cat.create_table("az", SCHEMA)
        proxy = StorageProxy(cat, upstream=_az(blob.port))
        proxy.start()
        try:
            url = f"http://127.0.0.1:{proxy.port}/default/az/f.bin"
            body = b"zz" * 4096
            assert _request(url, method="PUT", data=body).status == 201
            assert _request(url).read() == body
            assert _request(url, headers={"Range": "bytes=0-1"}).read() == b"zz"
        finally:
            proxy.stop()


class TestPlainVerbDialect:
    def test_delete_is_idempotent_like_s3(self, blob):
        up = _az(blob.port)
        _read(up.request("PUT", "wh/t/gone.bin", body=b"x")[2])
        for _ in range(2):
            status, headers, resp = up.request("DELETE", "wh/t/gone.bin")
            assert status == 204 and _read(resp) == b"" and headers.get("Content-Length") == "0"


class TestListTranslation:
    def test_list_pages_through_continuation_markers(self, blob):
        up = _az(blob.port)
        for name, size in (("wh/t/a.parquet", 3), ("wh/t/b.parquet", 5),
                           ("wh/t/sub/c.parquet", 7), ("other/x", 1)):
            status, _, resp = up.request("PUT", name, body=b"z" * size)
            _read(resp)
            assert status == 201
        keys, token, pages = [], None, 0
        while True:
            q = "list-type=2&prefix=" + urllib.parse.quote("wh/t/", safe="")
            if token:
                q += "&continuation-token=" + urllib.parse.quote(token, safe="")
            status, _, resp = up.request("GET", "", query=q)
            root = ET.fromstring(_read(resp))
            assert status == 200
            pages += 1
            keys += [(c.findtext("s3:Key", "", S3NS), int(c.findtext("s3:Size", "0", S3NS)))
                     for c in root.findall("s3:Contents", S3NS)]
            token = root.findtext("s3:NextContinuationToken", None, S3NS)
            if root.findtext("s3:IsTruncated", "false", S3NS) != "true":
                break
        assert pages >= 2
        assert keys == [("wh/t/a.parquet", 3), ("wh/t/b.parquet", 5), ("wh/t/sub/c.parquet", 7)]

    def test_keycount_includes_common_prefixes(self, blob):
        up = _az(blob.port)
        for name in ("wh/t/sub/c.parquet", "wh/t/sub2/d.parquet"):
            _read(up.request("PUT", name, body=b"z")[2])
        q = "list-type=2&prefix=" + urllib.parse.quote("wh/t/", safe="") + "&delimiter=%2F"
        status, _, resp = up.request("GET", "", query=q)
        root = ET.fromstring(_read(resp))
        assert status == 200
        prefixes = [p.findtext("s3:Prefix", "", S3NS)
                    for p in root.findall("s3:CommonPrefixes", S3NS)]
        assert prefixes == ["wh/t/sub/", "wh/t/sub2/"]
        assert int(root.findtext("s3:KeyCount", "-1", S3NS)) == (
            len(root.findall("s3:Contents", S3NS)) + len(prefixes))

    def test_unsupported_query_still_explicit_501_shape(self, blob):
        up = _az(blob.port)
        for method, query in (("POST", "delete"), ("GET", "list-type=2&start-after=x")):
            with pytest.raises(NotImplementedError):
                up.request(method, "", query=query)


class TestMultipartTranslation:
    @staticmethod
    def _initiate(up, key) -> str:
        status, _, resp = up.request("POST", key, query="uploads", body=b"")
        upload_id = ET.fromstring(_read(resp)).findtext("UploadId")
        assert status == 200 and upload_id
        return upload_id

    @staticmethod
    def _part(up, key, upload_id, n, data):
        status, headers, resp = up.request("PUT", key, body=data,
                                           query=f"partNumber={n}&uploadId={upload_id}")
        _read(resp)
        return status, headers

    @staticmethod
    def _complete(up, key, upload_id, parts=None):
        body = None if parts is None else (
            "<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber></Part>" for n in parts)
            + "</CompleteMultipartUpload>").encode()
        status, _, resp = up.request("POST", key, query=f"uploadId={upload_id}", body=body)
        return status, _read(resp)

    def test_three_part_upload_assembles_via_block_list(self, blob):
        up = _az(blob.port)
        key = "wh/t/big.parquet"
        upload_id = self._initiate(up, key)
        parts = [b"a" * 100, b"b" * 50, b"c" * 7]
        for i, p in enumerate(parts, start=1):
            status, headers = self._part(up, key, upload_id, i, p)
            assert status == 200 and "ETag" in headers
        status, data = self._complete(up, key, upload_id)
        assert status == 200 and b"CompleteMultipartUploadResult" in data
        assert len(blob.block_puts) == 3
        assert blob.store[f"/{CONTAINER}/{key}"] == b"".join(parts)
        status, _, resp = up.request("GET", key)
        assert status == 200 and _read(resp) == b"".join(parts)

    def test_manifest_selects_parts(self, blob):
        up = _az(blob.port)
        key = "wh/t/sel.bin"
        upload_id = self._initiate(up, key)
        for i in range(1, 5):
            self._part(up, key, upload_id, i, bytes([i]) * 4)
        assert self._complete(up, key, upload_id, [2, 4])[0] == 200
        assert blob.store[f"/{CONTAINER}/{key}"] == bytes([2]) * 4 + bytes([4]) * 4

    def test_out_of_order_or_duplicate_manifest_rejected(self, blob):
        up = _az(blob.port)
        key = "wh/t/ord.bin"
        upload_id = self._initiate(up, key)
        for i in (1, 2):
            self._part(up, key, upload_id, i, bytes([i]) * 4)
        for bad in ([2, 1], [1, 1]):
            status, data = self._complete(up, key, upload_id, bad)
            assert status == 400 and b"InvalidPartOrder" in data
        assert f"/{CONTAINER}/{key}" not in blob.store

    def test_get_uploads_does_not_mint_an_upload(self, blob):
        with pytest.raises(NotImplementedError):
            _az(blob.port).request("GET", "", query="uploads")

    def test_part_read_does_not_clobber_upload_state(self, blob):
        up = _az(blob.port)
        key = "wh/t/pr.bin"
        upload_id = self._initiate(up, key)
        self._part(up, key, upload_id, 2, b"p" * 8)
        with pytest.raises(NotImplementedError):
            up.request("GET", key, query=f"partNumber=2&uploadId={upload_id}")
        assert self._complete(up, key, upload_id, [2])[0] == 200
        assert blob.store[f"/{CONTAINER}/{key}"] == b"p" * 8

    def test_unknown_upload_and_missing_part_rejected(self, blob):
        up = _az(blob.port)
        assert self._part(up, "wh/t/x", "f" * 32, 1, b"z")[0] == 404
        key = "wh/t/y"
        assert self._complete(up, key, self._initiate(up, key), [9])[0] == 400

    def test_abort_tombstones_the_upload(self, blob):
        up = _az(blob.port)
        key = "wh/t/ab.bin"
        upload_id = self._initiate(up, key)
        self._part(up, key, upload_id, 1, b"q" * 8)
        status, _, resp = up.request("DELETE", key, query=f"uploadId={upload_id}")
        _read(resp)
        assert status == 204
        assert self._complete(up, key, upload_id)[0] == 404
        assert f"/{CONTAINER}/{key}" not in blob.store
        status, _, resp = up.request("DELETE", key, query=f"uploadId={upload_id}")
        _read(resp)
        assert status == 404

    def test_abort_unknown_upload_rejected(self, blob):
        status, _, resp = _az(blob.port).request("DELETE", "wh/t/none.bin",
                                                 query="uploadId=deadbeef")
        assert status == 404 and b"NoSuchUpload" in _read(resp)


class TestUnchangedClientContractRoundTrip:
    """Either package's ``ProxyStorageClient`` drives listing and a 3-part
    multipart upload through the port's proxy to the Azure fake."""

    @pytest.fixture(params=["port", "ref"])
    def env(self, request, tmp_path, blob):
        cat = LakeSoulCatalog(str(tmp_path / "wh"), db_path=str(tmp_path / "m.db"))
        cat.create_table("az", SCHEMA)
        proxy = StorageProxy(cat, upstream=_az(blob.port))
        proxy.start()
        yield CLIENTS[request.param](f"http://127.0.0.1:{proxy.port}")
        proxy.stop()

    def test_multipart_and_list_through_proxy(self, env):
        parts = [b"p1" * 64, b"p2" * 32, b"p3" * 16]
        upload_id = env.initiate_multipart("default/az/data.bin")
        for i, p in enumerate(parts, start=1):
            env.upload_part("default/az/data.bin", upload_id, i, p)
        env.complete_multipart("default/az/data.bin", upload_id)
        assert env.get("default/az/data.bin") == b"".join(parts)
        env.put("default/az/extra1.bin", b"x" * 9)
        env.put("default/az/extra2.bin", b"y" * 11)
        assert env.list_objects("default/az") == [
            ("default/az/data.bin", len(b"".join(parts))), ("default/az/extra1.bin", 9),
            ("default/az/extra2.bin", 11)]
        env.delete("default/az/extra2.bin")
        assert [k for k, _ in env.list_objects("default/az")] == [
            "default/az/data.bin", "default/az/extra1.bin"]

    def test_abort_via_client(self, env):
        upload_id = env.initiate_multipart("default/az/gone.bin")
        env.upload_part("default/az/gone.bin", upload_id, 1, b"zz")
        env.abort_multipart("default/az/gone.bin", upload_id)
        with pytest.raises(OSError):
            env.complete_multipart("default/az/gone.bin", upload_id)


# ------------------------------------------------------------- the deployable
def test_storage_proxy_cli(tmp_path):
    """``--port 0`` prints the bound port; the S3 upstream comes from the
    ``LAKESOUL_PROXY_S3_*`` environment; SIGINT stops it with exit 0."""
    wh = tmp_path / "wh"
    t = LakeSoulCatalog(str(wh)).create_table("t", pa.schema([("a", pa.int64())]))
    t.write_arrow(pa.table({"a": [1, 2, 3]}))
    data_file = next(f for f in os.listdir(wh / "default" / "t") if not f.startswith("."))
    fake = FakeS3()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("LAKESOUL_", "JAX_"))}
    env["PYTHONPATH"] = ROOT
    procs = []
    try:
        for extra in ({}, {"LAKESOUL_PROXY_S3_ENDPOINT": f"http://127.0.0.1:{fake.port}",
                           "LAKESOUL_PROXY_S3_BUCKET": "lake",
                           "LAKESOUL_PROXY_S3_ACCESS_KEY": AK,
                           "LAKESOUL_PROXY_S3_SECRET_KEY": SK}):
            proc = subprocess.Popen(
                [sys.executable, "-m", "lakesoul_tpu_torch.service.storage_proxy",
                 "--warehouse", str(wh), "--host", "127.0.0.1", "--port", "0"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env={**env, **extra})
            procs.append(proc)
            line = proc.stdout.readline()
            head = "storage proxy on http://127.0.0.1:"
            assert line.startswith(head), line
            port = int(line[len(head):].split()[0])
            base = f"http://127.0.0.1:{port}/default/t"
            if not extra:
                assert "(direct, auth=open)" in line
                assert urllib.request.urlopen(f"{base}/{data_file}").status == 200
                req = urllib.request.Request(f"{base}/{data_file}",
                                             headers={"Range": "bytes=0-3"})
                assert urllib.request.urlopen(req).read() == b"PAR1"
            else:
                assert "(s3-upstream, auth=open)" in line
                _request(f"{base}/up.bin", method="PUT", data=b"0123456789")
                req = urllib.request.Request(f"{base}/up.bin", headers={"Range": "bytes=2-5"})
                assert urllib.request.urlopen(req).read() == b"2345"
                assert fake.objects["/lake/default/t/up.bin"] == b"0123456789"
                assert fake.bad_auth == 0
            proc.send_signal(signal.SIGINT)
            assert proc.wait(timeout=20) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        fake.stop()


def test_the_proxy_module_keeps_the_references_environment():
    import inspect

    src, ref_src = inspect.getsource(storage_proxy.main), inspect.getsource(ref_proxy.main)
    names = sorted(set(n for n in ref_src.split('"') if n.startswith("LAKESOUL_")))
    assert len(names) >= 9 and all(f'"{n}"' in src for n in names), names
