"""Azure Blob Storage upstream for the RBAC storage proxy (the port's copy of
``lakesoul_tpu/service/azure.py``).

Role parity with rust/lakesoul-s3-proxy/src/azure.rs: the proxy terminates
client auth (JWT + RBAC) and forwards object operations to Azure Blob
Storage signed with the account's **Shared Key** (hmac-sha256 over Azure's
canonicalized string-to-sign; azure.rs `sign` / `add_required_headers`).

Like the reference's azure.rs, this upstream is an S3-API→Azure
**dialect translator**: the proxy's clients speak one S3-shaped contract
(GET/PUT/HEAD/DELETE objects, ListObjectsV2, multipart uploads —
storage_proxy.py) and this module rewrites the S3-dialect query operations
into their Blob-service equivalents so the SAME client operates against
either cloud and the proxy's per-backend circuit breakers can actually
fail over between them:

- ``list-type=2`` (ListObjectsV2) → List Blobs
  (``?restype=container&comp=list``), with the S3 ``continuation-token``
  mapped onto Azure's ``marker``/``NextMarker`` paging and the Azure
  enumeration XML rewritten into ``ListBucketResult``.
- multipart upload → Put Block / Put Block List: ``?uploads`` mints a
  local uploadId (Azure has no initiate call), each
  ``partNumber=N&uploadId=U`` part becomes a Put Block whose block id is
  derived from (uploadId, partNumber) — fixed-width, as Azure requires
  block ids of one blob to share a length — and CompleteMultipartUpload
  becomes a Put Block List assembled from the uploadId↔block-id
  bookkeeping (manifest-selected parts honored, S3 semantics).  Abort
  drops the bookkeeping; Azure garbage-collects uncommitted blocks.

Whole-object GET/PUT/HEAD/DELETE, required x-ms headers, shared-key
canonicalization/signing (query parameters ride the canonicalized
resource), Range pass-through, and DNS-discovered health-checked backends
complete the same duck-typed request interface as ``S3Upstream``
(``StorageProxy`` is upstream-agnostic).  S3 query shapes with no Blob
equivalent (``start-after``, batch delete) still answer 501 explicitly.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import http.client
import io
import logging
import threading
import time
import uuid
from dataclasses import dataclass
from urllib.parse import parse_qs, quote
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape as xml_escape

from lakesoul_tpu_torch.runtime.resilience import RetryPolicy
from lakesoul_tpu_torch.service.s3_upstream import DnsDiscovery, connect_backend

logger = logging.getLogger(__name__)

API_VERSION = "2021-08-06"

# headers that take part in the fixed section of the string-to-sign, in
# Azure's mandated order
_SIGNED_STD_HEADERS = (
    "content-encoding",
    "content-language",
    "content-length",
    "content-md5",
    "content-type",
    "date",
    "if-modified-since",
    "if-match",
    "if-none-match",
    "if-unmodified-since",
    "range",
)


def rfc1123_now() -> str:
    # locale-independent HTTP-date: strftime('%a/%b') would localize day and
    # month names under a non-English LC_TIME, and Azure rejects those
    from email.utils import formatdate

    return formatdate(usegmt=True)


def string_to_sign(
    method: str,
    account: str,
    path: str,
    query: dict[str, str],
    headers: dict[str, str],
) -> str:
    """Azure Shared Key canonicalization (the 2015-02-21+ rules: a zero
    Content-Length signs as the empty string; Date is empty when x-ms-date
    is supplied; x-ms-* headers sorted lowercase; the canonicalized
    resource is /account/path plus sorted ``name:value`` query lines)."""
    low = {k.lower(): v.strip() for k, v in headers.items()}
    if "x-ms-date" in low:
        low["date"] = ""
    if low.get("content-length") in ("0", ""):
        low["content-length"] = ""
    fixed = [method.upper()]
    fixed += [low.get(h, "") for h in _SIGNED_STD_HEADERS]
    canon_headers = "".join(
        f"{k}:{low[k]}\n" for k in sorted(k for k in low if k.startswith("x-ms-"))
    )
    canon_resource = f"/{account}{path}"
    for k in sorted(query):
        canon_resource += f"\n{k.lower()}:{query[k]}"
    return "\n".join(fixed) + "\n" + canon_headers + canon_resource


def sign_shared_key(
    method: str,
    account: str,
    key_b64: str,
    path: str,
    query: dict[str, str],
    headers: dict[str, str],
) -> str:
    """→ value for the Authorization header."""
    sts = string_to_sign(method, account, path, query, headers)
    mac = hmac.new(
        base64.b64decode(key_b64), sts.encode("utf-8"), hashlib.sha256
    ).digest()
    return f"SharedKey {account}:{base64.b64encode(mac).decode()}"


def encode_blob_path(path: str) -> str:
    return quote(path, safe="/-_.~!$&'()*+,;=:@")


@dataclass
class AzureUpstreamConfig:
    account: str
    key_b64: str  # the base64 account key, as the portal hands it out
    container: str
    endpoint: str | None = None  # default https://{account}.blob.core.windows.net
    port: int | None = None
    connect_timeout_s: float = 3.0
    refresh_interval_s: float = 30.0
    # None = shared resilience default (LAKESOUL_RETRY_DOWN_S, 10 s)
    retry_down_s: float | None = None


class _SyntheticResponse:
    """Locally-built response body with the streaming surface the proxy
    relay expects (``read(n)``/``close``) — used for translated operations
    whose answer is composed here rather than forwarded verbatim."""

    def __init__(self, data: bytes):
        self._buf = io.BytesIO(data)

    def read(self, n: int = -1) -> bytes:
        return self._buf.read(n)

    def close(self) -> None:
        self._buf.close()


def _synthetic_xml(body: str, status: int = 200):
    data = body.encode()
    headers = {
        "Content-Type": "application/xml",
        "Content-Length": str(len(data)),
    }
    return status, headers, _SyntheticResponse(data)


def _localname(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


class AzureUpstream:
    """Forward object operations to Azure Blob, Shared-Key-signed
    (``/<container>/<blob>``); same duck-typed interface as S3Upstream,
    including the S3-dialect query operations (see module docstring)."""

    # multipart bookkeeping idle TTL: an upload untouched this long is
    # presumed abandoned and its map entry dropped (matches S3 lifecycle
    # abort-incomplete-multipart semantics; subsequent parts 404)
    MPU_IDLE_TTL_S = 24 * 3600.0

    def __init__(self, config: AzureUpstreamConfig, *, resolver=None, health_check=None):
        self.config = config
        endpoint = config.endpoint or f"https://{config.account}.blob.core.windows.net"
        scheme, _, rest = endpoint.partition("://")
        if rest == "":
            scheme, rest = "https", scheme
        host, _, port_s = rest.partition(":")
        self.scheme = scheme
        self.host_header = rest
        self.host = host
        self.port = config.port or (
            int(port_s) if port_s else (443 if scheme == "https" else 80)
        )
        self.discovery = DnsDiscovery(
            host,
            self.port,
            resolver=resolver,
            health_check=health_check,
            refresh_interval_s=config.refresh_interval_s,
            retry_down_s=config.retry_down_s,
            connect_timeout_s=config.connect_timeout_s,
        )
        # uploadId → {"key": blob key, "blocks": {part number → block id}}.
        # Azure has no InitiateMultipartUpload: the id is minted HERE and
        # the bookkeeping maps S3 part numbers onto Put Block ids until the
        # Complete turns them into one Put Block List.  Process-scoped,
        # like the proxy's own staging map: a restart 404s old uploads
        # (their uncommitted blocks expire server-side).  Abandoned uploads
        # (initiated, never completed/aborted by a crashed client) are
        # swept after MPU_IDLE_TTL_S so the map cannot grow forever —
        # Azure garbage-collects their uncommitted blocks on its side.
        self._mpu_lock = threading.Lock()
        self._mpu: dict[str, dict] = {}

    def _connect(self, ip: str) -> http.client.HTTPConnection:
        return connect_backend(
            self.scheme, ip, self.port, self.host, self.config.connect_timeout_s
        )

    def request(
        self,
        method: str,
        key: str,
        *,
        body: bytes | None = None,
        body_iter=None,
        content_length: int | None = None,
        range_header: str | None = None,
        query: str = "",
        retries: int = 1,
    ):
        """One S3-dialect request → (status, headers dict, response object);
        contract identical to S3Upstream.request (streaming responses,
        non-replayable streamed uploads don't retry).

        ``query`` carries S3-dialect parameters (list-type / uploads /
        partNumber…), which are TRANSLATED into Blob-service calls — the
        azure.rs role.  Plain object verbs forward as signed blob ops."""
        if query:
            return self._translate_query(
                method, key, query,
                body=body, body_iter=body_iter, content_length=content_length,
                retries=retries,
            )
        extra = {"Range": range_header} if range_header else None
        # whole-object PUT needs the blob type; sub-resource PUTs (block /
        # blocklist) must NOT carry it
        blob_type = method == "PUT"
        status, headers, resp = self._raw_request(
            method, f"/{self.config.container}/{key.lstrip('/')}", {},
            body=body, body_iter=body_iter, content_length=content_length,
            extra_headers=extra, retries=retries, blob_type=blob_type,
            log_key=key,
        )
        if method == "DELETE" and status == 202:
            # Delete Blob answers 202 Accepted; the S3 dialect promises 204
            status = 204
        elif method == "DELETE" and status == 404:
            # S3 DeleteObject is idempotent: deleting an absent key is 204
            # (the direct proxy maps FileNotFoundError the same way), so a
            # retried cleanup sweep must not fail only on the Azure backend
            try:
                resp.read()
            finally:
                resp.close()
            return 204, {"Content-Length": "0"}, _SyntheticResponse(b"")
        return status, headers, resp

    # ------------------------------------------------------ signed transport
    def _raw_request(
        self,
        method: str,
        raw_path: str,
        query: dict[str, str],
        *,
        body: bytes | None = None,
        body_iter=None,
        content_length: int | None = None,
        extra_headers: dict[str, str] | None = None,
        retries: int = 1,
        blob_type: bool = False,
        log_key: str = "",
    ):
        """One Shared-Key-signed request to the Blob service with the same
        failover shape as S3Upstream.request: next healthy backend per
        attempt, per-backend circuits via the discovery.  ``query`` values
        are DECODED; they sign decoded (Azure's canonicalization rule) and
        travel percent-encoded."""
        cfg = self.config
        path = encode_blob_path(raw_path)
        if body_iter is not None and content_length is None:
            raise ValueError("body_iter requires content_length")
        length = (
            content_length if body_iter is not None
            else (len(body) if body is not None else 0)
        )
        headers: dict[str, str] = {
            "Host": self.host_header,
            "x-ms-date": rfc1123_now(),
            "x-ms-version": API_VERSION,
            "Content-Length": str(length),
        }
        if blob_type:
            headers["x-ms-blob-type"] = "BlockBlob"
        if extra_headers:
            headers.update(extra_headers)
        headers["Authorization"] = sign_shared_key(
            method, cfg.account, cfg.key_b64, path, query, headers
        )
        if body_iter is not None:
            retries = 0  # a consumed stream cannot be replayed
        wire_path = path
        if query:
            wire_path += "?" + "&".join(
                f"{quote(k, safe='')}={quote(v, safe='')}"
                for k, v in sorted(query.items())
            )

        def attempt():
            ip = self.discovery.pick()
            try:
                # connect INSIDE the reporting scope: a refused/timed-out
                # TCP connect must open that backend's circuit too
                conn = self._connect(ip)
            except OSError as e:
                self.discovery.report_failure(ip)
                logger.warning("azure upstream connect to %s failed: %s", ip, e)
                raise
            try:
                conn.request(
                    method,
                    wire_path,
                    body=body_iter if body_iter is not None else body,
                    headers=headers,
                )
                resp = conn.getresponse()
                resp._proxy_conn = conn  # keep alive while streaming
            except OSError as e:
                conn.close()
                self.discovery.report_failure(ip)
                logger.warning(
                    "azure upstream %s %s via %s failed: %s",
                    method, log_key or raw_path, ip, e,
                )
                raise
            self.discovery.report_success(ip)
            return resp

        policy = RetryPolicy(
            max_attempts=retries + 1, base_delay_s=0.0, jitter=0.0,
            classify=lambda e: isinstance(e, OSError),
        )
        try:
            resp = policy.run(attempt, op="proxy.upstream")
        except OSError as e:
            raise OSError(
                f"all azure backends failed for {method} {log_key or raw_path}: {e}"
            ) from e
        return resp.status, dict(resp.getheaders()), resp

    # ------------------------------------------------- S3-dialect translation
    def _count_translation(self, op: str) -> None:
        from lakesoul_tpu_torch.obs import registry

        registry().counter("lakesoul_azure_translated_total", op=op).inc()

    def _translate_query(
        self, method: str, key: str, query: str, *,
        body, body_iter, content_length, retries,
    ):
        q = {
            k: (v[0] if v else "")
            for k, v in parse_qs(query, keep_blank_values=True).items()
        }
        if "list-type" in q:
            if "start-after" in q:
                # no Blob-service equivalent; refusing beats silently
                # returning the full listing
                raise NotImplementedError(
                    "ListObjectsV2 start-after has no Azure List Blobs"
                    " equivalent"
                )
            return self._list_objects_v2(q, retries=retries)
        if "uploads" in q:
            if method != "POST":
                # GET ?uploads is S3 ListMultipartUploads — enumerating
                # uncommitted Blob blocks has no faithful mapping, and
                # minting an upload on a read would diverge from S3
                raise NotImplementedError(
                    "ListMultipartUploads has no Azure translation; see"
                    " PARITY.md"
                )
            return self._initiate_multipart(key)
        if "partNumber" in q and "uploadId" in q:
            if method != "PUT":
                # S3's GET/HEAD ?partNumber is a part READ; translating it
                # to Put Block would overwrite in-flight upload state from
                # a read-only request — refuse instead
                raise NotImplementedError(
                    "multipart part reads have no Azure translation; see"
                    " PARITY.md"
                )
            return self._upload_part(
                key, q, body=body, body_iter=body_iter,
                content_length=content_length,
            )
        if "uploadId" in q and method == "POST":
            return self._complete_multipart(key, q, body=body)
        if "uploadId" in q and method == "DELETE":
            return self._abort_multipart(q)
        raise NotImplementedError(
            f"S3-dialect query {query!r} has no Azure translation; see"
            " PARITY.md"
        )

    # --------------------------------------------------------------- listing
    def _list_objects_v2(self, q: dict[str, str], *, retries: int):
        """ListObjectsV2 → List Blobs, Azure enumeration XML → S3
        ListBucketResult, NextMarker ↔ NextContinuationToken."""
        az_q = {"restype": "container", "comp": "list"}
        if q.get("prefix"):
            az_q["prefix"] = q["prefix"]
        if q.get("continuation-token"):
            az_q["marker"] = q["continuation-token"]
        if q.get("max-keys"):
            az_q["maxresults"] = q["max-keys"]
        if q.get("delimiter"):
            az_q["delimiter"] = q["delimiter"]
        status, headers, resp = self._raw_request(
            "GET", f"/{self.config.container}", az_q, retries=retries,
            log_key="<list>",
        )
        data = resp.read()
        resp.close()
        if status != 200:
            # pass the upstream failure through untranslated — the proxy
            # maps it like any relay error
            return status, headers, _SyntheticResponse(data)
        root = ET.fromstring(data)
        entries: list[tuple[str, int]] = []
        prefixes: list[str] = []
        for el in root.iter():
            if _localname(el.tag) == "Blob":
                name = size = None
                for sub in el.iter():
                    ln = _localname(sub.tag)
                    if ln == "Name" and name is None:
                        name = sub.text or ""
                    elif ln == "Content-Length":
                        size = int(sub.text or 0)
                if name is not None:
                    entries.append((name, size or 0))
            elif _localname(el.tag) == "BlobPrefix":
                for sub in el.iter():
                    if _localname(sub.tag) == "Name" and sub.text:
                        prefixes.append(sub.text)
        next_marker = None
        for el in root.iter():
            if _localname(el.tag) == "NextMarker" and el.text:
                next_marker = el.text
        contents = "".join(
            f"<Contents><Key>{xml_escape(k)}</Key><Size>{s}</Size></Contents>"
            for k, s in entries
        )
        common = "".join(
            f"<CommonPrefixes><Prefix>{xml_escape(p)}</Prefix></CommonPrefixes>"
            for p in prefixes
        )
        token = (
            f"<NextContinuationToken>{xml_escape(next_marker)}"
            "</NextContinuationToken>"
            if next_marker else ""
        )
        self._count_translation("list")
        return _synthetic_xml(
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<ListBucketResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            f"<Name>{xml_escape(self.config.container)}</Name>"
            f"<Prefix>{xml_escape(q.get('prefix', ''))}</Prefix>"
            f"<KeyCount>{len(entries) + len(prefixes)}</KeyCount>"
            f"<IsTruncated>{'true' if next_marker else 'false'}</IsTruncated>"
            f"{token}{contents}{common}</ListBucketResult>"
        )

    # ------------------------------------------------------------- multipart
    @staticmethod
    def _block_id(upload_id: str, part: int) -> str:
        """Deterministic, fixed-width block id for (uploadId, part): Azure
        requires every block id of one blob to have the same length."""
        return base64.b64encode(f"{upload_id}-{part:05d}".encode()).decode()

    def _initiate_multipart(self, key: str):
        upload_id = uuid.uuid4().hex
        now = time.monotonic()
        with self._mpu_lock:
            # amortized sweep of abandoned uploads (crashed clients never
            # complete or abort) — keeps the map bounded by live traffic
            stale = [
                uid for uid, m in self._mpu.items()
                if now - m["touched"] > self.MPU_IDLE_TTL_S
            ]
            for uid in stale:
                del self._mpu[uid]
            self._mpu[upload_id] = {"key": key, "blocks": {}, "touched": now}
        self._count_translation("multipart")
        return _synthetic_xml(
            '<?xml version="1.0" encoding="UTF-8"?>'
            "<InitiateMultipartUploadResult>"
            f"<Bucket>{xml_escape(self.config.container)}</Bucket>"
            f"<Key>{xml_escape(key)}</Key>"
            f"<UploadId>{upload_id}</UploadId>"
            "</InitiateMultipartUploadResult>"
        )

    def _upload_part(self, key: str, q: dict[str, str], *,
                     body, body_iter, content_length):
        upload_id = q.get("uploadId", "")
        try:
            part = int(q.get("partNumber", ""))
        except ValueError:
            return _synthetic_xml("<Error><Code>InvalidArgument</Code>"
                                  "<Message>partNumber must be an integer"
                                  "</Message></Error>", 400)
        if not 1 <= part <= 10000:
            return _synthetic_xml("<Error><Code>InvalidArgument</Code>"
                                  "<Message>partNumber out of range"
                                  "</Message></Error>", 400)
        with self._mpu_lock:
            mpu = self._mpu.get(upload_id)
            known = mpu is not None and mpu["key"] == key
            if known:
                mpu["touched"] = time.monotonic()  # in-progress ≠ abandoned
        if not known:
            return _synthetic_xml(
                "<Error><Code>NoSuchUpload</Code></Error>", 404
            )
        block_id = self._block_id(upload_id, part)
        status, headers, resp = self._raw_request(
            "PUT", f"/{self.config.container}/{key.lstrip('/')}",
            {"comp": "block", "blockid": block_id},
            body=body, body_iter=body_iter, content_length=content_length,
            log_key=key,
        )
        err_body = resp.read()
        resp.close()
        if status not in (200, 201):
            # pass the consumed error body through: the relay forwards the
            # upstream Content-Length, so an empty synthetic body would
            # leave the client waiting for bytes that never come
            return status, headers, _SyntheticResponse(err_body)
        with self._mpu_lock:
            # re-check: an abort may have raced the block upload; the
            # uncommitted block is harmless (Azure expires it)
            mpu = self._mpu.get(upload_id)
            if mpu is None or mpu["key"] != key:
                return _synthetic_xml(
                    "<Error><Code>NoSuchUpload</Code></Error>", 404
                )
            mpu["blocks"][part] = block_id
        self._count_translation("multipart")
        return 200, {
            "ETag": f'"{upload_id}-{part}"', "Content-Length": "0",
        }, _SyntheticResponse(b"")

    def _complete_multipart(self, key: str, q: dict[str, str], *, body):
        upload_id = q.get("uploadId", "")
        with self._mpu_lock:
            mpu = self._mpu.get(upload_id)
            blocks = dict(mpu["blocks"]) if mpu and mpu["key"] == key else None
        if blocks is None:
            return _synthetic_xml(
                "<Error><Code>NoSuchUpload</Code></Error>", 404
            )
        wanted: list[int] | None = None
        if body and body.strip():
            try:
                manifest = ET.fromstring(body)
            except ET.ParseError:
                return _synthetic_xml(
                    "<Error><Code>MalformedXML</Code></Error>", 400
                )
            try:
                wanted = [
                    int(el.text)
                    for el in manifest.iter()
                    if _localname(el.tag) == "PartNumber"
                ]
            except (TypeError, ValueError):
                return _synthetic_xml(
                    "<Error><Code>MalformedXML</Code>"
                    "<Message>PartNumber must be an integer</Message>"
                    "</Error>", 400,
                )
        if wanted is not None and any(
            b <= a for a, b in zip(wanted, wanted[1:])
        ):
            # S3 rejects out-of-order / duplicate manifests; assembling
            # the blocklist in manifest order would commit scrambled bytes
            return _synthetic_xml(
                "<Error><Code>InvalidPartOrder</Code>"
                "<Message>parts must be in ascending order</Message>"
                "</Error>", 400,
            )
        parts = wanted if wanted is not None else sorted(blocks)
        missing = [n for n in parts if n not in blocks]
        if missing or not parts:
            return _synthetic_xml(
                "<Error><Code>InvalidPart</Code>"
                f"<Message>parts never uploaded: {missing}</Message></Error>",
                400,
            )
        block_list = (
            '<?xml version="1.0" encoding="utf-8"?><BlockList>'
            + "".join(f"<Latest>{blocks[n]}</Latest>" for n in parts)
            + "</BlockList>"
        )
        status, headers, resp = self._raw_request(
            "PUT", f"/{self.config.container}/{key.lstrip('/')}",
            {"comp": "blocklist"},
            body=block_list.encode(), log_key=key,
        )
        err_body = resp.read()
        resp.close()
        if status not in (200, 201):
            # see _upload_part: forward the consumed error body so the
            # relayed Content-Length stays truthful
            return status, headers, _SyntheticResponse(err_body)
        with self._mpu_lock:
            self._mpu.pop(upload_id, None)
        self._count_translation("multipart")
        return _synthetic_xml(
            '<?xml version="1.0" encoding="UTF-8"?>'
            "<CompleteMultipartUploadResult>"
            f"<Key>{xml_escape(key)}</Key>"
            f"<ETag>\"{upload_id}\"</ETag>"
            "</CompleteMultipartUploadResult>"
        )

    def _abort_multipart(self, q: dict[str, str]):
        with self._mpu_lock:
            known = self._mpu.pop(q.get("uploadId", ""), None)
        if known is None:
            # S3 dialect: aborting an unknown (or already-aborted) upload
            # is NoSuchUpload, same as the other multipart verbs
            return _synthetic_xml(
                "<Error><Code>NoSuchUpload</Code></Error>", 404
            )
        # uncommitted blocks are Azure's garbage: the service expires them
        self._count_translation("multipart")
        return 204, {"Content-Length": "0"}, _SyntheticResponse(b"")
