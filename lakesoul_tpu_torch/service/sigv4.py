"""AWS Signature Version 4 request signing (stdlib-only; the port's copy of
``lakesoul_tpu/service/sigv4.py``).

Role of the reference proxy's outbound re-signing (rust/lakesoul-s3-proxy/
src/aws.rs): the proxy terminates client auth (JWT/Basic + RBAC) and signs
the forwarded request to the upstream S3 endpoint with the proxy's own
credentials.  Implemented from the published SigV4 specification and anchored
against AWS's documented example signatures in tests/test_torch_storage_proxy.py.

``sign_request`` is pure (timestamp injected), so signatures are
deterministic and verifiable — the test fake S3 server recomputes them.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse

ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _uri_encode(s: str, *, keep_slash: bool) -> str:
    # AWS unreserved set: A-Za-z0-9 - . _ ~ (slash kept only in paths)
    safe = "-._~/" if keep_slash else "-._~"
    return urllib.parse.quote(s, safe=safe)


def canonical_query(query: str) -> str:
    """Sorted, AWS-encoded query string from a raw query string."""
    if not query:
        return ""
    pairs = []
    for part in query.split("&"):
        if not part:
            continue
        k, _, v = part.partition("=")
        pairs.append((
            _uri_encode(urllib.parse.unquote(k), keep_slash=False),
            _uri_encode(urllib.parse.unquote(v), keep_slash=False),
        ))
    return "&".join(f"{k}={v}" for k, v in sorted(pairs))


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret_key: str, date: str, region: str, service: str) -> bytes:
    k = _hmac(f"AWS4{secret_key}".encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def canonical_request(
    method: str, path: str, query: str, headers: dict[str, str],
    signed_headers: list[str], payload_hash: str,
) -> str:
    """``path`` must be the path EXACTLY as it appears on the wire (already
    URI-encoded by the caller).  S3 canonicalizes the request path verbatim —
    re-encoding here would diverge from what the server signs whenever a key
    needs escaping."""
    canon_headers = "".join(
        f"{h}:{' '.join(headers[h].split())}\n" for h in signed_headers
    )
    return "\n".join([
        method.upper(),
        path or "/",
        canonical_query(query),
        canon_headers,
        ";".join(signed_headers),
        payload_hash,
    ])


def encode_path(path: str) -> str:
    """URI-encode an object path for the wire (AWS unreserved set, slashes
    kept).  Sign and send the SAME encoded form."""
    return _uri_encode(path, keep_slash=True)


def sign_request(
    method: str,
    host: str,
    path: str,
    query: str = "",
    headers: dict[str, str] | None = None,
    payload_hash: str = EMPTY_SHA256,
    *,
    access_key: str,
    secret_key: str,
    region: str = "us-east-1",
    service: str = "s3",
    session_token: str | None = None,
    timestamp: datetime.datetime | None = None,
) -> dict[str, str]:
    """Return the full header set (incl. ``Authorization``) for the request.

    ``path`` must be the request path exactly as sent on the wire (already
    URI-encoded — see :func:`encode_path`); ``payload_hash`` is hex sha256 of
    the body, or UNSIGNED_PAYLOAD for streamed bodies.  ``timestamp`` is
    injectable for deterministic tests."""
    now = timestamp or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    out = {k: v for k, v in (headers or {}).items()}
    out["host"] = host
    out["x-amz-date"] = amz_date
    if service == "s3":
        out["x-amz-content-sha256"] = payload_hash
    if session_token:
        out["x-amz-security-token"] = session_token
    signed = sorted(h.lower() for h in out)
    lower = {h.lower(): v for h, v in out.items()}
    creq = canonical_request(method, path, query, lower, signed, payload_hash)
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = "\n".join([
        ALGORITHM, amz_date, scope, hashlib.sha256(creq.encode()).hexdigest()
    ])
    sig = hmac.new(
        signing_key(secret_key, date, region, service), sts.encode(), hashlib.sha256
    ).hexdigest()
    out["Authorization"] = (
        f"{ALGORITHM} Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}"
    )
    return out


def verify_signature(
    method: str, path: str, query: str, headers: dict[str, str],
    *, secret_keys: dict[str, str],
) -> bool:
    """Re-derive and check a request's SigV4 signature (test fake-S3 role;
    also usable to validate inbound pre-signed traffic).  ``secret_keys``
    maps access-key id → secret."""
    auth = headers.get("Authorization") or headers.get("authorization") or ""
    if not auth.startswith(ALGORITHM):
        return False
    try:
        fields = dict(
            part.strip().split("=", 1) for part in auth[len(ALGORITHM):].split(",")
        )
        access_key, date, region, service, _ = fields["Credential"].split("/")
        signed = fields["SignedHeaders"].split(";")
        claimed = fields["Signature"]
    except (KeyError, ValueError):
        return False
    secret = secret_keys.get(access_key)
    if secret is None:
        return False
    lower = {k.lower(): v for k, v in headers.items()}
    payload_hash = lower.get("x-amz-content-sha256", UNSIGNED_PAYLOAD)
    creq = canonical_request(method, path, query, lower, signed, payload_hash)
    amz_date = lower.get("x-amz-date", "")
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = "\n".join([
        ALGORITHM, amz_date, scope, hashlib.sha256(creq.encode()).hexdigest()
    ])
    expect = hmac.new(
        signing_key(secret, date, region, service), sts.encode(), hashlib.sha256
    ).hexdigest()
    return hmac.compare_digest(expect, claimed)
