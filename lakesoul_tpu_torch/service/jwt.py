"""HS256 JWT minting and verification, stdlib-only (the port's copy of
``lakesoul_tpu/service/jwt.py``).

Parity with the reference's JwtServer (rust/lakesoul-metadata/src/jwt.rs:10-94):
claims {sub, group, exp}, HMAC-SHA256 signatures, used by the Flight gateway
handshake.  A token either package mints under one secret verifies in the
other: the header and payload JSON are serialized identically."""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from dataclasses import dataclass

from lakesoul_tpu_torch.errors import RBACError


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


@dataclass(frozen=True)
class Claims:
    """reference: Claims (jwt.rs:10) — subject user, group/domain, expiry."""

    sub: str
    group: str = "public"
    exp: int = 0


class JwtServer:
    def __init__(self, secret: str | bytes):
        self._secret = secret.encode() if isinstance(secret, str) else secret

    def create_token(self, claims: Claims, *, ttl_seconds: int = 3600) -> str:
        header = {"alg": "HS256", "typ": "JWT"}
        exp = claims.exp or int(time.time()) + ttl_seconds  # lakelint: ignore[wall-clock-lease] JWT exp is wire-format epoch seconds (RFC 7519); wall clock IS the spec here
        payload = {"sub": claims.sub, "group": claims.group, "exp": exp}
        signing_input = f"{_b64url(json.dumps(header).encode())}.{_b64url(json.dumps(payload).encode())}"
        sig = hmac.new(self._secret, signing_input.encode(), hashlib.sha256).digest()
        return f"{signing_input}.{_b64url(sig)}"

    def decode_token(self, token: str) -> Claims:
        try:
            head_b64, payload_b64, sig_b64 = token.split(".")
        except ValueError:
            raise RBACError("malformed token")
        signing_input = f"{head_b64}.{payload_b64}".encode()
        expect = hmac.new(self._secret, signing_input, hashlib.sha256).digest()
        if not hmac.compare_digest(expect, _unb64url(sig_b64)):
            raise RBACError("invalid token signature")
        payload = json.loads(_unb64url(payload_b64))
        if payload.get("exp", 0) < time.time():
            raise RBACError("token expired")
        return Claims(sub=payload["sub"], group=payload.get("group", "public"), exp=payload["exp"])


USERS_CONFIG_KEY = "lakesoul.users"
_PBKDF2_ITERATIONS = 600_000  # OWASP-grade work factor; stdlib-only


class UserRegistry:
    """User/password registry in the metadata ``global_config`` table — the
    credential store behind the reference's JWT token service (the gRPC
    handshake that exchanges user/password for a token).  Passwords are
    stored as salted PBKDF2-HMAC-SHA256 (slow by design — brute-forcing a
    leaked table costs ~0.2s per guess); groups drive RBAC domains."""

    def __init__(self, client):
        self.client = client

    def _load(self) -> dict:
        raw = self.client.store.get_global_config(USERS_CONFIG_KEY, "{}")
        return json.loads(raw or "{}")

    @staticmethod
    def _kdf(salt: str, password: str, iterations: int) -> str:
        return hashlib.pbkdf2_hmac(
            "sha256", password.encode(), salt.encode(), iterations
        ).hex()

    def register(self, user: str, password: str, *, group: str = "public") -> None:
        import secrets

        salt = secrets.token_hex(8)
        entry = {
            "salt": salt,
            "iterations": _PBKDF2_ITERATIONS,
            "password_pbkdf2": self._kdf(salt, password, _PBKDF2_ITERATIONS),
            "group": group,
        }

        def updater(old: str | None) -> str:
            # atomic read-modify-write: concurrent registrations must not
            # drop each other's users
            users = json.loads(old or "{}")
            users[user] = entry
            return json.dumps(users)

        self.client.store.update_global_config(USERS_CONFIG_KEY, updater)

    def verify(self, user: str, password: str) -> Claims:
        entry = self._load().get(user)
        if entry is None:
            raise RBACError(f"unknown user {user!r}")
        digest = self._kdf(
            entry["salt"], password, int(entry.get("iterations", _PBKDF2_ITERATIONS))
        )
        if not hmac.compare_digest(digest, entry["password_pbkdf2"]):
            raise RBACError("invalid credentials")
        return Claims(sub=user, group=entry.get("group", "public"))
