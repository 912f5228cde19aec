"""Domain-based RBAC (the port's copy of ``lakesoul_tpu/service/rbac.py``).

Parity with rust/lakesoul-metadata/src/rbac.rs: a table (and namespace) has a
``domain``; a user belongs to a group/domain; access is allowed when the
table's domain is ``public`` or matches the user's group.  Verdicts are
cached for 600 s like the reference (`cached` crate)."""

from __future__ import annotations

import time

from lakesoul_tpu_torch.errors import RBACError, TableNotFoundError

CACHE_TTL_SECONDS = 600


class RbacVerifier:
    def __init__(self, client, *, cache_ttl: float = CACHE_TTL_SECONDS):
        self.client = client
        self.cache_ttl = cache_ttl
        self._cache: dict[tuple, tuple[float, bool]] = {}

    def _cached(self, key: tuple) -> bool | None:
        hit = self._cache.get(key)
        # monotonic: an NTP step back would otherwise pin stale verdicts
        # in the cache past their TTL (wall-clock-lease lint)
        if hit and time.monotonic() - hit[0] < self.cache_ttl:
            return hit[1]
        return None

    def _store(self, key: tuple, ok: bool) -> bool:
        self._cache[key] = (time.monotonic(), ok)
        return ok

    @staticmethod
    def _domain_allows(domain: str, user: str, group: str) -> bool:
        return domain == "public" or domain == group

    def verify_permission_by_table_name(
        self, user: str, group: str, namespace: str, table_name: str
    ) -> bool:
        """reference: verify_permission_by_table_name (rbac.rs:19)."""
        key = ("name", user, group, namespace, table_name)
        hit = self._cached(key)
        if hit is not None:
            return hit
        try:
            info = self.client.get_table_info_by_name(table_name, namespace)
        except TableNotFoundError:
            return self._store(key, False)
        return self._store(key, self._domain_allows(info.domain, user, group))

    def verify_permission_by_table_path(self, user: str, group: str, table_path: str) -> bool:
        """reference: verify_permission_by_table_path (rbac.rs:50)."""
        key = ("path", user, group, table_path)
        hit = self._cached(key)
        if hit is not None:
            return hit
        try:
            info = self.client.get_table_info_by_path(table_path)
        except TableNotFoundError:
            return self._store(key, False)
        return self._store(key, self._domain_allows(info.domain, user, group))

    def check(self, user: str, group: str, namespace: str, table_name: str) -> None:
        if not self.verify_permission_by_table_name(user, group, namespace, table_name):
            raise RBACError(
                f"user {user} (group {group}) has no access to {namespace}.{table_name}"
            )
