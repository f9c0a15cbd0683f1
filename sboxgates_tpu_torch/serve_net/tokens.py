"""Per-tenant bearer-token authentication for the network admission
service: a durable token file, fail-closed loading, and per-tenant
admission budgets (active-job quota + token-bucket rate limit).

The token file is JSON::

    {
      "version": 1,
      "tenants": {
        "alice": {"token": "s3cret", "max_jobs": 4,
                  "rate_per_s": 5.0, "burst": 10},
        "eve":   {"token": "...", "disabled": true}
      }
    }

It is written through ``durable_write_text`` (:func:`write_token_file`)
so a kill mid-rotation can never leave a torn file, and it is loaded
FAIL-CLOSED: any shape problem — unreadable, torn JSON, a tenant with
no token, a non-numeric budget — raises :class:`TokenFileError` with a
one-line message and the server refuses to start.  Corrupt credentials
must never degrade to open admission.

Authentication compares the presented bearer token against every
tenant's token with :func:`hmac.compare_digest` so a probe can't
timing-measure its way to a prefix match.  Budgets are enforced AT
admission (the 401/403/429 surface in ``serve_net.server``), before
the orchestrator — or any device — is touched.
"""

from __future__ import annotations

import hmac
import json
import os
import stat
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

#: Token file schema version (bump on key renames/removals).
TOKEN_FILE_VERSION = 1

#: Default per-tenant budgets when the token file omits them.
DEFAULT_MAX_JOBS = 8
DEFAULT_RATE_PER_S = 10.0
DEFAULT_BURST = 20


class TokenFileError(Exception):
    """The token file is missing, unreadable, or malformed — the
    fail-closed admission error (one line, no traceback at the CLI)."""


class AuthError(Exception):
    """An admission request failed authentication/authorization.

    ``status`` is the HTTP status the server maps it to: 401 for a
    missing/unknown token, 403 for a valid token on a disabled tenant.
    """

    def __init__(self, status: int, code: str, message: str):
        super().__init__(message)
        self.status = int(status)
        self.code = code


@dataclass(frozen=True)
class Tenant:
    """One tenant's credentials and admission budgets."""

    name: str
    token: str
    #: Max concurrently active (non-terminal) jobs this tenant may have.
    max_jobs: int = DEFAULT_MAX_JOBS
    #: Token-bucket refill rate (requests/second) and burst capacity.
    rate_per_s: float = DEFAULT_RATE_PER_S
    burst: float = DEFAULT_BURST
    #: A disabled tenant's token still authenticates (403, not 401) —
    #: the operator sees "known but shut off", not "unknown caller".
    disabled: bool = False


class _Bucket:
    """Classic token bucket; monotonic-clock refill, thread-safe via
    the owning :class:`TokenStore`'s lock."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.last: Optional[float] = None

    def allow(self, now: float) -> bool:
        if self.last is not None:
            self.tokens = min(
                self.burst, self.tokens + (now - self.last) * self.rate
            )
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


def _parse_tenant(name: str, row: object) -> Tenant:
    if not isinstance(row, dict):
        raise TokenFileError(
            f"tenant {name!r}: expected an object, got {type(row).__name__}"
        )
    token = row.get("token")
    if not isinstance(token, str) or not token:
        raise TokenFileError(f"tenant {name!r}: missing or empty token")
    try:
        max_jobs = int(row.get("max_jobs", DEFAULT_MAX_JOBS))
        rate = float(row.get("rate_per_s", DEFAULT_RATE_PER_S))
        burst = float(row.get("burst", DEFAULT_BURST))
    except (TypeError, ValueError) as e:
        raise TokenFileError(f"tenant {name!r}: bad budget value ({e})")
    if max_jobs < 1 or rate <= 0 or burst < 1:
        raise TokenFileError(
            f"tenant {name!r}: budgets must be positive "
            f"(max_jobs={max_jobs}, rate_per_s={rate}, burst={burst})"
        )
    return Tenant(
        name=name, token=token, max_jobs=max_jobs, rate_per_s=rate,
        burst=burst, disabled=bool(row.get("disabled", False)),
    )


class TokenStore:
    """The loaded token file: authentication + per-tenant budgets."""

    def __init__(self, tenants: Dict[str, Tenant]):
        self.tenants = dict(tenants)
        self._lock = threading.Lock()
        self._buckets: Dict[str, _Bucket] = {}

    # -- loading (fail-closed) --------------------------------------------

    @classmethod
    def load(cls, path: str) -> "TokenStore":
        """Parses the token file, raising :class:`TokenFileError` on
        ANY problem — corrupt credentials fail closed, never open."""
        err = check_file(path)
        if err is not None:
            raise TokenFileError(err)
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except OSError as e:
            raise TokenFileError(f"token file {path}: unreadable ({e})")
        except json.JSONDecodeError as e:
            raise TokenFileError(f"token file {path}: invalid JSON ({e})")
        if not isinstance(doc, dict):
            raise TokenFileError(f"token file {path}: expected an object")
        if doc.get("version") != TOKEN_FILE_VERSION:
            raise TokenFileError(
                f"token file {path}: unsupported version "
                f"{doc.get('version')!r} (expected {TOKEN_FILE_VERSION})"
            )
        rows = doc.get("tenants")
        if not isinstance(rows, dict) or not rows:
            raise TokenFileError(f"token file {path}: no tenants declared")
        try:
            tenants = {
                str(name): _parse_tenant(str(name), row)
                for name, row in rows.items()
            }
        except TokenFileError as e:
            raise TokenFileError(f"token file {path}: {e}")
        return cls(tenants)

    # -- authentication ----------------------------------------------------

    def authenticate(self, authorization: Optional[str]) -> Tenant:
        """Resolves an ``Authorization: Bearer <token>`` header to a
        tenant or raises :class:`AuthError` (401 unknown/missing, 403
        disabled).  Every tenant's token is compared on every call
        (constant-time compares, no early exit on the matching name)."""
        if not authorization or not authorization.startswith("Bearer "):
            raise AuthError(
                401, "unauthorized", "missing bearer token"
            )
        presented = authorization[len("Bearer "):].strip()
        matched: Optional[Tenant] = None
        for tenant in self.tenants.values():
            if hmac.compare_digest(tenant.token, presented):
                matched = tenant
        if matched is None:
            raise AuthError(401, "unauthorized", "unknown token")
        if matched.disabled:
            raise AuthError(
                403, "forbidden", f"tenant {matched.name!r} is disabled"
            )
        return matched

    def allow(self, tenant: str, now: Optional[float] = None) -> bool:
        """One token-bucket draw for this tenant; False = rate-limited
        (the 429 surface).  Unknown tenants are denied."""
        t = self.tenants.get(tenant)
        if t is None:
            return False
        if now is None:
            now = time.monotonic()
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = _Bucket(
                    t.rate_per_s, t.burst
                )
            return bucket.allow(now)


def check_file(path: str) -> Optional[str]:
    """Static token-file preconditions, as a one-line error string or
    None — the CLI's cheap pre-start rejection (no JSON parse): the
    file must exist, be readable, and must NOT be world-writable (a
    world-writable credential file is an open door, refuse to serve
    from it)."""
    try:
        st = os.stat(path)
    except OSError as e:
        return f"token file {path}: {e.strerror or e}"
    if not stat.S_ISREG(st.st_mode):
        return f"token file {path}: not a regular file"
    if st.st_mode & 0o002:
        return (
            f"token file {path}: world-writable "
            f"(mode {stat.S_IMODE(st.st_mode):04o}); refusing to serve"
        )
    if not os.access(path, os.R_OK):
        return f"token file {path}: not readable"
    return None


def write_token_file(path: str, tenants: Dict[str, dict]) -> None:
    """Writes a token file through the durable idiom (tmp + fsync +
    atomic replace) and clamps its mode to owner read/write — the only
    sanctioned writer (provisioning helpers and tests ride this)."""
    from ..resilience.checkpoint import durable_write_text

    doc = {"version": TOKEN_FILE_VERSION, "tenants": tenants}
    durable_write_text(path, json.dumps(doc, sort_keys=True, indent=1))
    os.chmod(path, 0o600)
