"""Network admission service: the authenticated, quota-enforced,
drain-safe HTTP front door for serve mode.

Three pieces, one admission contract:

* :mod:`.tokens` — the durable per-tenant token file (fail-closed
  loading, constant-time bearer auth, quotas + token-bucket rates).
* :mod:`.admission` — the fsync'd append-only admission journal:
  every accepted job is durable BEFORE its 202, and restart replays
  admitted-but-unfinished jobs into the orchestrator.
* :mod:`.server` — the HTTP surface itself (``POST /v1/jobs``,
  ``GET /v1/jobs/<id>?wait=N``) with idempotent submission keyed on
  the canonical query key + client ``Idempotency-Key``.

``tokens`` is import-light (stdlib only) so the CLI's pre-start
validations never pay the engine import; ``server``/``admission`` pull
the orchestrator stack and load lazily via module ``__getattr__``.
"""

from __future__ import annotations

from .tokens import (  # noqa: F401  (the light, re-exported surface)
    AuthError,
    Tenant,
    TokenFileError,
    TokenStore,
    check_file,
    write_token_file,
)

_LAZY = {
    "AdmissionJournal": ("admission", "AdmissionJournal"),
    "ADMIT_JOURNAL_NAME": ("admission", "ADMIT_JOURNAL_NAME"),
    "pending_jobs": ("admission", "pending_jobs"),
    "AdmissionServer": ("server", "AdmissionServer"),
    "NET_SCHEMA": ("server", "NET_SCHEMA"),
}

__all__ = [
    "AuthError", "Tenant", "TokenFileError", "TokenStore",
    "check_file", "write_token_file",
] + sorted(_LAZY)


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name)
    import importlib

    mod = importlib.import_module(f".{mod_name}", __name__)
    return getattr(mod, attr)
