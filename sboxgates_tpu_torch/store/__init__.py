"""Content-addressed global result store (see ``store.store``)."""

from .store import ResultStore, StoreHit  # noqa: F401
from .rewrite import RewriteError, rewrite_state  # noqa: F401
