"""Request-level errors the engine surfaces to its callers (own copies of
the two ray_tpu.exceptions classes the engine raises)."""

from __future__ import annotations


class RequestCancelledError(Exception):
    """The request was cancelled (abort_request) before completing."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline expired before the engine could finish it."""
