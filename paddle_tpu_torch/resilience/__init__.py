"""Failure classification for the port's long-lived loops (the part of
paddle_tpu/resilience the serving engine needs)."""
from .retry import (TRANSIENT_HTTP_STATUSES, HTTPStatusError,
                    classify_failure, classify_http_status, is_transient,
                    retry_after_hint, tag_transient)

__all__ = ["TRANSIENT_HTTP_STATUSES", "HTTPStatusError", "classify_failure",
           "classify_http_status", "is_transient", "retry_after_hint",
           "tag_transient"]
