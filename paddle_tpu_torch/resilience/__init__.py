"""Failure classification for the port's long-lived loops (the part of
paddle_tpu/resilience the serving engine needs)."""
from .retry import (TRANSIENT_HTTP_STATUSES, classify_failure,
                    classify_http_status, is_transient, tag_transient)

__all__ = ["TRANSIENT_HTTP_STATUSES", "classify_failure",
           "classify_http_status", "is_transient", "tag_transient"]
