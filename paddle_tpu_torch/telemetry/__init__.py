"""Telemetry of the port (paddle_tpu/telemetry counterparts): MFU, the
serving, memsnap and fleet records and their JSONL sink, request traces,
the Prometheus text exposition, the memory observatory (`mem_obs`) and
the ledger rules (`ledger_check`)."""
from .metrics_http import prometheus_text
from .mfu import device_peak_flops, gpt_train_flops_per_token, mfu
from .reqtrace import RequestTrace, RequestTracer
from .sink import JsonlSink, make_reqtrace_record, make_serving_record

__all__ = ["device_peak_flops", "gpt_train_flops_per_token", "mfu",
           "prometheus_text", "RequestTrace", "RequestTracer", "JsonlSink",
           "make_reqtrace_record", "make_serving_record"]
