"""Telemetry of the port (paddle_tpu/telemetry counterparts): MFU and
the card's peaks, the step, bench, serving, memsnap, fleet, compile and
kernelbench records and their JSONL sink, the training flight recorder
(`recorder`: step records with the compile split, spans, the Chrome
export), the health monitor (`health`: numerics taps, the anomaly
detector, `HealthMonitor`) and the hang watchdog (`watchdog`), request
traces, the Prometheus text exposition and the training `MetricsServer`,
the memory observatory (`mem_obs`), the kernel observatory
(`kernel_obs`) and the ledger rules (`ledger_check`)."""
from .health import (Anomaly, AnomalyDetector, HealthConfig, HealthError,
                     HealthMonitor, as_monitor, device_health_stats)
from .ledger_check import validate_record
from .mem_obs import MemoryObservatory, is_oom, register_provider
from .metrics_http import MetricsServer, prometheus_text
from .mfu import (device_peak_flops, device_peak_hbm_bw,
                  gpt_train_flops_per_token, mfu)
from .recorder import (StepTimer, TelemetryRecorder, auto_step,
                       current_recorder, open_spans, span)
from .reqtrace import RequestTrace, RequestTracer, decompose, dominant_cause
from .sink import (JsonlSink, export_chrome_tracing, make_bench_record,
                   make_kernelbench_record, make_memsnap_record,
                   make_phase_record, make_reqtrace_record,
                   make_serving_record, make_step_record, read_jsonl)
from .watchdog import HangWatchdog, dump_black_box

__all__ = ["device_peak_flops", "device_peak_hbm_bw",
           "gpt_train_flops_per_token", "mfu", "prometheus_text",
           "MetricsServer", "RequestTrace", "RequestTracer", "decompose",
           "dominant_cause", "JsonlSink", "read_jsonl", "make_step_record",
           "make_bench_record", "make_phase_record",
           "make_kernelbench_record", "make_memsnap_record",
           "make_reqtrace_record", "make_serving_record",
           "export_chrome_tracing", "validate_record", "TelemetryRecorder",
           "StepTimer", "span", "auto_step", "current_recorder",
           "open_spans", "HealthConfig", "HealthMonitor", "HealthError",
           "Anomaly", "AnomalyDetector", "as_monitor",
           "device_health_stats", "HangWatchdog", "dump_black_box",
           "MemoryObservatory", "is_oom", "register_provider"]
