"""Telemetry of the port (paddle_tpu/telemetry counterparts): MFU."""
from .mfu import device_peak_flops, gpt_train_flops_per_token, mfu

__all__ = ["device_peak_flops", "gpt_train_flops_per_token", "mfu"]
