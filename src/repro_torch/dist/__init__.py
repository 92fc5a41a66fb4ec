"""Data-movement helpers of the port (per-row int8 quantization)."""
