"""(Counterpart of ``cruise_control_tpu/monitor/aggregator/__init__.py``, copied with the
port's imports.)"""
