"""(Counterpart of ``cruise_control_tpu/monitor/sampling/__init__.py``, copied with the
port's imports.)"""
